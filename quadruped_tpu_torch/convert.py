"""Carry weights, optimizer state and env state across from the JAX
package, as numpy.

Every function takes plain numpy arrays (a flax variable tree, an optax
state or an EnvState converted with np.asarray), so the port never
imports JAX.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .env.go1 import EnvState
from .models.actor_critic import ActorCritic


def _dense(p, name):
    return [p[name][f"Dense_{i}"] for i in range(len(p[name]))]


def flax_pairs(net: ActorCritic, variables):
    """(torch parameter, float32 array of a flax-shaped tree) for every
    parameter of `net`, the tree's arrays in torch layout: flax kernels
    are (in, out), torch weights (out, in).  `variables` is any tree of
    the policy's shape ({'params': {'actor': {'Dense_i': {kernel, bias}},
    'critic': ..., 'log_std'}}): its weights, or Adam's moments of them."""
    p = variables["params"]
    pairs = []
    for seq, name in ((net.actor, "actor"), (net.critic, "critic")):
        lins = [mod for mod in seq if isinstance(mod, torch.nn.Linear)]
        for lin, d in zip(lins, _dense(p, name)):
            pairs.append((lin.weight, np.array(d["kernel"], np.float32).T.copy()))
            pairs.append((lin.bias, np.array(d["bias"], np.float32)))
    pairs.append((net.log_std, np.array(p["log_std"], np.float32)))
    return pairs


def _n_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_n_leaves(v) for v in tree.values())
    return 0 if tree is None else 1


def load_flax(net: ActorCritic, variables) -> ActorCritic:
    """Copy the weights of a flax-shaped tree (see flax_pairs) into `net`,
    in place on its device: every parameter, each of its own shape, and
    no array left over.  Returns `net`."""
    pairs = flax_pairs(net, variables)
    n_params = len(list(net.parameters()))
    n_arrays = _n_leaves(variables["params"])
    if not len(pairs) == n_params == n_arrays:
        raise ValueError(f"weight tree holds {n_arrays} arrays for a policy "
                         f"of {n_params} parameters")
    with torch.no_grad():
        for param, value in pairs:
            if param.shape != value.shape:
                raise ValueError(f"weight of shape {value.shape} for a "
                                 f"parameter of shape {tuple(param.shape)}")
            param.copy_(torch.as_tensor(value))
    return net


def policy_from_jax(variables, device="cuda") -> ActorCritic:
    """ActorCritic holding the weights of a flax tree
    {'params': {'actor': {'Dense_i': {kernel, bias}}, 'critic': ...,
    'log_std'}}."""
    actor = _dense(variables["params"], "actor")
    obs_dim = np.asarray(actor[0]["kernel"]).shape[0]
    hidden = tuple(np.asarray(d["kernel"]).shape[1] for d in actor[:-1])
    act_dim = np.asarray(actor[-1]["kernel"]).shape[1]
    return load_flax(ActorCritic(obs_dim, act_dim, hidden, device=device),
                     variables)


def _adam_state(tree):
    """(count, mu, nu) of the optax ScaleByAdamState inside a chain's
    state, or of a dict with those three keys (the orbax reader's form of
    that state)."""
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= tree.keys():
        return tree["count"], tree["mu"], tree["nu"]
    if all(hasattr(tree, k) for k in ("count", "mu", "nu")):
        return tree.count, tree.mu, tree.nu
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, policy: ActorCritic) -> dict:
    """torch Adam state for `policy`'s parameters from the optax state of
    the reference's chain (clip_by_global_norm, then adam: the clip's
    empty state, then ScaleByAdamState(count, mu, nu)), or from that
    ScaleByAdamState as a dict {count, mu, nu}: step = count, exp_avg =
    mu, exp_avg_sq = nu, kernels transposed.  Load it with
    `optimizer.state.update(...)` into an optimizer from
    learn.ppo.make_optimizer; the step counter sits where that optimizer
    keeps it (on the card there, on the host for CPU parameters)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")
    count, mu, nu = adam
    dev = policy.log_std.device
    step_dev = dev if dev.type == "cuda" else torch.device("cpu")
    step = float(np.asarray(count))
    state = {}
    for (param, m), (_p, v) in zip(flax_pairs(policy, mu),
                                   flax_pairs(policy, nu)):
        state[param] = {
            "step": torch.tensor(step, dtype=torch.float32, device=step_dev),
            "exp_avg": torch.as_tensor(m, device=dev),
            "exp_avg_sq": torch.as_tensor(v, device=dev),
        }
    return state


def state_from_jax(state, device="cuda") -> EnvState:
    """EnvState of the port from a batched JAX EnvState (any object with
    the reference's fields as numpy-convertible arrays; its `rng` is
    dropped: the port draws from a torch.Generator).  Floats become
    float32, integers int32."""
    def conv(x):
        a = np.array(x)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=device)
        return torch.as_tensor(a.astype(np.float32), device=device)

    kw = {}
    for f in dataclasses.fields(EnvState):
        v = getattr(state, f.name)
        kw[f.name] = (
            {k: conv(x) for k, x in v.items()} if f.name == "params" else conv(v)
        )
    return EnvState(**kw)


def write_best_model(path, variables, metadata: dict | None = None) -> ActorCritic:
    """Write a port `best_model` directory (checkpoint.save_policy:
    policy.pt and metadata.json) holding the weights of a flax tree
    (numpy arrays; see policy_from_jax) -> the policy, on the CPU.  The
    port's loaders read the JAX package's orbax directories directly; this
    writes a copy of such weights in the port's own format."""
    from .checkpoint import save_policy

    net = policy_from_jax(variables, device="cpu")
    save_policy(path, net, metadata)
    return net
