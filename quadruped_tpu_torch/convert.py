"""Carry weights and env state across from the JAX package, as numpy.

Both functions take plain numpy arrays (a flax variable tree or an
EnvState converted with np.asarray), so the port never imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .env.go1 import EnvState
from .models.actor_critic import ActorCritic


def policy_from_jax(variables, device="cuda") -> ActorCritic:
    """ActorCritic holding the weights of a flax tree
    {'params': {'actor': {'Dense_i': {kernel, bias}}, 'critic': ...,
    'log_std'}}.  Flax kernels are (in, out); torch weights (out, in)."""
    p = variables["params"]
    actor = [p["actor"][f"Dense_{i}"] for i in range(len(p["actor"]))]
    critic = [p["critic"][f"Dense_{i}"] for i in range(len(p["critic"]))]
    obs_dim = np.asarray(actor[0]["kernel"]).shape[0]
    hidden = tuple(np.asarray(d["kernel"]).shape[1] for d in actor[:-1])
    act_dim = np.asarray(actor[-1]["kernel"]).shape[1]
    net = ActorCritic(obs_dim, act_dim, hidden, device=device)
    with torch.no_grad():
        for seq, dense in ((net.actor, actor), (net.critic, critic)):
            lins = [mod for mod in seq if isinstance(mod, torch.nn.Linear)]
            for lin, d in zip(lins, dense):
                lin.weight.copy_(torch.as_tensor(np.array(d["kernel"], np.float32).T.copy()))
                lin.bias.copy_(torch.as_tensor(np.array(d["bias"], np.float32)))
        net.log_std.copy_(torch.as_tensor(np.array(p["log_std"], np.float32)))
    return net


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
