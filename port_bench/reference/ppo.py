"""PPO's policy and update written out by hand: the benchmark's plain
reference of the actor-critic and of the first minibatch steps of an
update.

The policy is SB3's MlpPolicy as the port builds it (separate actor and
critic, two tanh layers of 64, a state-independent log-std); weights are
a dict of tensors named as the port's `ActorCritic.named_parameters()`.
The update follows the JAX package's PPO (quadruped_tpu/learn/ppo.py):
GAE by the reverse recursion, advantages normalized per minibatch by the
population std, the clipped surrogate plus half the squared value error,
optax's clip_by_global_norm, then Adam with eps outside the square root
and bias correction from step 1.  Adam is written out here; nothing is
taken from torch.optim.
"""

from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)
LAYERS = ("0", "2", "4")


def forward(w: dict, obs: torch.Tensor):
    """(mean, log_std, value) of the actor-critic with weights `w`."""
    def mlp(prefix):
        h = obs
        for i, k in enumerate(LAYERS):
            h = h @ w[f"{prefix}.{k}.weight"].T + w[f"{prefix}.{k}.bias"]
            if i < len(LAYERS) - 1:
                h = torch.tanh(h)
        return h

    return mlp("actor"), w["log_std"], mlp("critic")[..., 0]


def log_prob(mean, log_std, action):
    z = (action - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * (z * z + LOG2PI) - log_std, dim=-1)


def sample(w: dict, obs: torch.Tensor, noise: torch.Tensor):
    """(action, log_prob, value) of the Gaussian policy for given noise."""
    mean, log_std, value = forward(w, obs)
    action = mean + torch.exp(log_std) * noise
    return action, log_prob(mean, log_std, action), value


def gae(reward, value, done, bootstrap, last_value, gamma, lam):
    """(advantages, returns), each (T, B): on done steps the next value is
    the stored bootstrap (V of the terminal observation, 0 if terminated)
    and the recursion restarts."""
    T = reward.shape[0]
    adv = torch.empty_like(reward)
    carry = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(T - 1, -1, -1):
        d = done[t]
        nxt = torch.where(d, bootstrap[t], v_next)
        delta = reward[t] + gamma * nxt - value[t]
        carry = delta + gamma * lam * (~d).to(reward.dtype) * carry
        adv[t] = carry
        v_next = value[t]
    return adv, adv + value


def loss(w: dict, batch, cfg: dict):
    """The minibatch's PPO loss (a 0-dim tensor with autograd)."""
    obs, action, old_logp, adv, ret = batch
    mean, log_std, value = forward(w, obs)
    ratio = torch.exp(log_prob(mean, log_std, action) - old_logp)
    if cfg["normalize_advantage"]:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    clip = cfg["clip_range"]
    pg = torch.maximum(-adv * ratio,
                       -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)).mean()
    v_loss = 0.5 * torch.square(ret - value).mean()
    ent = torch.sum(log_std + 0.5 * (LOG2PI + 1.0), dim=-1)
    return pg + cfg["vf_coef"] * v_loss - cfg["ent_coef"] * ent


def first_steps(w0: dict, adam0: dict, traj: dict, last_obs, perm, cfg: dict,
                steps: int, half_batch: bool = False, dtype=torch.float64):
    """The first `steps` minibatch steps of an update from weights `w0`
    and Adam's state `adam0` (name -> (exp_avg, exp_avg_sq), and "step":
    the steps taken before) on a rollout `traj` (T, B fields obs, action,
    log_prob, value, reward, done, bootstrap_value) with the first
    epoch's permutation `perm`, in `dtype`.

    Returns (losses, the first gradient after the clip, the weights after
    the last step), the last two as dicts by name.  `half_batch` takes
    each minibatch's loss over its first half only: a planted fault."""
    gamma, lam = cfg["gamma"], cfg["gae_lambda"]
    cast = {k: v.detach().to(dtype) for k, v in w0.items()}
    tr = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in traj.items()}
    with torch.no_grad():
        _, _, last_value = forward(cast, last_obs.to(dtype))
        adv, ret = gae(tr["reward"], tr["value"], tr["done"],
                       tr["bootstrap_value"], last_value, gamma, lam)
    T, B = tr["reward"].shape
    n = T * B
    mb = n // cfg["num_minibatches"]
    flat = [x.reshape((n,) + x.shape[2:]) for x in
            (tr["obs"], tr["action"], tr["log_prob"], adv, ret)]
    w = {k: v.clone().requires_grad_(True) for k, v in cast.items()}
    m = {k: adam0[k][0].to(dtype).clone() for k in w}
    s = {k: adam0[k][1].to(dtype).clone() for k in w}
    t0 = int(adam0["step"])
    b1, b2, eps, lr = 0.9, 0.999, cfg["adam_eps"], cfg["learning_rate"]
    losses, first_grad = [], None
    for i in range(steps):
        idx = perm[i * mb:(i + 1) * mb]
        if half_batch:
            idx = idx[: mb // 2]
        out = loss(w, [x[idx] for x in flat], cfg)
        grads = torch.autograd.grad(out, list(w.values()))
        g = dict(zip(w, grads))
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        if norm >= cfg["max_grad_norm"]:
            g = {k: x / norm * cfg["max_grad_norm"] for k, x in g.items()}
        if first_grad is None:
            first_grad = {k: x.detach().clone() for k, x in g.items()}
        t = t0 + i + 1
        with torch.no_grad():
            for k in w:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                s[k] = b2 * s[k] + (1 - b2) * g[k] * g[k]
                mhat = m[k] / (1 - b1 ** t)
                shat = s[k] / (1 - b2 ** t)
                w[k] -= lr * mhat / (torch.sqrt(shat) + eps)
        losses.append(float(out.detach()))
    return losses, first_grad, {k: v.detach() for k, v in w.items()}
