"""Actor-critic policy, PyTorch counterpart of
quadruped_tpu/models/actor_critic.py.

The architecture of SB3's "MlpPolicy" defaults, as in the reference:
separate actor and critic MLPs with two tanh hidden layers of 64 units, a
state-independent log-std initialized to 0, orthogonal initialization
with gains sqrt(2) (hidden), 0.01 (action mean) and 1.0 (value head).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device

LOG2PI = math.log(2.0 * math.pi)


def _mlp(sizes, out_gain, generator):
    layers = []
    for i in range(len(sizes) - 1):
        lin = nn.Linear(sizes[i], sizes[i + 1])
        last = i == len(sizes) - 2
        nn.init.orthogonal_(
            lin.weight, out_gain if last else math.sqrt(2.0), generator=generator
        )
        nn.init.zeros_(lin.bias)
        layers.append(lin)
        if not last:
            layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """obs (B, obs_dim) -> (mean (B, act_dim), log_std (act_dim,),
    value (B,))."""

    def __init__(self, obs_dim: int = 48, act_dim: int = 12,
                 hidden=(64, 64), log_std_init: float = 0.0,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.actor = _mlp((obs_dim, *hidden, act_dim), 0.01, generator)
        self.critic = _mlp((obs_dim, *hidden, 1), 1.0, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(log_std_init)))
        self.to(resolve_device(device))

    def forward(self, obs: torch.Tensor):
        return self.actor(obs), self.log_std, self.critic(obs)[..., 0]

    @torch.no_grad()
    def sample(self, obs: torch.Tensor, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None):
        """(action, log_prob, value, mean).  Unbounded Gaussian, as SB3:
        clipping to the action space happens at the env boundary.  `noise`
        (standard normal, shaped like the mean) replaces the draw from
        `generator` when given."""
        mean, log_std, value = self(obs)
        if noise is None:
            noise = torch.randn(
                mean.shape, generator=generator, device=mean.device,
                dtype=mean.dtype,
            )
        action = mean + torch.exp(log_std) * noise
        return action, self.log_prob(mean, log_std, action), value, mean

    @staticmethod
    def log_prob(mean, log_std, action):
        z = (action - mean) * torch.exp(-log_std)
        return torch.sum(-0.5 * (z * z + LOG2PI) - log_std, dim=-1)

    @staticmethod
    def entropy(log_std):
        return torch.sum(log_std + 0.5 * (LOG2PI + 1.0), dim=-1)

