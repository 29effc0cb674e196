"""The benchmark's plain reference of the Go1 training step.

A frozen copy of the port's plain PyTorch modules (mjcf, assets, physics,
env, models) with the Newton solve always on its plain version
(`ops/newton.py`), and PPO's update written out by hand (`ppo.py`).  It
imports nothing of the port or of JAX, so a later change to the port
cannot move it.  Every float32 matmul runs in full float32 unless the
caller switches TF32 on (the benchmark's control does, on purpose).
"""

import torch


def resolve_device(device) -> torch.device:
    return torch.device(device)
