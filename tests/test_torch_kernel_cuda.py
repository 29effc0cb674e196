"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no
JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_kernel_cuda.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py configures JAX for the reference tests.)
Inputs come from the port's own pipeline at near-keyframe standing
states, where the float32 Newton solve is stable (chip_smoke.py covers
fallen-start and stiff states with its float64-referenced check).
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.ops import newton as N
from quadruped_tpu_torch.physics.constraint import assemble
from quadruped_tpu_torch.physics.kinematics import fk
from quadruped_tpu_torch.physics.smooth import smooth_dynamics
from quadruped_tpu_torch.physics.solver import newton_args

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", params=["pooled", "uniform"])
def inputs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pools = (8, 28, 12) if request.param == "pooled" else None
    env = Go1Env(Go1Config(contact_pools=pools, solver_iterations=8),
                 device="cuda")
    B = 256
    rng = np.random.default_rng(0)
    qpos = torch.as_tensor(
        (env.key_qpos + rng.normal(0, 0.005, (B, 19))).astype(np.float32)).cuda()
    qvel = torch.as_tensor(rng.normal(0, 0.1, (B, 18)).astype(np.float32)).cuda()
    ctrl = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 12)).astype(np.float32)).cuda()
    params = env.reset(B).params
    kin = fk(env.m, qpos, qvel)
    M, _L, _qf, qs, _qa = smooth_dynamics(env.m, params, kin, qpos, qvel, ctrl)
    efc = assemble(env.m, env.pipeline.layout, env.pipeline.table, kin, qpos, qvel)
    return newton_args(M, qs, torch.zeros_like(qs), efc)


def test_newton_kernel_matches_plain(inputs):
    """2 iterations, every env within 1e-3 scaled as in tests/test_ops.py
    (stable float32 states: chip_smoke.py measured <= 3.2e-4 on such envs);
    the launch counter moves by one per launch."""
    args, static = inputs
    before = N.newton_solve.launches
    k = N.newton_solve(*args, iterations=2, **static)
    torch.cuda.synchronize()
    assert N.newton_solve.launches == before + 1
    p = N.newton_core_torch(*args, iterations=2, **static)
    for kk, pp, what in zip(k, p, ("qacc", "f", "qfrc")):
        err = (kk - pp).abs().amax(-1) / (1.0 + pp.abs().amax(-1))
        assert err.max().item() <= 1e-3, what


def test_newton_kernel_finite_at_8_iterations(inputs):
    args, static = inputs
    for x in N.newton_solve(*args, iterations=8, **static):
        assert torch.isfinite(x).all()
