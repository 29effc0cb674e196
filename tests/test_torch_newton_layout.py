"""The Newton kernel's host-side checks and the line search's skip, on the CPU.

The kernel (quadruped_tpu_torch/csrc/newton.cu) runs only on the card;
its launch plan (shared layout, envs per block) is computed by its C
host code and held by tests/test_torch_kernel_cuda.py.  Held here, on
both contact layouts (uniform 6-row slots and the condim pools (8, 28,
12)):
  - the width check: a layout whose nv the kernel is not instantiated for
    raises before anything is built or launched;
  - the argument for the kernel's line search skipping inactive contact
    slots: in the plain version's Penalty.S each such slot adds the same
    ~1e-30 Rn at every candidate, below float32 resolution.
Inputs come from the port's own fk / smooth / assemble at two
near-keyframe states and the captured stiff-contact state.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.ops import newton as N
from quadruped_tpu_torch.physics.constraint import assemble
from quadruped_tpu_torch.physics.kinematics import fk
from quadruped_tpu_torch.physics.smooth import smooth_dynamics
from quadruped_tpu_torch.physics.solver import _LS_ALPHAS, newton_args

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module", params=["pooled", "uniform"])
def inputs(request):
    """(layout, the Newton op's 15 arguments, its layout keywords, efc)
    for B = 3 states (near-keyframe, stiff fixture, near-keyframe)."""
    pools = (8, 28, 12) if request.param == "pooled" else None
    env = Go1Env(Go1Config(ctrl_type="torque", contact_pools=pools), device="cpu")
    d = np.load(DATA / "stiff_contact_state.npz")
    home = env.key_qpos.astype(np.float32)
    rng = np.random.default_rng(0)
    qps, qvs = [], []
    for i in range(3):
        if i % 2 == 0:
            qps.append(home + rng.normal(0, 0.005, home.shape).astype(np.float32))
            qvs.append(rng.normal(0, 0.1, 18).astype(np.float32))
        else:
            qps.append(d["qpos"].astype(np.float32))
            qvs.append(d["qvel"].astype(np.float32))
    ctrl = torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 12)).astype(np.float32))
    qpos, qvel = torch.as_tensor(np.stack(qps)), torch.as_tensor(np.stack(qvs))
    params = {k[6:]: torch.as_tensor(d[k]).expand(3, *d[k].shape)
              for k in d.files if k.startswith("param_")}
    kin = fk(env.m, qpos, qvel)
    M, _L, _qf, qs, _qa = smooth_dynamics(env.m, params, kin, qpos, qvel, ctrl)
    efc = assemble(env.m, env.pipeline.layout, env.pipeline.table, kin, qpos, qvel)
    args, kw = newton_args(M, qs, torch.zeros_like(qs), efc)
    return request.param, args, kw, efc


def test_kernel_refuses_other_widths(inputs, monkeypatch):
    """nv other than 18 raises ValueError before the kernel's library is
    built (only nv 18 is instantiated); the plain version takes any nv."""
    _layout, args, kw, _efc = inputs
    nf, nl, K = kw["nf"], kw["nl"], args[9].shape[1]

    def no_build():
        raise AssertionError("the kernel's library was requested")

    monkeypatch.setattr(N, "_lib", no_build)
    for nv in (6, 12, 17, 19, 20, 24, 36):
        for mode in N.GRAM_MODES:
            with pytest.raises(ValueError, match="instantiated"):
                N.kernel_resources(nv, nf, nl, K, kw["pool_dims"], mode)
    assert N.KERNEL_NV == (18,) and args[0].shape[-1] in N.KERNEL_NV


def _points(args):
    """z at the warm start and z + alpha Jd at the ladder and a few
    alphas in between, Jd from a step made with numpy."""
    J, aref = args[3], args[4]
    rng = np.random.default_rng(1)
    delta = torch.as_tensor(rng.normal(0, 2.0, args[1].shape).astype(np.float32))
    z = (J @ args[2][..., None])[..., 0] - aref
    Jd = (J @ delta[..., None])[..., 0]
    alphas = torch.tensor(list(_LS_ALPHAS) + [0.0, 0.3, 1.7, 3.3])
    return z, z[:, None] + alphas[None, :, None] * Jd[:, None]


def test_inactive_slots_add_a_constant_below_float32(inputs):
    """The kernel's line search skips the inactive contact slots
    (con_active 0).  In Penalty.S such a slot has u = 0, so it lies in
    the middle zone (t = 1e-15 > 0 = mu u0) and adds 1/2 Rn mu^2 1e-30 /
    (1 + mu^2) at every candidate.  With its mu set to 0 it lies in the
    top zone and adds exactly 0: that is the sum the kernel forms.  The
    constant is at most 1/2 1e-30 sum Rn over the skipped slots, below
    half a float32 ulp of S at every candidate; the float32 sums agree to
    one ulp and the float64 sums to float64 rounding."""
    _layout, args, kw, _efc = inputs
    _z, zs = _points(args)
    off = args[12] == 0
    assert bool(off.any()) and bool((~off).any())
    const = 0.5e-30 * (args[13].double() * off).sum(1)
    for dt, rtol in ((torch.float32, 2.0**-23), (torch.float64, 1e-15)):
        a = [x.to(dt) for x in args]
        skip = list(a)
        skip[14] = torch.where(off, 0.0, a[14])           # con_mu
        S = N.Penalty(a[3], *a[5:], **kw).S(zs.to(dt))
        S_skip = N.Penalty(a[3], *skip[5:], **kw).S(zs.to(dt))
        assert bool((S_skip > 0).all())
        assert bool((const[:, None] < 2.0**-25 * S_skip.double()).all())
        np.testing.assert_allclose(S.numpy(), S_skip.numpy(), rtol=rtol, atol=0)
