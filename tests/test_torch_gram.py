"""The Newton op's "mxu" Gram mode held against the JAX package's on the CPU.

In the port both Gram modes have one plain version, `newton_core_torch`,
which forms H as one product (`gram_torch`); the CUDA kernel's two modes
form it on the CUDA cores or on the tensor cores (csrc/newton.cu).  Here
the plain version runs under gram_mode="mxu" against the reference's
Pallas kernel in its mxu mode, `newton_solve_batched(..., interpret=True,
gram_mode="mxu")`, on tests/test_ops.py:156-188's terms: the pooled
layout, B = 3 (two near-keyframe states and the captured stiff-contact
state), 2 Newton iterations, 1e-3 scaled.  The uniform layout is not held
to the reference's mxu path: its own test
(tests/test_ops.py::test_gram_mxu_matches_vpu[uniform]) fails against its
vpu path.  The inputs come from the port's own fk / smooth / assemble
(held to the JAX package by tests/test_torch_physics.py) and go to both
sides as the same float32 arrays.  Also: the mode is selected as the
reference selects it (QTPU_GRAM), and the kernel build tracks every
source under csrc/.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.ops.newton import newton_solve_batched
from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.ops import build
from quadruped_tpu_torch.ops import newton as N
from quadruped_tpu_torch.physics.constraint import assemble
from quadruped_tpu_torch.physics.kinematics import fk
from quadruped_tpu_torch.physics.smooth import smooth_dynamics
from quadruped_tpu_torch.physics.solver import newton_args

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def pooled():
    """The Newton op's arguments for tests/test_ops.py's three states
    (near-keyframe, stiff fixture, near-keyframe; the fixture's params)."""
    env = Go1Env(Go1Config(ctrl_type="torque", contact_pools=(8, 28, 12)),
                 device="cpu")
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
    return newton_args(M, qs, torch.zeros_like(qs), efc)


def test_mxu_plain_matches_pallas_interpret(pooled):
    """qacc, f and qfrc of every env within 1e-3 scaled by 1 + max |ref|
    (tests/test_ops.py's vpu-vs-mxu terms); no kernel launch counted."""
    args, kw = pooled
    K = args[9].shape[1]
    before = dict(N.newton_solve.launches)
    t = N.newton_solve(*args, iterations=2, gram_mode="mxu", **kw)
    assert N.newton_solve.launches == before
    j = newton_solve_batched(
        *[jnp.asarray(a.numpy()) for a in args], nv=args[1].shape[-1],
        nf=kw["nf"], nl=kw["nl"], K=K, iterations=2, interpret=True,
        pool_dims=kw["pool_dims"], gram_mode="mxu",
    )
    for x, y, what in zip(t, j, ("qacc", "f", "qfrc")):
        y = np.asarray(y)
        assert np.isfinite(y).all(), what
        for i in range(y.shape[0]):
            s = 1.0 + np.abs(y[i]).max()
            np.testing.assert_allclose(x[i].numpy() / s, y[i] / s, rtol=0,
                                       atol=1e-3, err_msg=f"{what} env {i}")


def test_gram_plain_matches_float64(pooled):
    """gram_torch in float32 (what `gram` runs for CPU tensors, in either
    mode: the first iteration's H at the warm start) against the same sums
    in float64 numpy, on the first iteration's weights and rank-1 rows:
    1e-5 scaled by 1 + max |H| per env, the limit chip_smoke.py holds the
    kernel's Gram to."""
    args, kw = pooled
    J, M = args[3], args[0]
    z = (J @ args[2][..., None])[..., 0] - args[4]
    _f, w, U, wU = N.Penalty(J, *args[5:], **kw).fw(z, True)
    assert U.shape[1] == 3 * (8 + 28) and bool((wU != 0).any())
    H = N.gram(*args, gram_mode="mxu", **kw)
    assert torch.equal(H, N.gram_torch(J, w, U, wU, M))
    d = lambda x: x.numpy().astype(np.float64)
    ref = (np.einsum("bri,br,brj->bij", d(J), d(w), d(J))
           + np.einsum("bui,bu,buj->bij", d(U), d(wU), d(U))
           + d(M) + 1e-10 * np.eye(18))
    err = np.abs(H.numpy() - ref).max((1, 2)) / (1.0 + np.abs(ref).max((1, 2)))
    assert err.max() <= 1e-5, err


def test_gram_mode_selected_as_the_reference_does(pooled, monkeypatch):
    """None reads QTPU_GRAM (default "vpu"); an unknown mode raises
    ValueError, from the variable or the argument."""
    args, kw = pooled
    monkeypatch.delenv("QTPU_GRAM", raising=False)
    assert N.resolve_gram_mode(None) == "vpu"
    monkeypatch.setenv("QTPU_GRAM", "mxu")
    assert N.resolve_gram_mode(None) == "mxu"
    assert N.resolve_gram_mode("vpu") == "vpu"
    monkeypatch.setenv("QTPU_GRAM", "tf32")
    with pytest.raises(ValueError):
        N.newton_solve(*args, iterations=1, **kw)
    monkeypatch.delenv("QTPU_GRAM")
    with pytest.raises(ValueError):
        N.newton_solve(*args, iterations=1, gram_mode="MXU", **kw)
    with pytest.raises(ValueError):
        N.gram(*args, gram_mode="bf16", **kw)


def test_build_hash_covers_every_source(tmp_path, monkeypatch):
    """Editing a header that a .cu includes, or adding a source, names a
    new library, so a stale build is never loaded."""
    (tmp_path / "newton.cu").write_text('#include "gram.cuh"\n')
    (tmp_path / "gram.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("newton")
    (tmp_path / "gram.cuh").write_text("// v2\n")
    second = build.library_path("newton")
    (tmp_path / "extra.cuh").write_text("")
    third = build.library_path("newton")
    assert len({first, second, third}) == 3
    assert build.library_path("newton") == third
