"""collision_mode="plane" in the port, held against the JAX package on the
CPU.

The floor-only table has no top-K selection: every one of its candidates
is a solver slot (Go1: 116, Go2: 100), and each slot emits the compact
rows of its static condim.  The reference solves that layout with its
single-env path (`physics/solver._solve_single`, vmapped); the port sends
it to its Newton op, reading the slots' condim runs as the op's pools
(`physics.solver.pool_runs`).  Compared here, on three float32 states as
tests/test_ops.py builds them (two near-keyframe standing states and the
captured stiff-contact state):

  * the assembled constraint rows of the port against the reference's
    `assemble`, field by field;
  * the pools the port derives, for go1 and go2;
  * the port's solve (the plain version, as on the CPU) against the
    reference's un-vmapped `_solve_single`, env by env, from the same
    inputs, at tests/test_ops.py's tolerances;
  * one step_autoreset of the plane env against the JAX env (the shared
    checks of tests/torch_env_cases.py, with the reference's resets
    injected).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.assets import robot_model as jax_robot_model
from quadruped_tpu.env import config as jcfg
from quadruped_tpu.env.go1 import Go1Env as JaxGo1Env
from quadruped_tpu.physics import constraint as JCon
from quadruped_tpu.physics.forward import Pipeline as JPipeline
from quadruped_tpu.physics.kinematics import fk as jax_fk
from quadruped_tpu.physics.smooth import smooth_dynamics as jax_smooth
from quadruped_tpu.physics.solver import _solve_single
from quadruped_tpu_torch.assets import robot_model
from quadruped_tpu_torch.convert import state_from_jax
from quadruped_tpu_torch.env import config as tcfg
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.ops import newton as N
from quadruped_tpu_torch.physics import constraint as TCon
from quadruped_tpu_torch.physics import solver as TSol
from quadruped_tpu_torch.physics.forward import Pipeline
from quadruped_tpu_torch.physics.kinematics import fk
from quadruped_tpu_torch.physics.smooth import smooth_dynamics
from torch_env_cases import (  # noqa: F401  (shared tests)
    ITERS as STEP_ITERS,
    _f32,
    _inject,
    _np,
    test_autoreset_matches,
    test_state_matches,
    test_step_matches,
)

DATA = Path(__file__).parent / "data"
ITERS = 6       # tests/test_ops.py's iteration count
STIFF = 1       # index of the stiff-contact state in the batch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(m):
    """(qpos, qvel, ctrl, params) float32 batches of 3 states, as
    tests/test_ops.py builds them."""
    d = np.load(DATA / "stiff_contact_state.npz")
    params = {k[6:]: np.broadcast_to(d[k].astype(np.float32), (3,) + d[k].shape)
              for k in d.files if k.startswith("param_")}
    home = m.key_qpos[0].astype(np.float32)
    rng = np.random.default_rng(0)
    qps, qvs = [], []
    for i in range(3):
        if i != STIFF:
            qps.append(home + rng.normal(0, 0.005, home.shape).astype(np.float32))
            qvs.append(rng.normal(0, 0.1, m.nv).astype(np.float32))
        else:
            qps.append(d["qpos"].astype(np.float32))
            qvs.append(d["qvel"].astype(np.float32))
    ctrl = rng.uniform(-0.5, 0.5, (3, m.nu)).astype(np.float32)
    return np.stack(qps), np.stack(qvs), ctrl, params


@pytest.fixture(scope="module")
def both():
    """(the reference's (M, qacc_smooth, efc) numpy, the port's Efc, the
    port's model) on the Go1 torque plane table."""
    jm = jax_robot_model("go1", "torque")
    jpl = JPipeline.build(jm, "plane")
    qpos, qvel, ctrl, params = _states(jm)

    def prep(qp, qv, c, prm):
        kin = jax_fk(jm, qp, qv)
        M, _L, _qf, qs, _qa = jax_smooth(jm, prm, kin, qp, qv, c)
        return M, qs, JCon.assemble(jm, jpl.layout, jpl.table, kin, qp, qv)

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(prep))(
        *map(jnp.asarray, (qpos, qvel, ctrl)),
        {k: jnp.asarray(v) for k, v in params.items()}))

    tm = robot_model("go1", "torque")
    tpl = Pipeline.build(tm, "plane")
    tq, tv, tc = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    tp = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in params.items()}
    kin = fk(tm, tq, tv)
    smooth_dynamics(tm, tp, kin, tq, tv, tc)
    efc = TCon.assemble(tm, tpl.layout, tpl.table, kin, tq, tv)
    return ref, efc, tm


def _close(t, j, tol, name):
    """|t - j| <= tol * (1 + max|j|), per state."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    for i in range(j.shape[0]):
        scale = 1.0 + np.abs(j[i]).max()
        np.testing.assert_allclose(t[i] / scale, j[i] / scale, atol=tol,
                                   rtol=0, err_msg=f"{name} state {i}")


# float32, the same formulas in the same order on both sides up to BLAS vs
# XLA summation order (tests/test_torch_physics.py's bound)
@pytest.mark.parametrize(
    "field", ["J", "aref", "R", "D", "floss", "con_dist", "con_pos",
              "con_frame", "con_mu_tilde", "con_scale", "con_fscale",
              "con_Rn"],
)
def test_plane_assemble_matches(both, field):
    (_M, _qs, jefc), tefc, _tm = both
    _close(getattr(tefc, field), getattr(jefc, field), 1e-5, field)


def test_plane_layout_matches(both):
    """Every candidate is a slot, in table order; the same compact row
    map and active rows as the reference, no pools, no overflow; the
    stiff state has active contact slots."""
    (_M, _qs, jefc), tefc, _tm = both
    assert jefc.con_sel is None and jefc.pool_dims is None
    assert tefc.pool_dims is None
    assert (tefc.row_con, tefc.row_dim) == (jefc.row_con, jefc.row_dim)
    K = jefc.con_dist.shape[1]
    assert K == 116 and tefc.J.shape[1] == jefc.J.shape[1] == 12 + 12 + 360
    np.testing.assert_array_equal(tefc.con_sel.numpy(),
                                  np.broadcast_to(np.arange(K), (3, K)))
    np.testing.assert_array_equal(tefc.con_active.numpy(), jefc.con_active)
    np.testing.assert_array_equal(tefc.active.numpy(), jefc.active)
    np.testing.assert_array_equal(tefc.con_dim_mask.numpy(), jefc.con_dim_mask)
    assert not tefc.con_overflow.any()
    assert tefc.con_active[STIFF].sum() > 0


@pytest.mark.parametrize(
    "robot,ctrl,pools",
    [("go1", "torque", ((112, 3), (4, 6))),
     ("go1", "position", ((112, 3), (4, 6))),
     ("go2", "position", ((96, 3), (4, 6)))],
)
def test_plane_pool_runs(robot, ctrl, pools):
    """The solver reads the slots' condim runs as the Newton op's pools:
    the same rows, slot by slot, as the compact row map."""
    m = robot_model(robot, ctrl)
    pl = Pipeline.build(m, "plane")
    cd = np.asarray(pl.layout.con_condim)
    row_con = tuple(int(k) for k in range(len(cd)) for _ in range(cd[k]))
    assert TSol.pool_runs(row_con, len(cd)) == pools
    assert sum(k for k, _d in pools) == pl.table.ncand


def test_pool_runs_refuses_more_than_max_pools():
    """A layout whose condims form more than MAX_POOLS runs raises, and
    the message names the limit."""
    cds = [3, 1, 3, 1, 3]
    row_con = tuple(k for k, d in enumerate(cds) for _ in range(d))
    with pytest.raises(NotImplementedError, match="at most 4 pools"):
        TSol.pool_runs(row_con, len(cds))


def _port_efc(jefc, dtype):
    """The reference's assembled rows (numpy, batch-first) as the port's
    Efc in `dtype`: the same inputs on both sides."""
    B, K = jefc.con_dist.shape
    skip = ("con_sel", "con_body1", "con_body2", "con_overflow", "row_con",
            "row_dim", "pool_dims", "nf", "nl")

    def t(x):
        x = torch.as_tensor(np.array(x))
        return x.to(dtype) if x.is_floating_point() else x

    return TCon.Efc(
        **{f.name: t(getattr(jefc, f.name)) for f in dataclasses.fields(TCon.Efc)
           if f.name not in skip},
        con_sel=torch.arange(K).expand(B, K), con_body1=torch.zeros(B, K),
        con_body2=torch.zeros(B, K), con_overflow=torch.zeros(B),
        row_con=jefc.row_con, row_dim=jefc.row_dim, pool_dims=None,
        nf=jefc.nf, nl=jefc.nl)


def _solves(both, dtype, iterations):
    """(port, reference) (qacc, qfrc, con_force) per env in `dtype`: the
    port's solve (pool_runs, then the Newton op's plain version; the op
    takes float32, so in float64 its plain version is called on the
    op's arguments, as chip_smoke.py does) and the reference's un-vmapped
    single-env `_solve_single`, from the reference's inputs."""
    (M, qs, jefc), _tefc, tm = both
    jm = jax_robot_model("go1", "torque")
    M32, qs32 = torch.as_tensor(np.array(M)), torch.as_tensor(np.array(qs))
    efc32 = _port_efc(jefc, torch.float32)
    if dtype == torch.float32:
        tm.opt.iterations = iterations
        port = TSol.solve(tm, M32, qs32, efc32)
    else:
        args, kw = TSol.newton_args(M32, qs32, qs32, efc32)
        qacc, f, qfrc = N.newton_core_torch(*[a.double() for a in args],
                                            iterations=iterations, **kw)
        K = jefc.con_dist.shape[1]
        port = (qacc, qfrc, TSol._expand_rows(efc32, f[:, jefc.nf + jefc.nl:], K))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    cast = lambda x: jnp.asarray(x, jdt) if np.asarray(x).dtype == np.float32 else x
    ref = []
    for i in range(qs.shape[0]):
        efc_i = jax.tree.map(lambda x: cast(x[i]), jefc)
        ref.append([np.asarray(x) for x in _solve_single(
            jm, cast(M[i]), cast(qs[i]), efc_i, cast(qs[i]), iterations)])
    return [x.numpy() for x in port], ref


def _scaled_err(t, s):
    return np.abs(t - s).max() / (1.0 + np.abs(s).max())


def test_plane_solve_matches_single_path(both):
    """The port's solve of the plane layout against the reference's
    un-vmapped single-env `_solve_single`, env by env, from the same
    float32 inputs, at tests/test_ops.py's iteration count (6) on the two
    standing states: qacc within 5e-3 scaled by 1 + max|qacc|, qfrc and
    con_force within 2e-2 scaled the same way (tests/test_ops.py:102-141;
    measured ~1e-7).  The stiff state at 2 iterations, ahead of the line
    search's chaotic amplification, within 5e-3 (tests/test_torch_newton.py's
    rule for it; measured 6.0e-4), and finite at 6."""
    (t, _f, _c), ref = _solves(both, torch.float32, ITERS)
    for i in range(len(ref)):
        qacc_s, qfrc_s, conf_s = ref[i]
        assert qacc_s.dtype == np.float32
        assert np.isfinite(t[i]).all() and np.isfinite(_f[i]).all()
        if i == STIFF:
            continue
        assert _scaled_err(t[i], qacc_s) <= 5e-3, f"qacc env {i}"
        assert _scaled_err(_f[i], qfrc_s) <= 2e-2, f"qfrc env {i}"
        assert _scaled_err(_c[i], conf_s) <= 2e-2, f"con_force env {i}"
    (t2, f2, c2), ref2 = _solves(both, torch.float32, 2)
    for name, x, k in (("qacc", t2, 0), ("qfrc", f2, 1), ("con_force", c2, 2)):
        assert _scaled_err(x[STIFF], ref2[STIFF][k]) <= 5e-3, f"{name} stiff, 2 it"


def test_plane_solve_float64_matches_single_path(both):
    """The same comparison in float64 on every state, the stiff one
    included, at 6 iterations: the two solves are one algorithm, so they
    agree to float64 rounding (measured <= 3e-11; bound 1e-9).  (In
    float32 the stiff state's qacc at 6 iterations lies 9.4e-2 from the
    reference's: there the reference's own float32 solve moves by up to
    1.0e-1 when its inputs move by one rounding.)"""
    (t, f, c), ref = _solves(both, torch.float64, ITERS)
    for i in range(len(ref)):
        for name, x, k in (("qacc", t, 0), ("qfrc", f, 1), ("con_force", c, 2)):
            assert ref[i][k].dtype == np.float64
            assert _scaled_err(x[i], ref[i][k]) <= 1e-9, f"{name} env {i}"


# ---- one plane control step against the JAX env ----------------------------

@pytest.fixture(scope="module")
def stepped():
    """The shared cases' tuple for the plane env: Go1 torque, the
    floor-only table, 3 Newton iterations (as every config of
    torch_env_cases.py)."""
    name = "plane"
    jenv = JaxGo1Env(jcfg.Go1Config(ctrl_type="torque", collision_mode="plane",
                                    solver_iterations=STEP_ITERS))
    B = 2
    st = _f32(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(1), B)))
    rng = np.random.default_rng(0)
    st = _inject(name, st, jenv, rng)
    action = rng.uniform(-1, 1, (B, 12)).astype(np.float32)
    out = _np(jax.jit(jax.vmap(jenv.step_autoreset))(st, jnp.asarray(action)))
    fresh = out[0]
    tenv = Go1Env(tcfg.Go1Config(ctrl_type="torque", collision_mode="plane",
                                 solver_iterations=STEP_ITERS), device="cpu")
    assert tenv.pipeline.table.ncand == 116 and tenv.pipeline.layout.max_contacts is None
    tout = tenv.step_autoreset(
        state_from_jax(_np(st), device="cpu"), torch.as_tensor(action),
        fresh=state_from_jax(fresh, device="cpu"),
    )
    return name, out, tout, fresh, tenv
