"""The port's physics stages held against the JAX package on the CPU.

Four float32 states go through both sides at the configuration of record
(Go1 torque, full collision table, condim pools (8, 28, 12)) and with
uniform 6-row slots (48 of them): the home keyframe, a perturbed
keyframe, and the two captured stiff-contact states of tests/data.
Compared: every fk field, smooth dynamics, the narrowphase per candidate,
the assembled constraint rows, cfrc_ext and the batched penalties.  The slot selection (con_sel) must be exactly
equal: it decides which contacts the solver sees.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.assets import robot_model as jax_robot_model
from quadruped_tpu.physics import collision as JCol
from quadruped_tpu.physics import constraint as JCon
from quadruped_tpu.physics import solver as JSol
from quadruped_tpu.physics.forward import Pipeline as JPipeline
from quadruped_tpu.physics.forward import cfrc_ext as jax_cfrc_ext
from quadruped_tpu.physics.kinematics import fk as jax_fk
from quadruped_tpu.physics.smooth import smooth_dynamics as jax_smooth
from quadruped_tpu_torch.assets import robot_model
from quadruped_tpu_torch.physics import collision as TCol
from quadruped_tpu_torch.physics import constraint as TCon
from quadruped_tpu_torch.physics import solver as TSol
from quadruped_tpu_torch.physics.forward import Pipeline, cfrc_ext
from quadruped_tpu_torch.physics.kinematics import fk
from quadruped_tpu_torch.physics.smooth import smooth_dynamics

DATA = Path(__file__).parent / "data"
POOLS = {6: 8, 3: 28, 1: 12}
KIN_FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos",
              "geom_xmat", "site_xpos", "ref", "cdof", "cvel")


def _states(m):
    """(qpos, qvel, ctrl, params) float32 batches of 4 states."""
    rng = np.random.default_rng(0)
    home = m.key_qpos[0].astype(np.float32)
    fx = [np.load(DATA / n) for n in ("stiff_contact_state.npz",
                                      "stiff_contact_state_b.npz")]
    qpos = np.stack([home, home + rng.normal(0, 0.02, 19), fx[0]["qpos"],
                     fx[1]["qpos"]]).astype(np.float32)
    qvel = np.stack([np.zeros(18), rng.normal(0, 0.3, 18), fx[0]["qvel"],
                     fx[1]["qvel"]]).astype(np.float32)
    ctrl = np.stack([np.zeros(12), rng.uniform(-1, 1, 12), fx[0]["action"],
                     fx[1]["action"]]).astype(np.float32)
    nominal = {k: np.asarray(v, np.float32) for k, v in m.params().items()}
    params = {
        k: np.stack([nominal[k], nominal[k], fx[0]["param_" + k],
                     fx[1]["param_" + k]]).astype(np.float32)
        for k in nominal
    }
    con_force = rng.normal(0, 50, (4, 48, 6)).astype(np.float32)
    return qpos, qvel, ctrl, params, con_force


@pytest.fixture(scope="module", params=["pooled", "uniform"])
def both(request):
    """Every compared output of both sides (numpy), computed once per
    slot layout."""
    pools = POOLS if request.param == "pooled" else None
    jm = jax_robot_model("go1", "torque")
    jpl = JPipeline.build(jm, "full", max_contacts=48, contact_pools=pools)
    qpos, qvel, ctrl, params, con_force = _states(jm)

    def ref(qp, qv, c, prm, cf):
        kin = jax_fk(jm, qp, qv)
        M, L, qfrc_smooth, qacc_smooth, qfrc_act = jax_smooth(
            jm, prm, kin, qp, qv, c)
        nphase = JCol.narrowphase(jm, jpl.table, kin,
                                  defer_cyl=jpl.layout.defer_cyl,
                                  frames="normal")
        efc = JCon.assemble(jm, jpl.layout, jpl.table, kin, qp, qv)
        cfrc = jax_cfrc_ext(jpl, prm, kin, efc, cf)
        z = efc.J @ qacc_smooth - efc.aref
        pen = JSol._penalty(efc, z, want_hess=True)
        S = JSol._penalty_S(efc, z)
        return (kin, (M, L, qfrc_smooth, qacc_smooth, qfrc_act), nphase,
                efc, cfrc, pen, S)

    J = jax.jit(jax.vmap(ref))(
        *map(jnp.asarray, (qpos, qvel, ctrl)),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(con_force),
    )
    J = jax.tree.map(np.asarray, J)

    tm = robot_model("go1", "torque")
    tpl = Pipeline.build(tm, "full", max_contacts=48, contact_pools=pools)
    tq, tv, tc = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    kin = fk(tm, tq, tv)
    sm = smooth_dynamics(tm, tp, kin, tq, tv, tc)
    nphase = TCol.narrowphase(tm, tpl.table, kin, defer_cyl=tpl.layout.defer_cyl)
    efc = TCon.assemble(tm, tpl.layout, tpl.table, kin, tq, tv)
    cfrc = cfrc_ext(tpl, tp, kin, efc, torch.as_tensor(con_force))
    z = (efc.J @ sm[3][..., None])[..., 0] - efc.aref
    pen = TSol._penalty(efc, z, want_hess=True)
    S = TSol._penalty_S(efc, z)
    return J, (kin, sm, nphase, efc, cfrc, pen, S)


def _close(t, j, tol, name):
    """|t - j| <= tol * (1 + max|j|), per state."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    for i in range(j.shape[0]):
        scale = 1.0 + np.abs(j[i]).max()
        np.testing.assert_allclose(t[i] / scale, j[i] / scale, atol=tol,
                                   rtol=0, err_msg=f"{name} state {i}")


# float32 tolerances: the same formulas in the same order on both sides,
# up to BLAS vs XLA summation order in the small matmuls; measured
# agreement is ~1e-7 of each output's scale (5e-7 for the Cholesky solve
# of qacc_smooth), so 1e-5 leaves margin without hiding an error


@pytest.mark.parametrize("field", KIN_FIELDS)
def test_fk_matches(both, field):
    J, T = both
    _close(getattr(T[0], field), getattr(J[0], field), 1e-5, field)


@pytest.mark.parametrize(
    "i,name", [(0, "M"), (1, "L"), (2, "qfrc_smooth"), (3, "qacc_smooth"),
               (4, "qfrc_actuator")],
)
def test_smooth_matches(both, i, name):
    J, T = both
    _close(T[1][i], J[1][i], 1e-5, name)


def test_narrowphase_matches(both):
    """dist, pos and normal of all 811 candidates, and which are active."""
    J, T = both
    jd, jp, jn = J[2]
    td, tp, tn = T[2]
    _close(td, jd, 1e-5, "dist")
    _close(tp, jp, 1e-5, "pos")
    _close(tn, jn, 1e-5, "normal")
    incm = TCol.build_table(robot_model("go1", "torque"), "full").cand_meta(
        "includemargin").astype(np.float32)
    np.testing.assert_array_equal(td.numpy() < incm, jd < incm)


def test_slot_selection_exact(both):
    J, T = both
    efc_j, efc_t = J[3], T[3]
    np.testing.assert_array_equal(efc_t.con_sel.numpy(), efc_j.con_sel)
    np.testing.assert_array_equal(efc_t.con_active.numpy(), efc_j.con_active)
    np.testing.assert_array_equal(efc_t.active.numpy(), efc_j.active)
    np.testing.assert_array_equal(efc_t.con_overflow.numpy(), efc_j.con_overflow)
    np.testing.assert_array_equal(efc_t.con_dim_mask.numpy(), efc_j.con_dim_mask)
    assert efc_t.pool_dims == efc_j.pool_dims
    assert (efc_t.row_con, efc_t.row_dim) == (efc_j.row_con, efc_j.row_dim)


@pytest.mark.parametrize(
    "field", ["J", "aref", "R", "D", "floss", "con_dist", "con_pos",
              "con_frame", "con_mu_tilde", "con_scale", "con_fscale",
              "con_Rn"],
)
def test_assemble_matches(both, field):
    J, T = both
    j = getattr(J[3], field)
    t = getattr(T[3], field)
    if field == "con_dist":
        # empty slots hold the 1e9 sentinel on both sides
        np.testing.assert_array_equal(t.numpy() >= 1e8, j >= 1e8)
        t = torch.where(t >= 1e8, torch.zeros_like(t), t)
        j = np.where(j >= 1e8, 0.0, j)
    _close(t, j, 1e-5, field)


def test_cfrc_ext_matches(both):
    J, T = both
    _close(T[4], J[4], 1e-5, "cfrc_ext")


def test_penalties_match(both):
    """The batched per-row penalties of the reference's single-env path:
    forces, weights, total penalty and the rank-1 cone directions."""
    J, T = both
    (jf, jS, jw, (jV3, jwV)), jS2 = J[5], J[6]
    (tf, tS, tw, (tV3, twV)), tS2 = T[5], T[6]
    for name, t, j in (("f", tf, jf), ("S", tS, jS), ("w", tw, jw),
                       ("V3", tV3, jV3), ("wV", twV, jwV), ("S_lean", tS2, jS2)):
        _close(t.reshape(t.shape[0], -1), j.reshape(j.shape[0], -1), 1e-4, name)
