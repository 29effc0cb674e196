"""The port's assets, position servos and rough terrain, held against the
JAX package on the CPU.

The four bundled scenes (go1/go2 x torque/position) compile to the same
model arrays, collision tables and constraint layouts on both sides.  The
position-servo actuation runs random float32 batches with per-env gains
(domain randomization scales kp) through both, with the force clamp hit.
The terrain functions run on the reference's own draws; the narrowphase
and the assembled contact slots run at the stiff-contact fixture states
with a drawn field under them.  Zero amplitude gives the flat plane's
results bit for bit.  No env step is compiled here.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.assets import robot_model as jax_robot_model
from quadruped_tpu.physics import collision as JCol
from quadruped_tpu.physics import constraint as JCon
from quadruped_tpu.physics import smooth as JSmooth
from quadruped_tpu.physics import terrain as JTer
from quadruped_tpu.physics.kinematics import fk as jax_fk
from quadruped_tpu_torch.assets import robot_model
from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.physics import collision as TCol
from quadruped_tpu_torch.physics import constraint as TCon
from quadruped_tpu_torch.physics import smooth as TSmooth
from quadruped_tpu_torch.physics import terrain as TTer
from quadruped_tpu_torch.physics.forward import Pipeline, step_n
from quadruped_tpu_torch.physics.kinematics import fk

DATA = Path(__file__).parent / "data"
POOLS = {6: 8, 3: 28, 1: 12}
SCENES = [("go1", "torque"), ("go1", "position"), ("go2", "torque"),
          ("go2", "position")]
NCAND = {"go1": 811, "go2": 644}


def _eq(a, b, name):
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], str):
        assert list(a) == list(b), name
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("robot,ctrl", SCENES, ids=lambda x: x)
def test_scene_tables_equal(robot, ctrl):
    """Model arrays, the full collision table and both slot layouts
    (pools, row maps, packed constants), array by array."""
    jm, tm = jax_robot_model(robot, ctrl), robot_model(robot, ctrl)
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if f.name == "opt":
            for g in dataclasses.fields(a):
                _eq(getattr(a, g.name), getattr(b, g.name), f"opt.{g.name}")
        else:
            _eq(a, b, f.name)
    jt, tt = JCol.build_table(jm, "full"), TCol.build_table(tm, "full")
    assert jt.ncand == tt.ncand == NCAND[robot]
    for ga, gb in zip(jt.groups, tt.groups):
        assert ga.kind == gb.kind
        for f in dataclasses.fields(ga):
            _eq(getattr(ga, f.name), getattr(gb, f.name), f"{ga.kind}.{f.name}")
    for pools in (POOLS, None):
        jl = JCon.build_layout(jm, jt, 48, pools, defer_cyl=pools is not None)
        tl = TCon.build_layout(tm, tt, 48, pools, defer_cyl=pools is not None)
        for f in dataclasses.fields(jl):
            a, b = getattr(jl, f.name), getattr(tl, f.name)
            if f.name == "con_diagapprox":
                np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
            elif f.name == "pools" and a is not None:
                for (ca, ia, ka), (cb, ib, kb) in zip(a, b):
                    assert (ca, ka) == (cb, kb)
                    _eq(ia, ib, "pool idx")
            else:
                _eq(a, b, f.name)
        np.testing.assert_allclose(TCon._packed_const(tl), JCon._packed_const(jl),
                                   rtol=1e-12, atol=0)


def test_env_iterations_default_to_the_model():
    """solver_iterations=None: the model's own Newton iterations (go1 15,
    go2 10); an integer overrides them."""
    assert Go1Env(Go1Config(robot="go2"), device="cpu").m.opt.iterations == 10
    assert Go1Env(Go1Config(ctrl_type="position"), device="cpu").m.opt.iterations == 15
    assert Go1Env(Go1Config(robot="go2", solver_iterations=4),
                  device="cpu").m.opt.iterations == 4


@pytest.mark.parametrize("robot", ["go1", "go2"])
def test_position_servo_matches(robot):
    """qfrc_actuator of the position model on 16 random states and
    targets, kp scaled per env as domain randomization does; targets far
    from the joints saturate the force clamp on some actuators.  The same
    float32 formulas in the same order: 1e-6 of the force scale."""
    jm, tm = jax_robot_model(robot, "position"), robot_model(robot, "position")
    rng = np.random.default_rng(0)
    B = 16
    qpos = (jm.key_qpos[0] + rng.normal(0, 0.3, (B, 19))).astype(np.float32)
    qvel = rng.normal(0, 2.0, (B, 18)).astype(np.float32)
    ctrl = rng.uniform(-3, 3, (B, 12)).astype(np.float32)
    nominal = {k: np.asarray(v, np.float32) for k, v in jm.params().items()}
    params = {k: np.repeat(v[None], B, 0) for k, v in nominal.items()}
    params["actuator_kp"] = (params["actuator_kp"]
                             * rng.uniform(0.9, 1.1, (B, 1))).astype(np.float32)
    j = jax.vmap(lambda q, v, c, p: JSmooth.actuator_force(jm, p, q, v, c))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl),
        {k: jnp.asarray(v) for k, v in params.items()})
    t = TSmooth.actuator_force(
        tm, {k: torch.as_tensor(v) for k, v in params.items()},
        torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(ctrl))
    j = np.asarray(j)
    fhi = jm.actuator_forcerange[:, 1] * jm.actuator_gear
    assert (np.abs(j[:, 6:]) == fhi.astype(np.float32)).any(), "clamp not hit"
    assert (np.abs(j[:, 6:]) < fhi).any()
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max())


def _jax_terrain(B, seed=0, amplitude=0.04):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    t = jax.vmap(lambda k: JTer.sample_terrain_params(
        k, 8, amplitude, 1.0, jnp.float32))(keys)
    return {k: np.array(v) for k, v in t.items()}


def test_height_normal_matches():
    """Height and normal of 4 envs' fields at 64 points each, and the
    tangent plane of a point set per env, on the reference's draws: 1e-6."""
    B, P = 4, 64
    ter = _jax_terrain(B)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-3, 3, (B, P, 2)).astype(np.float32)
    pts = np.concatenate([xy, rng.uniform(0, 0.5, (B, P, 1))], -1).astype(np.float32)
    jt = {k: jnp.asarray(v) for k, v in ter.items()}
    jh, jn = jax.vmap(JTer.height_normal)(jt, jnp.asarray(xy))
    jp, jpn = jax.vmap(JTer.local_plane)(jt, jnp.asarray(pts))
    tt = {k: torch.as_tensor(v) for k, v in ter.items()}
    th, tn = TTer.height_normal(tt, torch.as_tensor(xy))
    tp, tpn = TTer.local_plane(tt, torch.as_tensor(pts))
    for name, t, j in (("h", th, jh), ("n", tn, jn), ("ppos", tp, jp),
                       ("plane n", tpn, jpn)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=name)
    # one field shared by every point, and one per env, agree
    h0, _ = TTer.height_normal({k: v[0] for k, v in tt.items()},
                               torch.as_tensor(xy[0]))
    np.testing.assert_array_equal(h0.numpy(), th[0].numpy())


def test_terrain_draw_ranges():
    """The port's own draw (torch and JAX draw different numbers): each
    wave's amplitude in [0.5, 1] x 2 amplitude / n_waves, its wavelength
    in [0.5, 2] x wavelength, its phase in [0, 2 pi); shapes per env."""
    t = TTer.sample_terrain_params(512, torch.Generator().manual_seed(0),
                                   n_waves=8, amplitude=0.04, wavelength=1.0)
    amp, freq, phase = (t[k].numpy() for k in TTer.TERRAIN_KEYS)
    assert amp.shape == phase.shape == (512, 8) and freq.shape == (512, 8, 2)
    assert amp.min() >= 0.005 - 1e-9 and amp.max() <= 0.01 + 1e-9
    assert amp.max() - amp.min() > 0.004
    wl = 2 * np.pi / np.linalg.norm(freq, axis=-1)
    assert wl.min() >= 0.5 - 1e-5 and wl.max() <= 2.0 + 1e-5
    assert phase.min() >= 0.0 and phase.max() < 2 * np.pi


def _fixture_states():
    fx = [np.load(DATA / n) for n in ("stiff_contact_state.npz",
                                      "stiff_contact_state_b.npz")]
    m = robot_model("go1", "torque")
    rng = np.random.default_rng(2)
    home = m.key_qpos[0] + np.r_[0, 0, -0.02, np.zeros(16)]
    qpos = np.stack([fx[0]["qpos"], fx[1]["qpos"], home,
                     home + rng.normal(0, 0.05, 19)]).astype(np.float32)
    qvel = np.stack([fx[0]["qvel"], fx[1]["qvel"], np.zeros(18),
                     rng.normal(0, 0.3, 18)]).astype(np.float32)
    return qpos, qvel


@pytest.fixture(scope="module")
def terrain_contacts():
    """Narrowphase and assembled slots with a drawn field (amplitude 0.04)
    under the two stiff fixture states and two near-home states, pooled
    layout with deferred cylinders (the configuration of record), on both
    sides."""
    jm, tm = jax_robot_model("go1", "torque"), robot_model("go1", "torque")
    qpos, qvel = _fixture_states()
    ter = _jax_terrain(4, seed=3)
    jtab = JCol.build_table(jm, "full")
    jlay = JCon.build_layout(jm, jtab, 48, POOLS, defer_cyl=True)

    def ref(qp, qv, t):
        kin = jax_fk(jm, qp, qv)
        nph = JCol.narrowphase(jm, jtab, kin, terrain=t, defer_cyl=True,
                               frames="normal")
        efc = JCon.assemble(jm, jlay, jtab, kin, qp, qv, terrain=t)
        return nph, (efc.con_sel, efc.con_active, efc.con_dist, efc.con_pos,
                     efc.con_frame, efc.J, efc.aref)

    J = jax.jit(jax.vmap(ref))(jnp.asarray(qpos), jnp.asarray(qvel),
                               {k: jnp.asarray(v) for k, v in ter.items()})
    J = jax.tree.map(np.asarray, J)
    pl = Pipeline.build(tm, "full", max_contacts=48, contact_pools=POOLS)
    tq, tv = torch.as_tensor(qpos), torch.as_tensor(qvel)
    tt = {k: torch.as_tensor(v) for k, v in ter.items()}
    kin = fk(tm, tq, tv)
    nph = TCol.narrowphase(tm, pl.table, kin, terrain=tt, defer_cyl=True)
    efc = TCon.assemble(tm, pl.layout, pl.table, kin, tq, tv, terrain=tt)
    T = (nph, (efc.con_sel, efc.con_active, efc.con_dist, efc.con_pos,
               efc.con_frame, efc.J, efc.aref))
    return J, T, pl


def _close(t, j, tol, name):
    t = t.numpy()
    for i in range(j.shape[0]):
        scale = 1.0 + np.abs(j[i]).max()
        np.testing.assert_allclose(t[i] / scale, j[i] / scale, rtol=0, atol=tol,
                                   err_msg=f"{name} state {i}")


def test_terrain_narrowphase_matches(terrain_contacts):
    """dist, pos and normal of all 811 candidates against the local
    tangent planes (1e-5 of each output's scale, as on the flat floor),
    the set of active candidates exactly; the normals of plane pairs are
    tilted (not the flat (0, 0, 1))."""
    J, T, pl = terrain_contacts
    (jd, jp, jn), (td, tp, tn) = J[0], T[0]
    _close(td, jd, 1e-5, "dist")
    _close(tp, jp, 1e-5, "pos")
    _close(tn, jn, 1e-5, "normal")
    incm = pl.table.cand_meta("includemargin").astype(np.float32)
    np.testing.assert_array_equal(td.numpy() < incm, jd < incm)
    plane = np.concatenate([np.full(g.ncand, g.kind.startswith("plane_"))
                            for g in pl.table.groups])
    assert (np.abs(jn[:, plane, 2]) < 1.0 - 1e-6).all()


def test_terrain_slots_match(terrain_contacts):
    """The slots the solver sees on terrain: con_sel and con_active
    exactly; distances, points, the deferred frames built from the
    gathered local normals, J rows and aref at 1e-5."""
    J, T, _ = terrain_contacts
    jsel, jact, jdist, jpos, jfr, jJ, jaref = J[1]
    tsel, tact, tdist, tpos, tfr, tJ, taref = T[1]
    np.testing.assert_array_equal(tsel.numpy(), jsel)
    np.testing.assert_array_equal(tact.numpy(), jact)
    assert jact.any(axis=1).all()
    tdist = torch.where(tdist >= 1e8, torch.zeros_like(tdist), tdist)
    jdist = np.where(jdist >= 1e8, 0.0, jdist)
    for name, t, j in (("con_dist", tdist, jdist), ("con_pos", tpos, jpos),
                       ("con_frame", tfr, jfr), ("J", tJ, jJ), ("aref", taref, jaref)):
        _close(t.reshape(t.shape[0], -1), j.reshape(j.shape[0], -1), 1e-5, name)


def test_zero_amplitude_is_flat_bitwise():
    """Zero-amplitude terrain reproduces the flat plane bit for bit: every
    candidate's dist, pos and normal, then a whole 10-substep control
    step (qpos, qvel, qacc, contact forces)."""
    m = robot_model("go1", "position")
    pl = Pipeline.build(m, "full", max_contacts=48, contact_pools=POOLS)
    qpos, qvel = (torch.as_tensor(x) for x in _fixture_states())
    flat = TTer.flat_terrain_params()
    kin = fk(m, qpos, qvel)
    a = TCol.narrowphase(m, pl.table, kin, defer_cyl=True)
    b = TCol.narrowphase(m, pl.table, kin, terrain=flat, defer_cyl=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    params = {k: torch.as_tensor(v, dtype=torch.float32).expand(4, *v.shape)
              for k, v in m.params().items()}
    ctrl = torch.as_tensor(np.tile(m.key_ctrl[0], (4, 1)), dtype=torch.float32)
    m.opt.iterations = 3
    r0 = step_n(pl, params, qpos, qvel, ctrl, 10)
    r1 = step_n(pl, {**params, **flat}, qpos, qvel, ctrl, 10)
    for x, y in zip(r0[:2], r1[:2]):
        assert torch.equal(x, y)
    assert torch.equal(r0[2].qacc, r1[2].qacc)
    assert torch.equal(r0[2].con_force, r1[2].con_force)
