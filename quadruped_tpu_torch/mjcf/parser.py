"""compile_spec: RawSpec -> PhysicsModel (numpy only).

The port's own copy of the JAX package's MJCF compiler back end
(quadruped_tpu/mjcf/parser.py:compile_spec).  The XML front end is not
needed: robots ship as defaults-resolved RawSpec JSON (assets/).
"""

from __future__ import annotations

import numpy as np

from .model import JNT_FREE, JNT_HINGE, PhysicsModel

_JNT_NQ = {JNT_FREE: 7, JNT_HINGE: 1}
_JNT_NV = {JNT_FREE: 6, JNT_HINGE: 1}


def compile_spec(spec) -> PhysicsModel:
    opt, b, geoms = spec.opt, spec, spec.geoms

    nbody = len(b.bodies)
    njnt = len(b.joints)
    ngeom = len(geoms)
    nsite = len(b.sites)
    nu = len(b.actuators)
    nkey = len(b.keys)

    # joint addressing (document order == body order already)
    jnt_qposadr = np.zeros(njnt, dtype=np.int32)
    jnt_dofadr = np.zeros(njnt, dtype=np.int32)
    nq = nv = 0
    for i, j in enumerate(b.joints):
        jnt_qposadr[i] = nq
        jnt_dofadr[i] = nv
        nq += _JNT_NQ[j["type"]]
        nv += _JNT_NV[j["type"]]

    body_parentid = np.array([bd["parent"] for bd in b.bodies], dtype=np.int32)
    body_parentid[0] = 0  # MuJoCo convention: world's parent is itself
    body_rootid = np.zeros(nbody, dtype=np.int32)
    for i in range(1, nbody):
        p = body_parentid[i]
        body_rootid[i] = i if p == 0 else body_rootid[p]

    body_jntadr = np.full(nbody, -1, dtype=np.int32)
    body_jntnum = np.zeros(nbody, dtype=np.int32)
    body_dofadr = np.full(nbody, -1, dtype=np.int32)
    body_dofnum = np.zeros(nbody, dtype=np.int32)
    for i, j in enumerate(b.joints):
        bid = j["body"]
        if body_jntadr[bid] < 0:
            body_jntadr[bid] = i
            body_dofadr[bid] = jnt_dofadr[i]
        body_jntnum[bid] += 1
        body_dofnum[bid] += _JNT_NV[j["type"]]

    def _stack(dicts, key, default):
        if not dicts:
            return np.zeros((0,) + np.shape(default))
        return np.stack([np.asarray(d.get(key, default), dtype=float) for d in dicts])

    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_mass = np.zeros(nbody)
    body_inertia = np.zeros((nbody, 3))
    for i, bd in enumerate(b.bodies):
        if bd["inertial"] is not None:
            body_ipos[i] = bd["inertial"]["pos"]
            body_iquat[i] = bd["inertial"]["quat"]
            body_mass[i] = bd["inertial"]["mass"]
            body_inertia[i] = bd["inertial"]["diaginertia"]

    dof_bodyid = np.zeros(nv, dtype=np.int32)
    dof_jntid = np.zeros(nv, dtype=np.int32)
    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    dof_solref = np.tile(np.array([0.02, 1.0]), (nv, 1))
    dof_solimp = np.tile(np.array([0.9, 0.95, 0.001, 0.5, 2.0]), (nv, 1))
    for i, j in enumerate(b.joints):
        adr, n = jnt_dofadr[i], _JNT_NV[j["type"]]
        dof_bodyid[adr : adr + n] = j["body"]
        dof_jntid[adr : adr + n] = i
        dof_armature[adr : adr + n] = j["armature"]
        dof_damping[adr : adr + n] = j["damping"]
        dof_frictionloss[adr : adr + n] = j["frictionloss"]
        dof_solref[adr : adr + n] = j["solreffriction"]
        dof_solimp[adr : adr + n] = j["solimpfriction"]

    jname2id = {j["name"]: i for i, j in enumerate(b.joints)}

    key_qpos = np.zeros((nkey, nq))
    key_ctrl = np.zeros((nkey, nu))
    for i, k in enumerate(b.keys):
        if k["qpos"] is not None:
            key_qpos[i] = k["qpos"]
        if k["ctrl"] is not None:
            key_ctrl[i] = k["ctrl"]

    return PhysicsModel(
        opt=opt,
        nq=nq,
        nv=nv,
        nu=nu,
        nbody=nbody,
        njnt=njnt,
        ngeom=ngeom,
        nsite=nsite,
        nkey=nkey,
        body_parentid=body_parentid,
        body_rootid=body_rootid,
        body_jntadr=body_jntadr,
        body_jntnum=body_jntnum,
        body_dofadr=body_dofadr,
        body_dofnum=body_dofnum,
        body_pos=_stack(b.bodies, "pos", np.zeros(3)),
        body_quat=_stack(b.bodies, "quat", np.array([1.0, 0, 0, 0])),
        body_ipos=body_ipos,
        body_iquat=body_iquat,
        body_mass=body_mass,
        body_inertia=body_inertia,
        jnt_type=np.array([j["type"] for j in b.joints], dtype=np.int32),
        jnt_bodyid=np.array([j["body"] for j in b.joints], dtype=np.int32),
        jnt_qposadr=jnt_qposadr,
        jnt_dofadr=jnt_dofadr,
        jnt_pos=_stack(b.joints, "pos", np.zeros(3)),
        jnt_axis=_stack(b.joints, "axis", np.array([0.0, 0, 1])),
        jnt_range=_stack(b.joints, "range", np.zeros(2)),
        jnt_limited=np.array([j["limited"] for j in b.joints], dtype=bool),
        jnt_solref=_stack(b.joints, "solreflimit", np.array([0.02, 1.0])),
        jnt_solimp=_stack(
            b.joints, "solimplimit", np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        ),
        jnt_margin=np.array([j["margin"] for j in b.joints]),
        dof_bodyid=dof_bodyid,
        dof_jntid=dof_jntid,
        dof_armature=dof_armature,
        dof_damping=dof_damping,
        dof_frictionloss=dof_frictionloss,
        dof_solref=dof_solref,
        dof_solimp=dof_solimp,
        geom_type=np.array([g["type"] for g in geoms], dtype=np.int32),
        geom_bodyid=np.array([g["body"] for g in geoms], dtype=np.int32),
        geom_pos=_stack(geoms, "pos", np.zeros(3)),
        geom_quat=_stack(geoms, "quat", np.array([1.0, 0, 0, 0])),
        geom_size=_stack(geoms, "size", np.zeros(3)),
        geom_contype=np.array([g["contype"] for g in geoms], dtype=np.int32),
        geom_conaffinity=np.array([g["conaffinity"] for g in geoms], dtype=np.int32),
        geom_condim=np.array([g["condim"] for g in geoms], dtype=np.int32),
        geom_priority=np.array([g["priority"] for g in geoms], dtype=np.int32),
        geom_friction=_stack(geoms, "friction", np.array([1.0, 0.005, 0.0001])),
        geom_solmix=np.array([g["solmix"] for g in geoms]),
        geom_solref=_stack(geoms, "solref", np.array([0.02, 1.0])),
        geom_solimp=_stack(
            geoms, "solimp", np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        ),
        geom_margin=np.array([g["margin"] for g in geoms]),
        geom_gap=np.array([g["gap"] for g in geoms]),
        geom_group=np.array([g["group"] for g in geoms], dtype=np.int32),
        geom_rgba=_stack(geoms, "rgba", np.array([0.5, 0.5, 0.5, 1.0])),
        site_bodyid=np.array([s["body"] for s in b.sites], dtype=np.int32),
        site_pos=_stack(b.sites, "pos", np.zeros(3)),
        actuator_kind=np.array([a["kind"] for a in b.actuators], dtype=np.int32),
        actuator_trnid=np.array(
            [jname2id[a["joint"]] for a in b.actuators], dtype=np.int32
        ),
        actuator_gear=np.array([a["gear"] for a in b.actuators]),
        actuator_kp=np.array([a["kp"] for a in b.actuators]),
        actuator_kv=np.array([a["kv"] for a in b.actuators]),
        actuator_ctrlrange=_stack(b.actuators, "ctrlrange", np.zeros(2)),
        actuator_forcerange=_stack(b.actuators, "forcerange", np.zeros(2)),
        actuator_ctrllimited=np.array(
            [a["ctrllimited"] for a in b.actuators], dtype=bool
        ),
        actuator_forcelimited=np.array(
            [a["forcelimited"] for a in b.actuators], dtype=bool
        ),
        key_qpos=key_qpos,
        key_ctrl=key_ctrl,
        body_names=[bd["name"] for bd in b.bodies],
        joint_names=[j["name"] for j in b.joints],
        geom_names=[g["name"] for g in geoms],
        site_names=[s["name"] for s in b.sites],
        actuator_names=[a["name"] for a in b.actuators],
        key_names=[k["name"] for k in b.keys],
    )
