"""Compiled physics model: flat numpy arrays, MuJoCo-compatible naming.

The port's own copy of quadruped_tpu/mjcf/model.py (numpy only).  The
model is static host-side data: the kinematic tree, geom tables and
actuator tables never change during training.  The physics modules turn
the arrays they need into device tensors once per device
(physics/consts.py).  Fields that domain randomization may perturb per
environment are mirrored into the small `params()` dict, which the env
state carries per env.

Array names follow MjModel (body_pos, jnt_axis, geom_size, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# MuJoCo-compatible enum codes
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3
GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE = 0, 1, 2, 3
GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX, GEOM_MESH = 4, 5, 6, 7
CONE_PYRAMIDAL, CONE_ELLIPTIC = 0, 1
ACT_MOTOR, ACT_POSITION = 0, 1


@dataclasses.dataclass
class Option:
    timestep: float = 0.002
    gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81])
    )
    impratio: float = 1.0
    cone: int = CONE_PYRAMIDAL
    iterations: int = 10          # Newton iterations (warmstarted)
    ls_iterations: int = 8        # linesearch iterations
    tolerance: float = 1e-8
    # matmul precision for the solver's J-sized contractions: 'high'
    # (3-pass bf16, ~f32 accuracy) doubles speed vs 'highest' (6-pass);
    # parity tests pin 'highest'
    solver_precision: str = "high" 


@dataclasses.dataclass(eq=False)  # identity hash: usable as a cache key
class PhysicsModel:
    """Static, host-side compiled model (all numpy float64/int32)."""

    opt: Option

    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    nkey: int

    # bodies
    body_parentid: np.ndarray   # (nbody,) int
    body_rootid: np.ndarray     # (nbody,) int
    body_jntadr: np.ndarray     # (nbody,) int, -1 if none
    body_jntnum: np.ndarray     # (nbody,) int
    body_dofadr: np.ndarray     # (nbody,) int, -1 if none
    body_dofnum: np.ndarray     # (nbody,) int
    body_pos: np.ndarray        # (nbody, 3)
    body_quat: np.ndarray       # (nbody, 4)
    body_ipos: np.ndarray       # (nbody, 3)
    body_iquat: np.ndarray      # (nbody, 4)
    body_mass: np.ndarray       # (nbody,)
    body_inertia: np.ndarray    # (nbody, 3) diagonal in inertial frame

    # joints
    jnt_type: np.ndarray        # (njnt,) int
    jnt_bodyid: np.ndarray      # (njnt,) int
    jnt_qposadr: np.ndarray     # (njnt,) int
    jnt_dofadr: np.ndarray      # (njnt,) int
    jnt_pos: np.ndarray         # (njnt, 3)
    jnt_axis: np.ndarray        # (njnt, 3)
    jnt_range: np.ndarray       # (njnt, 2)
    jnt_limited: np.ndarray     # (njnt,) bool
    jnt_solref: np.ndarray      # (njnt, 2)  limit constraint solref
    jnt_solimp: np.ndarray      # (njnt, 5)  limit constraint solimp
    jnt_margin: np.ndarray      # (njnt,)

    # dofs
    dof_bodyid: np.ndarray      # (nv,) int
    dof_jntid: np.ndarray       # (nv,) int
    dof_armature: np.ndarray    # (nv,)
    dof_damping: np.ndarray     # (nv,)
    dof_frictionloss: np.ndarray  # (nv,)
    dof_solref: np.ndarray      # (nv, 2)  friction-loss constraint solref
    dof_solimp: np.ndarray      # (nv, 5)

    # geoms
    geom_type: np.ndarray       # (ngeom,) int
    geom_bodyid: np.ndarray     # (ngeom,) int
    geom_pos: np.ndarray        # (ngeom, 3)
    geom_quat: np.ndarray       # (ngeom, 4)
    geom_size: np.ndarray       # (ngeom, 3)
    geom_contype: np.ndarray    # (ngeom,) int
    geom_conaffinity: np.ndarray  # (ngeom,) int
    geom_condim: np.ndarray     # (ngeom,) int
    geom_priority: np.ndarray   # (ngeom,) int
    geom_friction: np.ndarray   # (ngeom, 3)
    geom_solmix: np.ndarray     # (ngeom,)
    geom_solref: np.ndarray     # (ngeom, 2)
    geom_solimp: np.ndarray     # (ngeom, 5)
    geom_margin: np.ndarray     # (ngeom,)
    geom_gap: np.ndarray        # (ngeom,)
    geom_group: np.ndarray      # (ngeom,) int
    geom_rgba: np.ndarray       # (ngeom, 4)

    # sites
    site_bodyid: np.ndarray     # (nsite,) int
    site_pos: np.ndarray        # (nsite, 3)

    # actuators
    actuator_kind: np.ndarray       # (nu,) int: ACT_MOTOR / ACT_POSITION
    actuator_trnid: np.ndarray      # (nu,) joint id
    actuator_gear: np.ndarray       # (nu,)
    actuator_kp: np.ndarray         # (nu,)  position servo gain
    actuator_kv: np.ndarray         # (nu,)  position servo damping
    actuator_ctrlrange: np.ndarray  # (nu, 2)
    actuator_forcerange: np.ndarray  # (nu, 2)
    actuator_ctrllimited: np.ndarray  # (nu,) bool
    actuator_forcelimited: np.ndarray  # (nu,) bool

    # keyframes
    key_qpos: np.ndarray        # (nkey, nq)
    key_ctrl: np.ndarray        # (nkey, nu)

    # names (python lists; not pytree leaves)
    body_names: list[str] = dataclasses.field(default_factory=list)
    joint_names: list[str] = dataclasses.field(default_factory=list)
    geom_names: list[str] = dataclasses.field(default_factory=list)
    site_names: list[str] = dataclasses.field(default_factory=list)
    actuator_names: list[str] = dataclasses.field(default_factory=list)
    key_names: list[str] = dataclasses.field(default_factory=list)

    def name2id(self, kind: str, name: str) -> int:
        names = {
            "body": self.body_names,
            "joint": self.joint_names,
            "geom": self.geom_names,
            "site": self.site_names,
            "actuator": self.actuator_names,
        }[kind]
        return names.index(name)

    @property
    def qpos0(self) -> np.ndarray:
        """Default qpos: keyframe-independent neutral configuration."""
        qpos = np.zeros(self.nq)
        for j in range(self.njnt):
            if self.jnt_type[j] == JNT_FREE:
                qpos[self.jnt_qposadr[j] + 3] = 1.0  # identity quat
        return qpos

    def params(self) -> dict[str, Any]:
        """Domain-randomizable parameter dict (numpy).

        These are the fields the reference varies (or that the DR configs in
        BASELINE.json require: mass / friction / actuator params); everything
        else stays compile-time constant.
        """
        return {
            "body_mass": self.body_mass.copy(),
            "body_inertia": self.body_inertia.copy(),
            "geom_friction": self.geom_friction.copy(),
            "dof_damping": self.dof_damping.copy(),
            "dof_armature": self.dof_armature.copy(),
            "dof_frictionloss": self.dof_frictionloss.copy(),
            "actuator_gear": self.actuator_gear.copy(),
            "actuator_kp": self.actuator_kp.copy(),
            "gravity": self.opt.gravity.copy(),
        }
