"""Full physics step, batch-first: forward dynamics + semi-implicit Euler.

Counterpart of quadruped_tpu/physics/forward.py.  Per substep:
    fk -> smooth dynamics (CRBA/RNEA/actuation) -> narrowphase +
    constraint assembly -> Newton solve -> cfrc_ext -> implicit-damping
    Euler.
The equivalent of MuJoCo's mj_step; the env runs 10 substeps per control
step (reference frame_skip=10).

Integration (oracle-verified in the reference): qacc is the solver's
output; velocities integrate with implicit joint damping,
    v' = v + h (M + h diag(damping))^{-1} (M qacc),
free-joint quaternions integrate exactly by the body-frame angular
velocity; hinge and translation coordinates are explicit Euler.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..mjcf.model import PhysicsModel
from ..timing import TIMER
from .collision import CollisionTable, build_table
from .consts import index
from .constraint import EfcLayout, assemble, build_layout
from .kinematics import Kin, fk, tree_levels
from .math import chol_factor, chol_solve, cross, quat_integrate
from .smooth import smooth_dynamics
from .solver import solve
from .terrain import terrain_of


@dataclasses.dataclass(eq=False)
class Pipeline:
    """Static pipeline: model + collision table + efc layout.  Build once
    per (model, collision mode)."""

    m: PhysicsModel
    table: CollisionTable
    layout: EfcLayout

    @staticmethod
    def build(
        m: PhysicsModel, mode: str = "plane", max_contacts: int | None = None,
        contact_pools: dict | None = None,
    ) -> "Pipeline":
        table = build_table(m, mode)
        if max_contacts is not None and max_contacts >= table.ncand:
            max_contacts = None
            contact_pools = None
        # deferred cylinder refinement with pools, as the reference's
        # default: the 10-iteration projection runs on the selected slots
        return Pipeline(
            m=m, table=table,
            layout=build_layout(
                m, table, max_contacts, contact_pools,
                defer_cyl=contact_pools is not None,
            ),
        )


@dataclasses.dataclass
class StepData:
    """Per-substep outputs the env reads (leading axis B)."""

    kin: Kin
    qacc: torch.Tensor            # (B, nv)
    qfrc_actuator: torch.Tensor   # (B, nv)
    cfrc_ext: torch.Tensor        # (B, nbody, 6) (torque, force), world
    con_force: torch.Tensor       # (B, K, 6) contact-frame forces
    con_dist: torch.Tensor        # (B, K)
    con_active: torch.Tensor      # (B, K) bool
    con_sel: torch.Tensor         # (B, K) candidate index per solver slot
    con_overflow: torch.Tensor    # (B,) i32 active candidates dropped


def forward(
    pl: Pipeline, params: dict[str, Any], qpos: torch.Tensor,
    qvel: torch.Tensor, ctrl: torch.Tensor,
    warmstart: torch.Tensor | None = None,
):
    """Forward dynamics at (qpos, qvel, ctrl).  Returns (StepData, M).
    Plane contacts collide with the heightfield when params hold one
    (physics/terrain.py), as in the reference (forward.py:120-129)."""
    m = pl.m
    with TIMER.phase("fk"):
        kin = fk(m, qpos, qvel)
    with TIMER.phase("smooth"):
        M, _L, _qfrc_smooth, qacc_smooth, qfrc_act = smooth_dynamics(
            m, params, kin, qpos, qvel, ctrl
        )
    with TIMER.phase("assemble"):
        efc = assemble(m, pl.layout, pl.table, kin, qpos, qvel,
                       terrain=terrain_of(params))
    with TIMER.phase("solve"):
        qacc, _qfrc_constraint, con_force = solve(
            m, M, qacc_smooth, efc, warmstart=warmstart
        )
    with TIMER.phase("cfrc"):
        cfrc = cfrc_ext(pl, params, kin, efc, con_force)
    return (
        StepData(
            kin=kin, qacc=qacc, qfrc_actuator=qfrc_act, cfrc_ext=cfrc,
            con_force=con_force, con_dist=efc.con_dist,
            con_active=efc.con_active, con_sel=efc.con_sel,
            con_overflow=efc.con_overflow,
        ),
        M,
    )


def cfrc_ext(pl: Pipeline, params, kin: Kin, efc, con_force: torch.Tensor):
    """Per-body external contact force, MuJoCo cfrc_ext layout: 6-vector
    (torque, force) in world axes, torque about the subtree CoM of the
    body's kinematic root.  The per-body accumulation is a batched segment
    sum (scatter_add over the slot's body ids); the world body stays 0."""
    m = pl.m
    dtype, dev = con_force.dtype, con_force.device
    B = con_force.shape[0]
    act = efc.con_active.to(dtype)[..., None]
    frame = efc.con_frame                                   # (B, K, 3, 3)
    # contact-frame rows are (n, t1, t2): world force and torque on geom2
    force_w = (con_force[..., :3, None] * frame).sum(-2) * act
    torque_w = (con_force[..., 3:, None] * frame).sum(-2) * act

    root_of = m.body_rootid
    mass = params["body_mass"].to(dtype).expand(B, m.nbody)
    mx = mass[..., None] * kin.xipos                        # (B, nbody, 3)
    root_idx = index(m, "body_rootid", lambda: root_of, dev)
    nroot_com = torch.zeros_like(mx).index_add_(1, root_idx, mx)
    wsum = torch.zeros_like(mass).index_add_(1, root_idx, mass)
    root_com = nroot_com / torch.clamp(wsum, min=1e-12)[..., None]
    # world body: subtree_com[0] is the whole-system CoM
    root_com[:, 0] = mx.sum(1) / torch.clamp(mass.sum(1), min=1e-12)[:, None]
    ref_b = root_com[:, root_idx]                           # (B, nbody, 3)

    bidx = torch.arange(B, device=dev)[:, None]
    b1, b2 = efc.con_body1, efc.con_body2
    t2 = torque_w + cross(efc.con_pos - ref_b[bidx, b2], force_w)
    t1 = torque_w + cross(efc.con_pos - ref_b[bidx, b1], force_w)
    i1 = b1[..., None].expand(-1, -1, 3)
    i2 = b2[..., None].expand(-1, -1, 3)
    zeros = torch.zeros((B, m.nbody, 3), dtype=dtype, device=dev)
    cfrc_t = zeros.scatter_add(1, i2, t2).scatter_add(1, i1, -t1)
    cfrc_f = zeros.scatter_add(1, i2, force_w).scatter_add(1, i1, -force_w)
    cfrc = torch.cat([cfrc_t, cfrc_f], dim=-1)
    cfrc[:, 0] = 0.0   # mujoco does not accumulate onto the world body
    return cfrc


def integrate(
    pl: Pipeline, params, qpos: torch.Tensor, qvel: torch.Tensor,
    qacc: torch.Tensor, M: torch.Tensor,
):
    """Semi-implicit Euler with implicit joint damping (MuJoCo mj_Euler)."""
    m = pl.m
    h = float(np.float32(m.opt.timestep))
    damping = params["dof_damping"].to(qpos.dtype)
    Mh = M + h * torch.diag_embed(damping)
    L = chol_factor(Mh)
    qvel_new = qvel + h * chol_solve(L, (M @ qacc[..., None])[..., 0])

    lv = tree_levels(m)
    qpos_new = qpos.clone()
    if len(lv.hinge_jnt):
        qadr = index(m, "hinge_qadr", lambda: lv.hinge_qadr, qpos.device)
        dadr = index(m, "hinge_dof", lambda: lv.hinge_dof, qpos.device)
        qpos_new[:, qadr] = qpos[:, qadr] + h * qvel_new[:, dadr]
    for j in lv.free_jnt:
        qadr = int(m.jnt_qposadr[j])
        dadr = int(m.jnt_dofadr[j])
        qpos_new[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + h * qvel_new[:, dadr : dadr + 3]
        qpos_new[:, qadr + 3 : qadr + 7] = quat_integrate(
            qpos[:, qadr + 3 : qadr + 7], qvel_new[:, dadr + 3 : dadr + 6], h
        )
    return qpos_new, qvel_new


def step(pl: Pipeline, params, qpos, qvel, ctrl, warmstart=None):
    """One physics substep.  Returns (qpos', qvel', StepData)."""
    data, M = forward(pl, params, qpos, qvel, ctrl, warmstart=warmstart)
    with TIMER.phase("integrate"):
        qpos_new, qvel_new = integrate(pl, params, qpos, qvel, data.qacc, M)
    return qpos_new, qvel_new, data


def step_n(pl: Pipeline, params, qpos, qvel, ctrl, n: int, warmstart=None):
    """n substeps with constant ctrl (reference frame_skip=10).  The Newton
    solve warm-starts from the previous substep's qacc (MuJoCo
    qacc_warmstart).  Returns (qpos', qvel', last substep's StepData):
    the env reads only the last one, as MuJoCo leaves xpos and cfrc of
    the last substep after mj_step."""
    warm = torch.zeros_like(qvel) if warmstart is None else warmstart
    data = None
    for _ in range(n):
        qpos, qvel, data = step(pl, params, qpos, qvel, ctrl, warmstart=warm)
        warm = data.qacc
    return qpos, qvel, data
