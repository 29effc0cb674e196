"""Smooth (constraint-free) dynamics, batch-first: CRBA mass matrix, RNEA
bias forces, passive forces, and motor and position-servo actuation.

Counterpart of quadruped_tpu/physics/smooth.py, in the same absolute
Plücker coordinates (kinematics.fk), with every tree recursion flattened
into a static-mask matmul.

`params` is the model's parameter dict (mjcf.model.PhysicsModel.params),
as tensors either per env (B, ...) or shared (...): every use broadcasts.
"""

from __future__ import annotations

import torch

from ..mjcf.model import ACT_MOTOR, PhysicsModel
from .consts import cached, index
from .kinematics import Kin, ancestor_dof_pair_mask, tree_levels
from .math import chol_factor, chol_solve, force_cross, motion_cross, skew


def body_inertias(m: PhysicsModel, params, kin: Kin) -> torch.Tensor:
    """(B, nbody, 6, 6) spatial inertia of each body about kin.ref.

    H = [[I_c - m c~ c~,  m c~],
         [-m c~,          m 1 ]]   with c = com - ref.
    """
    dtype = kin.xpos.dtype
    mass = params["body_mass"].to(dtype)
    diag = params["body_inertia"].to(dtype)
    c = kin.xipos - kin.ref[:, None, :]
    R = kin.ximat
    Ic = R @ (diag[..., None] * R.transpose(-1, -2))
    cx = skew(c)
    mcx = mass[..., None, None] * cx
    eye = torch.eye(3, dtype=dtype, device=c.device)
    top = torch.cat([Ic - mcx @ cx, mcx], dim=-1)
    bot = torch.cat([-mcx, (mass[..., None, None] * eye).expand_as(mcx)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crba(m: PhysicsModel, params, kin: Kin) -> torch.Tensor:
    """(B, nv, nv) joint-space inertia matrix (mj_fullM + armature)."""
    lv = tree_levels(m)
    H = body_inertias(m, params, kin)
    dtype, dev = H.dtype, H.device
    B = H.shape[0]
    sub = cached(m, "sub_body", lambda: lv.sub_body, dev, dtype)
    Hc = (sub @ H.reshape(B, m.nbody, 36)).reshape(B, m.nbody, 6, 6)
    # f_d = Hc[body(d)] @ cdof_d ; M[e,d] = cdof_e . f_d on ancestor pairs
    dof_body = index(m, "dof_bodyid", lambda: m.dof_bodyid, dev)
    F = (Hc[:, dof_body] @ kin.cdof[..., None])[..., 0]
    P = kin.cdof @ F.transpose(-1, -2)
    mask = cached(m, "dof_pair_mask", lambda: ancestor_dof_pair_mask(m), dev)
    W = torch.where(mask, P, torch.zeros((), dtype=dtype, device=dev))
    M = W + W.transpose(-1, -2) - torch.diag_embed(torch.diagonal(W, dim1=-2, dim2=-1))
    return M + torch.diag_embed(params["dof_armature"].to(dtype)).expand_as(M)


def rne_bias(m: PhysicsModel, params, kin: Kin, qvel: torch.Tensor) -> torch.Tensor:
    """(B, nv) bias forces C(q,v)v + G(q) (mujoco qfrc_bias): RNEA with
    qacc = 0 and base acceleration -g, the velocity-product recursion
    flattened into one ancestor-mask matmul."""
    dtype, dev = qvel.dtype, qvel.device
    lv = tree_levels(m)
    gravity = params["gravity"].to(dtype)
    H = body_inertias(m, params, kin)

    svel_mask = cached(m, "svel_mask", lambda: lv.svel_mask, dev, dtype)
    svel = svel_mask @ (kin.cdof * qvel[:, :, None])
    bias = motion_cross(kin.cvel, svel)                      # (B, nbody, 6)
    a0 = torch.cat([torch.zeros_like(gravity), -gravity], dim=-1)
    anc = cached(m, "anc_body", lambda: lv.anc_body, dev, dtype)
    acc = a0[..., None, :] + anc @ bias                      # (B, nbody, 6)

    Hv = (H @ kin.cvel[..., None])[..., 0]
    f = (H @ acc[..., None])[..., 0] + force_cross(kin.cvel, Hv)
    sub = cached(m, "sub_body", lambda: lv.sub_body, dev, dtype)
    fs = sub @ f                                             # (B, nbody, 6)
    dof_body = index(m, "dof_bodyid", lambda: m.dof_bodyid, dev)
    return torch.sum(kin.cdof * fs[:, dof_body], dim=-1)


def passive_force(m: PhysicsModel, params, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_passive: joint damping (the Go1 models use no springs)."""
    return -params["dof_damping"].to(qvel.dtype) * qvel


def actuator_force(
    m: PhysicsModel, params, qpos: torch.Tensor, qvel: torch.Tensor,
    ctrl: torch.Tensor,
) -> torch.Tensor:
    """qfrc_actuator from clamped ctrl, per actuator by its kind:

    motor:    force = gear * ctrl                        (go1_torque.xml)
    position: force = clamp(kp*(ctrl - q) - kv*qdot) * gear
              (go1_position.xml servos; the clamp to forcerange where
              forcelimited; kp from params, per env under domain
              randomization, kv from the model)
    """
    dtype, dev = qpos.dtype, qpos.device
    lo = cached(m, "ctrl_lo", lambda: m.actuator_ctrlrange[:, 0], dev, dtype)
    hi = cached(m, "ctrl_hi", lambda: m.actuator_ctrlrange[:, 1], dev, dtype)
    limited = cached(m, "ctrl_limited", lambda: m.actuator_ctrllimited, dev)
    c = torch.where(limited, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    gear = params["actuator_gear"].to(dtype)
    dadr = index(m, "act_dofadr", lambda: m.jnt_dofadr[m.actuator_trnid], dev)
    force = gear * c
    if (m.actuator_kind != ACT_MOTOR).any():
        qadr = index(m, "act_qposadr", lambda: m.jnt_qposadr[m.actuator_trnid], dev)
        kv = cached(m, "act_kv", lambda: m.actuator_kv, dev, dtype)
        flo = cached(m, "force_lo", lambda: m.actuator_forcerange[:, 0], dev, dtype)
        fhi = cached(m, "force_hi", lambda: m.actuator_forcerange[:, 1], dev, dtype)
        flimited = cached(m, "force_limited", lambda: m.actuator_forcelimited, dev)
        pos_f = params["actuator_kp"].to(dtype) * (c - qpos[:, qadr]) - kv * qvel[:, dadr]
        pos_f = torch.where(flimited, torch.minimum(torch.maximum(pos_f, flo), fhi), pos_f)
        motor = cached(m, "act_motor", lambda: m.actuator_kind == ACT_MOTOR, dev)
        force = torch.where(motor, force, pos_f * gear)
    qfrc = torch.zeros((qpos.shape[0], m.nv), dtype=dtype, device=dev)
    return qfrc.index_add_(1, dadr, force)


def smooth_dynamics(m: PhysicsModel, params, kin: Kin, qpos, qvel, ctrl):
    """Returns (M, L, qfrc_smooth, qacc_smooth, qfrc_actuator)."""
    M = crba(m, params, kin)
    bias = rne_bias(m, params, kin, qvel)
    qfrc_act = actuator_force(m, params, qpos, qvel, ctrl)
    qfrc_smooth = qfrc_act + passive_force(m, params, qvel) - bias
    L = chol_factor(M)
    qacc_smooth = chol_solve(L, qfrc_smooth)
    return M, L, qfrc_smooth, qacc_smooth, qfrc_act
