"""Forward kinematics and velocity kinematics, batch-first.

Counterpart of quadruped_tpu/physics/kinematics.py.  Spatial quantities
use the reference's "absolute" Plücker coordinates: world axes, moments
about a point `ref` (the root body's origin).  Bodies are processed level
by level down the tree (Go1: trunk -> 4 hips -> 4 thighs -> 4 calves),
each level's quaternion math batched over its bodies and the env batch.

Conventions (reference, oracle-verified there): free joint qvel = (world
linear, body-frame angular); hinge axis and anchor fixed in the child
body frame.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..mjcf.model import JNT_FREE, JNT_HINGE, PhysicsModel
from .consts import cached, index
from .math import cross, quat_mul, quat_normalize, quat_rotate, quat_to_mat


@dataclasses.dataclass
class Kin:
    """Kinematic cache of a batch of states (leading axis B)."""

    xpos: torch.Tensor        # (B, nbody, 3) body frame origins, world
    xquat: torch.Tensor       # (B, nbody, 4)
    xmat: torch.Tensor        # (B, nbody, 3, 3)
    xipos: torch.Tensor       # (B, nbody, 3) body CoM, world
    ximat: torch.Tensor       # (B, nbody, 3, 3) inertial frame axes, world
    geom_xpos: torch.Tensor   # (B, ngeom, 3)
    geom_xmat: torch.Tensor   # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor   # (B, nsite, 3)
    ref: torch.Tensor         # (B, 3) reference point of all Plücker moments
    cdof: torch.Tensor        # (B, nv, 6) dof motion vectors [omega; v_ref]
    cvel: torch.Tensor        # (B, nbody, 6) body spatial velocity


@dataclasses.dataclass(eq=False)
class _Levels:
    """Static tree schedule: bodies grouped by depth, joints by type."""

    levels: list  # list of dicts with numpy index arrays
    hinge_jnt: np.ndarray
    hinge_body: np.ndarray
    hinge_dof: np.ndarray
    hinge_qadr: np.ndarray
    free_jnt: np.ndarray
    svel_mask: np.ndarray      # (nbody, nv) body-fixed dofs (hinge, free rot)
    anc_body: np.ndarray       # (nbody, nbody) ancestor-or-self (excl world)
    sub_body: np.ndarray       # (nbody, nbody) sub[b,d]=1 if d in subtree(b)


_LVL_CACHE: "weakref.WeakKeyDictionary[PhysicsModel, _Levels]" = (
    weakref.WeakKeyDictionary()
)
_ANC_CACHE: "weakref.WeakKeyDictionary[PhysicsModel, np.ndarray]" = (
    weakref.WeakKeyDictionary()
)


def tree_levels(m: PhysicsModel) -> _Levels:
    if m in _LVL_CACHE:
        return _LVL_CACHE[m]
    depth = np.zeros(m.nbody, dtype=int)
    for i in range(1, m.nbody):
        depth[i] = depth[m.body_parentid[i]] + 1
    levels = []
    for d in range(1, depth.max() + 1):
        ids = np.where(depth == d)[0]
        jnt = np.full(len(ids), -1)
        for k, b in enumerate(ids):
            if m.body_jntnum[b] > 1:
                raise NotImplementedError("at most one joint per body")
            if m.body_jntnum[b] == 1:
                jnt[k] = m.body_jntadr[b]
        hinge = np.array([k for k in range(len(ids)) if jnt[k] >= 0
                          and m.jnt_type[jnt[k]] == JNT_HINGE])
        free = np.array([k for k in range(len(ids)) if jnt[k] >= 0
                         and m.jnt_type[jnt[k]] == JNT_FREE])
        levels.append(
            dict(
                ids=ids,
                parents=m.body_parentid[ids].copy(),
                hinge_k=hinge.astype(int),
                free_k=free.astype(int),
                jnt=jnt,
            )
        )

    hinge_jnt = np.where(m.jnt_type == JNT_HINGE)[0]
    free_jnt = np.where(m.jnt_type == JNT_FREE)[0]

    svel_mask = np.zeros((m.nbody, m.nv))
    for j in range(m.njnt):
        b = int(m.jnt_bodyid[j])
        d = int(m.jnt_dofadr[j])
        if m.jnt_type[j] == JNT_HINGE:
            svel_mask[b, d] = 1.0
        else:  # free: rotational dofs only
            svel_mask[b, d + 3 : d + 6] = 1.0

    anc_body = np.zeros((m.nbody, m.nbody))
    for b in range(1, m.nbody):
        i = b
        while i != 0:
            anc_body[b, i] = 1.0
            i = int(m.body_parentid[i])

    lv = _Levels(
        levels=levels,
        hinge_jnt=hinge_jnt,
        hinge_body=m.jnt_bodyid[hinge_jnt].copy(),
        hinge_dof=m.jnt_dofadr[hinge_jnt].copy(),
        hinge_qadr=m.jnt_qposadr[hinge_jnt].copy(),
        free_jnt=free_jnt,
        svel_mask=svel_mask,
        anc_body=anc_body,
        sub_body=anc_body.T.copy(),
    )
    _LVL_CACHE[m] = lv
    return lv


def ancestor_dof_mask(m: PhysicsModel) -> np.ndarray:
    """(nbody, nv) bool: dof d affects body b."""
    if m not in _ANC_CACHE:
        mask = np.zeros((m.nbody, m.nv), dtype=bool)
        for b in range(1, m.nbody):
            i = b
            while i != 0:
                dadr, dnum = int(m.body_dofadr[i]), int(m.body_dofnum[i])
                if dnum:
                    mask[b, dadr : dadr + dnum] = True
                i = int(m.body_parentid[i])
        _ANC_CACHE[m] = mask
    return _ANC_CACHE[m]


def ancestor_dof_pair_mask(m: PhysicsModel) -> np.ndarray:
    """(nv, nv) bool, upper triangle: dof e is on the ancestor chain of
    dof d.  Each unordered pair counts once (dof order is topological)."""
    body_mask = ancestor_dof_mask(m)
    out = np.zeros((m.nv, m.nv), dtype=bool)
    for d in range(m.nv):
        out[:, d] = body_mask[int(m.dof_bodyid[d])]
    return np.triu(out)


def fk(m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor) -> Kin:
    """Kinematics of a batch: qpos (B, nq), qvel (B, nv)."""
    dtype, dev = qpos.dtype, qpos.device
    B = qpos.shape[0]
    lv = tree_levels(m)

    def const(name, make):
        return cached(m, name, make, dev, dtype)

    def ix(name, make):
        return index(m, name, make, dev)

    nb = m.nbody
    xpos = torch.zeros((B, nb, 3), dtype=dtype, device=dev)
    xquat = torch.zeros((B, nb, 4), dtype=dtype, device=dev)
    xquat[:, :, 0] = 1.0

    for li, lev in enumerate(lv.levels):
        ids = lev["ids"]
        par = ix(f"fk_par{li}", lambda: lev["parents"])
        pq = xquat[:, par]
        pp = xpos[:, par]
        xq = quat_mul(pq, const(f"fk_bquat{li}", lambda: m.body_quat[ids]))
        xp = pp + quat_rotate(pq, const(f"fk_bpos{li}", lambda: m.body_pos[ids]))
        for k in lev["free_k"]:
            adr = int(m.jnt_qposadr[lev["jnt"][k]])
            xp[:, k] = qpos[:, adr : adr + 3]
            xq[:, k] = quat_normalize(qpos[:, adr + 3 : adr + 7])
        hk = lev["hinge_k"]
        if len(hk):
            jids = lev["jnt"][hk]
            theta = qpos[:, ix(f"fk_hqadr{li}", lambda: m.jnt_qposadr[jids])]
            hk = ix(f"fk_hk{li}", lambda: lev["hinge_k"])
            axis = const(f"fk_jaxis{li}", lambda: m.jnt_axis[jids])
            half = 0.5 * theta
            qj = torch.cat(
                [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
                dim=-1,
            )
            jpos = const(f"fk_jpos{li}", lambda: m.jnt_pos[jids])
            anchor = xp[:, hk] + quat_rotate(xq[:, hk], jpos)
            xq_h = quat_mul(xq[:, hk], qj)
            xp[:, hk] = anchor - quat_rotate(xq_h, jpos)
            xq[:, hk] = xq_h
        ids_t = ix(f"fk_ids{li}", lambda: ids)
        xpos[:, ids_t] = xp
        xquat[:, ids_t] = xq

    xmat = quat_to_mat(xquat)
    xipos = xpos + quat_rotate(xquat, const("body_ipos", lambda: m.body_ipos))
    ximat = xmat @ quat_to_mat(const("body_iquat", lambda: m.body_iquat))
    gb = ix("geom_bodyid", lambda: m.geom_bodyid)
    geom_xpos = xpos[:, gb] + quat_rotate(
        xquat[:, gb], const("geom_pos", lambda: m.geom_pos)
    )
    geom_xmat = quat_to_mat(
        quat_mul(xquat[:, gb], const("geom_quat", lambda: m.geom_quat))
    )
    if m.nsite:
        sb = ix("site_bodyid", lambda: m.site_bodyid)
        site_xpos = xpos[:, sb] + quat_rotate(
            xquat[:, sb], const("site_pos", lambda: m.site_pos)
        )
    else:
        site_xpos = torch.zeros((B, 0, 3), dtype=dtype, device=dev)

    # reference point for Plücker moments: first root body origin (trunk)
    ref = xpos[:, 1] if nb > 1 else torch.zeros((B, 3), dtype=dtype, device=dev)

    # dof motion vectors: all hinges batched, free joints unrolled
    cdof = torch.zeros((B, m.nv, 6), dtype=dtype, device=dev)
    if len(lv.hinge_jnt):
        hb = ix("hinge_body", lambda: lv.hinge_body)
        haxis = const("hinge_axis", lambda: m.jnt_axis[lv.hinge_jnt])
        axis_w = torch.einsum("bjac,jc->bja", xmat[:, hb], haxis)
        anchor = xpos[:, hb] + quat_rotate(
            xquat[:, hb], const("hinge_pos", lambda: m.jnt_pos[lv.hinge_jnt])
        )
        vref = cross(axis_w, ref[:, None, :] - anchor)
        cdof[:, ix("hinge_dof", lambda: lv.hinge_dof)] = torch.cat(
            [axis_w, vref], dim=-1
        )
    for j in lv.free_jnt:
        b = int(m.jnt_bodyid[j])
        dadr = int(m.jnt_dofadr[j])
        Rt = xmat[:, b].transpose(-1, -2)
        arm = ref - xpos[:, b]
        cdof[:, dadr : dadr + 3, 3:] = torch.eye(3, dtype=dtype, device=dev)
        cdof[:, dadr + 3 : dadr + 6, :3] = Rt
        cdof[:, dadr + 3 : dadr + 6, 3:] = cross(Rt, arm[:, None, :])

    # body spatial velocities: one ancestor-mask matmul
    anc = const("anc_dof_mask", lambda: ancestor_dof_mask(m))
    cvel = anc @ (cdof * qvel[:, :, None])

    return Kin(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat, site_xpos=site_xpos,
        ref=ref, cdof=cdof, cvel=cvel,
    )
