"""Constraint assembly, batch-first: MuJoCo's soft-constraint model with
static shapes.

Counterpart of quadruped_tpu/physics/constraint.py.  Row layout, fixed
when the pipeline is built:
  [dof friction rows | joint limit rows | contact rows]
where the contact rows come from top-K slots: either condim row pools
(per-condim-class slots emitting condim rows each, the configuration of
record) or uniform slots of 6 rows.  Inactive rows are masked, never
removed, so every shape is static.

Formulas (verified against mjData.efc_* by the reference's tests):
  impedance d(x): solimp=(dmin,dmax,width,mid,power), x=|pos-margin|/width
  K = 1/(dmax^2 tc^2 dr^2), B = 2/(dmax tc), dmax clamped to [1e-4, 0.9999]
  aref_i = -B (J qvel)_i - K d (pos_i - margin_i)
  R_i = max(1e-15, (1-d)/d * diagApprox_i);  D_i = 1/R_i
  contact friction rows: R_i = R_normal / impratio * (mu_1/mu_i)^2
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..mjcf.model import JNT_FREE, JNT_HINGE, PhysicsModel
from . import smooth
from .collision import (
    CYLKIND_CAPCYL,
    CYLKIND_CYLCYL,
    CollisionTable,
    frame_from_normal,
    make_frame,
    narrowphase,
    refine_cylinder_slots,
)
from .consts import cached, index
from .kinematics import Kin, ancestor_dof_mask, fk

_MAXIMP = 0.9999
_MINIMP = 1e-4
_MINVAL = 1e-15

_INVW_CACHE: "weakref.WeakKeyDictionary[PhysicsModel, tuple]" = (
    weakref.WeakKeyDictionary()
)
_CONST_CACHE: "weakref.WeakKeyDictionary[object, np.ndarray]" = (
    weakref.WeakKeyDictionary()
)


def invweights(m: PhysicsModel) -> tuple[np.ndarray, np.ndarray]:
    """(dof_invweight0 (nv,), body_invweight0 (nbody, 2)) at qpos0
    (mj_setConst), computed once per model in float64 on the CPU."""
    if m in _INVW_CACHE:
        return _INVW_CACHE[m]
    f64 = torch.float64
    qpos0 = torch.as_tensor(m.qpos0, dtype=f64)[None]
    kin = fk(m, qpos0, torch.zeros((1, m.nv), dtype=f64))
    params = {k: torch.as_tensor(v, dtype=f64) for k, v in m.params().items()}
    M = smooth.crba(m, params, kin)[0].numpy()
    Minv = np.linalg.inv(M)
    dof_invw = np.diag(Minv).copy()
    # free joints: MuJoCo averages the 3 translational / 3 rotational
    # diagonal entries per block
    for j in range(m.njnt):
        if m.jnt_type[j] == JNT_FREE:
            adr = int(m.jnt_dofadr[j])
            dof_invw[adr : adr + 3] = dof_invw[adr : adr + 3].mean()
            dof_invw[adr + 3 : adr + 6] = dof_invw[adr + 3 : adr + 6].mean()

    body_invw = np.zeros((m.nbody, 2))
    mask = ancestor_dof_mask(m)
    cdof = kin.cdof[0].numpy()
    ref = kin.ref[0].numpy()
    xipos = kin.xipos[0].numpy()
    for b in range(1, m.nbody):
        arm = xipos[b] - ref
        jt = (cdof[:, 3:] + np.cross(cdof[:, :3], arm[None, :])) * mask[b][:, None]
        jr = cdof[:, :3] * mask[b][:, None]
        body_invw[b, 0] = np.trace(jt.T @ Minv @ jt) / 3.0
        body_invw[b, 1] = np.trace(jr.T @ Minv @ jr) / 3.0
    _INVW_CACHE[m] = (dof_invw, body_invw)
    return dof_invw, body_invw


@dataclasses.dataclass(eq=False)
class EfcLayout:
    """Static structure of the constraint system for one model+table."""

    friction_dofs: np.ndarray      # (nf,) dof indices with frictionloss > 0
    limit_joints: np.ndarray       # (nl,) joint indices with limits
    ncon: int                      # number of contact candidates
    nefc: int                      # nf + nl + 6*ncon

    # per-candidate static contact metadata
    con_body1: np.ndarray          # (ncon,)
    con_body2: np.ndarray
    con_condim: np.ndarray         # (ncon,)
    con_friction: np.ndarray       # (ncon, 5)
    con_solref: np.ndarray         # (ncon, 2)
    con_solimp: np.ndarray         # (ncon, 5)
    con_margin: np.ndarray         # (ncon,)
    con_includemargin: np.ndarray  # (ncon,)
    con_diagapprox: np.ndarray     # (ncon,)  invweight sum for normal rows

    max_contacts: int | None = None  # top-K solver slots (None = all)
    # condim row pools: ((condim, cand_indices, K), ...)
    # ordered by descending condim.  Each class compacts its own actives
    # into K class slots emitting only `condim` J rows per slot — vs the
    # uniform top-K path's 6 rows per slot, ~2x fewer Gram rows at equal
    # contact capacity on the Go1 full-collision table
    pools: tuple | None = None

    # deferred cylinder refinement: per-candidate
    # geom ids / sizes / kind codes so the pooled path can run the
    # 10-iteration cylinder projection on the K SELECTED slots instead of
    # every candidate (collision.refine_cylinder_slots)
    con_geom1: np.ndarray | None = None   # (ncand,)
    con_geom2: np.ndarray | None = None
    con_rh: np.ndarray | None = None      # (ncand, 4) r1 h1 r2 h2
    con_cylkind: np.ndarray | None = None  # (ncand,) collision.CYLKIND_*
    defer_cyl: bool = False
    # deferred frames: plane_capsule candidates use a special
    # tangent rule, so slot-level frame_from_normal needs the flag
    con_pcap: np.ndarray | None = None    # (ncand,) 1.0 = plane_capsule


def build_layout(
    m: PhysicsModel, table: CollisionTable, max_contacts: int | None = None,
    contact_pools: dict | None = None, defer_cyl: bool = False,
) -> EfcLayout:
    _dof_invw, body_invw = invweights(m)
    friction_dofs = np.where(m.dof_frictionloss > 0)[0].astype(np.int32)
    limit_joints = np.where(m.jnt_limited & (m.jnt_type == JNT_HINGE))[0].astype(
        np.int32
    )
    b1 = table.cand_meta("body1")
    b2 = table.cand_meta("body2")
    ncon = table.ncand
    pools = None
    if contact_pools is not None:
        cd_all = np.asarray(table.cand_meta("condim"))
        pools = []
        for cdim in sorted(set(int(c) for c in cd_all), reverse=True):
            idx = np.where(cd_all == cdim)[0].astype(np.int32)
            budget = int(contact_pools.get(cdim, len(idx)))
            pools.append((cdim, idx, min(budget, len(idx))))
        pools = tuple(pools)
    g1c = table.cand_meta("geom1").astype(np.int32)
    g2c = table.cand_meta("geom2").astype(np.int32)
    cylkind = np.concatenate([
        np.full(
            g.ncand,
            CYLKIND_CAPCYL if g.kind == "capsule_cylinder"
            else CYLKIND_CYLCYL if g.kind == "cylinder_cylinder" else 0,
            np.int32,
        )
        for g in table.groups
    ]) if table.groups else np.zeros(0, np.int32)
    rh = np.stack(
        [m.geom_size[g1c, 0], m.geom_size[g1c, 1],
         m.geom_size[g2c, 0], m.geom_size[g2c, 1]], axis=1,
    )
    pcap = np.concatenate([
        np.full(g.ncand, 1.0 if g.kind == "plane_capsule" else 0.0,
                np.float64)
        for g in table.groups
    ]) if table.groups else np.zeros(0, np.float64)
    return EfcLayout(
        con_geom1=g1c,
        con_geom2=g2c,
        con_rh=rh,
        con_cylkind=cylkind,
        con_pcap=pcap,
        # deferral only pays (and is only implemented) on the pooled path
        defer_cyl=bool(defer_cyl and pools is not None and (cylkind > 0).any()),
        friction_dofs=friction_dofs,
        limit_joints=limit_joints,
        ncon=ncon,
        nefc=len(friction_dofs) + len(limit_joints) + 6 * ncon,
        con_body1=b1,
        con_body2=b2,
        con_condim=table.cand_meta("condim"),
        con_friction=table.cand_meta("friction"),
        con_solref=table.cand_meta("solref"),
        con_solimp=table.cand_meta("solimp"),
        con_margin=table.cand_meta("margin"),
        con_includemargin=table.cand_meta("includemargin"),
        con_diagapprox=body_invw[b1, 0] + body_invw[b2, 0],
        max_contacts=max_contacts,
        pools=pools,
    )


@dataclasses.dataclass
class Efc:
    """Assembled constraint system of a batch (leading axis B)."""

    J: torch.Tensor            # (B, nefc, nv)
    aref: torch.Tensor         # (B, nefc)
    R: torch.Tensor            # (B, nefc)
    D: torch.Tensor            # (B, nefc)
    floss: torch.Tensor        # (B, nefc) frictionloss per row (0 others)
    active: torch.Tensor       # (B, nefc) bool
    # contact slot views (B, K, ...)
    con_active: torch.Tensor   # (B, K) bool
    con_dist: torch.Tensor     # (B, K)
    con_pos: torch.Tensor      # (B, K, 3)
    con_frame: torch.Tensor    # (B, K, 3, 3) rows (normal, t1, t2)
    con_mu_tilde: torch.Tensor  # (B, K) mu1 / sqrt(impratio)
    con_scale: torch.Tensor    # (B, K, 6) z -> zeta row scaling
    con_fscale: torch.Tensor   # (B, K, 6) scaled force -> force
    con_dim_mask: torch.Tensor  # (B, K, 6) bool rows enabled by condim
    con_sel: torch.Tensor      # (B, K) candidate index of each slot
    con_body1: torch.Tensor    # (B, K) body ids of the selected slots
    con_body2: torch.Tensor
    con_Rn: torch.Tensor       # (B, K) normal-row regularization
    con_overflow: torch.Tensor  # (B,) i32 active candidates dropped
    # static: row r of the contact block is dim row_dim[r] of slot
    # row_con[r]; None = padded K*6 rows (uniform layout)
    row_con: tuple | None
    row_dim: tuple | None
    pool_dims: tuple | None    # ((K_c, condim_c), ...) or None (uniform)
    nf: int
    nl: int


def _impedance(solimp, x):
    dmin, dmax, width, mid, power = (
        solimp[..., 0], solimp[..., 1], solimp[..., 2], solimp[..., 3],
        solimp[..., 4],
    )
    dmin = torch.clamp(dmin, _MINIMP, _MAXIMP)
    dmax = torch.clamp(dmax, _MINIMP, _MAXIMP)
    x = torch.clamp(x.abs() / torch.clamp(width, min=_MINVAL), 0.0, 1.0)
    # y = a*x^p (x<=mid), 1 - b*(1-x)^p (x>mid)
    a = 1.0 / torch.clamp(mid, min=_MINVAL) ** (power - 1)
    b = 1.0 / torch.clamp(1 - mid, min=_MINVAL) ** (power - 1)
    y = torch.where(x <= mid, a * x**power, 1.0 - b * (1.0 - x) ** power)
    d = dmin + y * (dmax - dmin)
    return torch.clamp(d, _MINIMP, _MAXIMP)


def _kb(solref, solimp):
    dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
    tc, dr = solref[..., 0], solref[..., 1]
    K = 1.0 / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=_MINVAL)
    B = 2.0 / torch.clamp(dmax * tc, min=_MINVAL)
    return K, B


def _packed_const(layout: EfcLayout) -> np.ndarray:
    """Packed per-candidate constant table for the single-gather top-K
    paths (pooled and uniform share it — one column map to maintain):
    [margin | solref(2) | solimp(5) | friction(5) | diagapprox | body1 |
     body2 | condim | includemargin]  (ncand, 18)."""
    tbl = _CONST_CACHE.get(layout)
    if tbl is None:
        tbl = np.concatenate(
            [
                np.asarray(layout.con_margin, np.float64)[:, None],
                np.asarray(layout.con_solref, np.float64),
                np.asarray(layout.con_solimp, np.float64),
                np.asarray(layout.con_friction, np.float64),
                np.asarray(layout.con_diagapprox, np.float64)[:, None],
                np.asarray(layout.con_body1, np.float64)[:, None],
                np.asarray(layout.con_body2, np.float64)[:, None],
                np.asarray(layout.con_condim, np.float64)[:, None],
                np.asarray(layout.con_includemargin, np.float64)[:, None],
                # deferred-cylinder refinement metadata (cols 18-24):
                # geom ids, r1 h1 r2 h2, kind code — rides the same single
                # gather as everything else
                np.asarray(layout.con_geom1, np.float64)[:, None],
                np.asarray(layout.con_geom2, np.float64)[:, None],
                np.asarray(layout.con_rh, np.float64),
                np.asarray(layout.con_cylkind, np.float64)[:, None],
                # deferred-frame metadata (col 25): plane_capsule flag
                np.asarray(layout.con_pcap, np.float64)[:, None],
            ],
            axis=1,
        )
        _CONST_CACHE[layout] = tbl
    return tbl


def _unpack_const(csel):
    """Column map of _packed_const after the slot gather."""
    i64 = torch.int64
    return dict(
        margin=csel[..., 0], solref=csel[..., 1:3], solimp=csel[..., 3:8],
        mu=csel[..., 8:13], diagapprox=csel[..., 13],
        body1=csel[..., 14].to(i64), body2=csel[..., 15].to(i64),
        condim=csel[..., 16].to(i64), includemargin=csel[..., 17],
        geom1=csel[..., 18].to(i64), geom2=csel[..., 19].to(i64),
        rh=csel[..., 20:24], cylkind=csel[..., 24].to(i64),
        pcap=csel[..., 25] > 0.5,
    )


def _compact(act_c, Kc):
    """Stream compaction of one class: the k-th active candidate of each
    env, for k < Kc.  Returns (local index (B, Kc), valid (B, Kc),
    overflow (B,)).  The k-th active index equals the count of entries
    with cumsum <= k, a sorted search: the same integers as the
    reference's compare-and-reduce."""
    cs = torch.cumsum(act_c.to(torch.int64), dim=1)
    ks = torch.arange(Kc, device=cs.device).expand(cs.shape[0], Kc)
    sel = torch.searchsorted(cs, ks.contiguous(), right=True)
    sel = torch.clamp(sel, max=act_c.shape[1] - 1)
    total = cs[:, -1:]
    valid = ks < total
    overflow = torch.clamp(total[:, 0] - Kc, min=0)
    return sel, valid, overflow


def _gather_rows(x, idx):
    """x (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bidx, idx]


def assemble(
    m: PhysicsModel, layout: EfcLayout, table: CollisionTable, kin: Kin,
    qpos: torch.Tensor, qvel: torch.Tensor, terrain=None,
) -> Efc:
    """The constraint rows of a batch at (qpos, qvel); `terrain` (the
    heightfield's params, physics/terrain.py) moves the plane contacts
    onto the local tangent planes."""
    dtype, dev = qvel.dtype, qvel.device
    B = qvel.shape[0]
    impratio = float(m.opt.impratio)
    anc = cached(m, "anc_dof_mask", lambda: ancestor_dof_mask(m), dev, dtype)
    dof_invw, _ = invweights(m)

    def const(name, make):
        return cached(layout, name, make, dev, dtype)

    Js, arefs, Rs, flosses, actives = [], [], [], [], []

    # ---- dof friction rows --------------------------------------------------
    nf = len(layout.friction_dofs)
    if nf:
        fd = layout.friction_dofs

        def jf():
            J = np.zeros((nf, m.nv))
            J[np.arange(nf), fd] = 1.0
            return J

        solref = const("f_solref", lambda: m.dof_solref[fd])
        solimp = const("f_solimp", lambda: m.dof_solimp[fd])
        d = _impedance(solimp, torch.zeros(nf, dtype=dtype, device=dev))
        _K, Bk = _kb(solref, solimp)
        R = torch.clamp((1 - d) / d * const("f_invw", lambda: dof_invw[fd]), min=_MINVAL)
        Js.append(const("f_J", jf).expand(B, nf, m.nv))
        arefs.append(-Bk * qvel[:, index(layout, "f_dof", lambda: fd, dev)])
        Rs.append(R.expand(B, nf))
        flosses.append(const("f_loss", lambda: m.dof_frictionloss[fd]).expand(B, nf))
        actives.append(torch.ones((B, nf), dtype=torch.bool, device=dev))

    # ---- joint limit rows (one per limited hinge; nearest side) -------------
    nl = len(layout.limit_joints)
    if nl:
        lj = layout.limit_joints
        qadr = m.jnt_qposadr[lj]
        dadr = m.jnt_dofadr[lj]
        lo = const("l_lo", lambda: m.jnt_range[lj, 0])
        hi = const("l_hi", lambda: m.jnt_range[lj, 1])
        q = qpos[:, index(layout, "l_qadr", lambda: qadr, dev)]
        dist_lo = q - lo
        dist_hi = hi - q
        lower = dist_lo < dist_hi
        dist = torch.where(lower, dist_lo, dist_hi)
        sign = torch.where(lower, 1.0, -1.0).to(dtype)

        def jl():
            J = np.zeros((nl, m.nv))
            J[np.arange(nl), dadr] = 1.0
            return J

        Jl = const("l_J", jl) * sign[..., None]
        margin = const("l_margin", lambda: m.jnt_margin[lj])
        solref = const("l_solref", lambda: m.jnt_solref[lj])
        solimp = const("l_solimp", lambda: m.jnt_solimp[lj])
        d = _impedance(solimp, dist - margin)
        K, Bk = _kb(solref, solimp)
        qv = qvel[:, index(layout, "l_dadr", lambda: dadr, dev)]
        aref = -Bk * (sign * qv) - K * d * (dist - margin)
        R = torch.clamp((1 - d) / d * const("l_invw", lambda: dof_invw[dadr]), min=_MINVAL)
        Js.append(Jl)
        arefs.append(aref)
        Rs.append(R)
        flosses.append(torch.zeros((B, nl), dtype=dtype, device=dev))
        actives.append(dist < margin)

    # ---- contact rows: narrowphase over every candidate, then top-K ---------
    K0 = layout.max_contacts
    if layout.pools is None and (K0 is None or K0 >= layout.ncon):
        raise NotImplementedError(
            "contact rows without top-K selection (no pools, no "
            "max_contacts) are not ported; the solver kernel needs a "
            "pooled or uniform slot layout"
        )
    dist_all, pos_all, nrm_all = narrowphase(
        m, table, kin, terrain=terrain, defer_cyl=layout.defer_cyl
    )
    incm_all = const("incm", lambda: layout.con_includemargin)
    act_all = dist_all < incm_all
    data = torch.cat([dist_all[..., None], pos_all, nrm_all], dim=-1)
    ctbl = const("packed", lambda: _packed_const(layout))
    if layout.pools is not None:
        # condim row pools: each class compacts its own actives into its
        # own K_c slots; slot condim is then STATIC and the contact block
        # emits only condim_c rows per slot
        sel_l, valid_l, cd_l = [], [], []
        overflow = torch.zeros(B, dtype=torch.int64, device=dev)
        for pi, (cdim, idx, Kc) in enumerate(layout.pools):
            if Kc == 0:
                continue
            idx_t = index(layout, f"pool_idx{pi}", lambda: idx, dev)
            sl, valid, ov = _compact(act_all[:, idx_t], Kc)
            sel_l.append(idx_t[sl])
            valid_l.append(valid)
            overflow = overflow + ov
            cd_l.append(np.full(Kc, cdim, np.int64))
        sel = torch.cat(sel_l, dim=1)
        slot_valid = torch.cat(valid_l, dim=1)
        static_cd = np.concatenate(cd_l)
        pool_dims = tuple((Kc, cdim) for cdim, _i, Kc in layout.pools if Kc)
        condim = index(layout, "static_cd", lambda: static_cd, dev)
    else:
        # uniform top-K slots of 6 rows each
        sel, slot_valid, overflow = _compact(act_all, K0)
        static_cd = None
        pool_dims = None
    K = sel.shape[1]
    dsel = _gather_rows(data, sel)
    c = _unpack_const(ctbl[sel])
    if static_cd is None:
        condim = c["condim"]
    dist, pos = dsel[..., 0], dsel[..., 1:4]
    bidx = torch.arange(B, device=dev)[:, None]
    frame = frame_from_normal(
        dsel[..., 4:7], c["pcap"],
        kin.geom_xmat[bidx, c["geom2"]][..., :, 2],
        kin.geom_xmat[bidx, c["geom1"]][..., :, 0],
    )
    big = torch.full_like(dist, 1e9)
    dist = torch.where(slot_valid, dist, big)

    if layout.defer_cyl:
        # deferred cylinder refinement on the selected slots of the
        # classes that can hold cylinder pairs (Go1: the 12 condim-1
        # slots instead of 247 candidates)
        ck_all = np.asarray(layout.con_cylkind)
        off = 0
        dist_p, pos_p, frame_p = [], [], []
        for _cdim, idx_, Kc_ in layout.pools:
            if Kc_ == 0:
                continue
            rng_ = slice(off, off + Kc_)
            off += Kc_
            d_sl, p_sl, f_sl = dist[:, rng_], pos[:, rng_], frame[:, rng_]
            if (ck_all[idx_] > 0).any():
                ck = c["cylkind"][:, rng_]
                rh = c["rh"][:, rng_]
                dr, pr, nr = refine_cylinder_slots(
                    kin, c["geom1"][:, rng_], c["geom2"][:, rng_],
                    rh[..., 0], rh[..., 1], rh[..., 2], rh[..., 3],
                    ck, d_sl, p_sl, f_sl[..., 0, :],
                )
                f_sl = torch.where((ck > 0)[..., None, None], make_frame(nr), f_sl)
                d_sl = torch.where(slot_valid[:, rng_], dr, big[:, rng_])
                p_sl = pr
            dist_p.append(d_sl)
            pos_p.append(p_sl)
            frame_p.append(f_sl)
        dist = torch.cat(dist_p, 1)
        pos = torch.cat(pos_p, 1)
        frame = torch.cat(frame_p, 1)

    margin, solref, solimp = c["margin"], c["solref"], c["solimp"]
    mu, diagapprox = c["mu"], c["diagapprox"]
    body1, body2 = c["body1"], c["body2"]
    con_active = dist < c["includemargin"]

    # Jacobian rows (normal, t1, t2) translational then rotational:
    # J_row = dir . (velocity of the point / angvel on body2 - body1),
    # in the reference's component-unrolled operation order
    arm = pos - kin.ref[:, None, :]                          # (B, K, 3)
    sgn = anc[body2] - anc[body1]                            # (B, K, nv)
    w3 = kin.cdof[:, None, :, :3]                            # (B, 1, nv, 3)
    v3 = kin.cdof[:, None, :, 3:]
    ax, ay, az = arm[..., 0, None], arm[..., 1, None], arm[..., 2, None]
    jtx = (v3[..., 0] + (w3[..., 1] * az - w3[..., 2] * ay)) * sgn
    jty = (v3[..., 1] + (w3[..., 2] * ax - w3[..., 0] * az)) * sgn
    jtz = (v3[..., 2] + (w3[..., 0] * ay - w3[..., 1] * ax)) * sgn
    jrx, jry, jrz = w3[..., 0] * sgn, w3[..., 1] * sgn, w3[..., 2] * sgn
    rows = []
    for cx, cy, cz in ((jtx, jty, jtz), (jrx, jry, jrz)):
        for i in range(3):
            fx = frame[:, :, i, 0, None]
            fy = frame[:, :, i, 1, None]
            fz = frame[:, :, i, 2, None]
            rows.append(cx * fx + cy * fy + cz * fz)         # (B, K, nv)
    Jc = torch.stack(rows, dim=2)                            # (B, K, 6, nv)

    d_imp = _impedance(solimp, dist - margin)
    Kstiff, Bk = _kb(solref, solimp)
    R0 = torch.clamp((1 - d_imp) / d_imp * diagapprox, min=_MINVAL)
    mu1 = mu[..., 0]
    Rf = R0[..., None] / impratio * (mu1[..., None] / mu) ** 2
    Rcon = torch.cat([R0[..., None], Rf], dim=-1)           # (B, K, 6)

    vel = (Jc @ qvel[:, None, :, None])[..., 0]              # (B, K, 6)
    pos6 = torch.cat(
        [(dist - margin)[..., None], torch.zeros((B, K, 5), dtype=dtype, device=dev)],
        dim=-1,
    )
    aref_con = -Bk[..., None] * vel - (Kstiff * d_imp)[..., None] * pos6
    # inactive slots carry sentinel distances (1e9): zero their aref so no
    # 1e12-scale garbage enters z = J a - aref
    aref_con = torch.where(con_active[..., None], aref_con, torch.zeros_like(aref_con))

    dim_mask = torch.arange(6, device=dev) < condim[..., None]
    dim_mask = dim_mask.expand(B, K, 6)
    sqrt_ir = float(np.sqrt(impratio))
    mu_tilde = mu1 / sqrt_ir
    scale = torch.cat(
        [torch.ones((B, K, 1), dtype=dtype, device=dev),
         (mu / mu1[..., None]) * sqrt_ir],
        dim=-1,
    )

    if static_cd is not None:
        # static per-slot condim: only condim_c rows per slot
        row_con = tuple(int(k) for k in range(K) for _ in range(static_cd[k]))
        row_dim = tuple(int(i) for k in range(K) for i in range(static_cd[k]))
        rc = index(layout, "row_con", lambda: row_con, dev)
        rd = index(layout, "row_dim", lambda: row_dim, dev)
        Js.append(Jc[:, rc, rd])
        arefs.append(aref_con[:, rc, rd])
        Rs.append(Rcon[:, rc, rd])
        flosses.append(torch.zeros((B, len(row_con)), dtype=dtype, device=dev))
        actives.append(con_active[:, rc])
    else:
        row_con = row_dim = None
        Js.append(Jc.reshape(B, K * 6, m.nv))
        arefs.append(aref_con.reshape(B, -1))
        Rs.append(Rcon.reshape(B, -1))
        flosses.append(torch.zeros((B, K * 6), dtype=dtype, device=dev))
        actives.append((con_active[..., None] & dim_mask).reshape(B, -1))

    R_all = torch.cat(Rs, dim=1)
    return Efc(
        J=torch.cat(Js, dim=1),
        aref=torch.cat(arefs, dim=1),
        R=R_all,
        D=1.0 / R_all,
        floss=torch.cat(flosses, dim=1),
        active=torch.cat(actives, dim=1),
        con_active=con_active,
        con_dist=dist,
        con_pos=pos,
        con_frame=frame,
        con_mu_tilde=mu_tilde,
        con_scale=scale,
        con_fscale=scale,
        con_dim_mask=dim_mask,
        con_sel=sel,
        con_body1=body1,
        con_body2=body2,
        con_Rn=R0,
        con_overflow=overflow.to(torch.int32),
        row_con=row_con,
        row_dim=row_dim,
        pool_dims=pool_dims,
        nf=nf,
        nl=nl,
    )
