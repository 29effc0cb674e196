"""Static-shape collision detection, batch-first.

Counterpart of quadruped_tpu/physics/collision.py.  The candidate contact
set is fixed when the model is built: every geom pair that can collide
contributes a fixed number of candidates per narrowphase type
(sphere-plane 1, capsule-plane 2, cylinder-plane 4, box-plane 8,
convex-convex 1).  At run time every candidate yields (dist, pos, normal)
for each env, and `dist < includemargin` says whether it is active: no
dynamic shapes.

Pair parameters combine as in MuJoCo: the higher-priority geom wins; on
equal priority condim = max, friction = elementwise max, solref/solimp =
solmix-weighted mean, margin/gap = sum.

This slice runs the flat floor only: plane contacts use the world plane
(the rough-terrain local plane comes with the terrain slice).  Known
deviation kept from the reference: cylinders act as capsules against
non-plane geoms except where refine_cylinder_slots refines them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mjcf.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_PLANE,
    GEOM_SPHERE,
    PhysicsModel,
)
from .consts import cached, index
from .math import cross, norm

_MJMINVAL = 1e-15


@dataclasses.dataclass(eq=False)
class ContactGroup:
    """Candidates of one narrowphase type (static metadata, numpy)."""

    kind: str                 # "plane_sphere", "plane_capsule", ...
    geom1: np.ndarray         # (npair,) int — geom1 is the plane for plane_*
    geom2: np.ndarray
    body1: np.ndarray
    body2: np.ndarray
    cand_per_pair: int

    # combined contact params, one row per pair
    condim: np.ndarray        # (npair,) int
    friction: np.ndarray      # (npair, 5)
    solref: np.ndarray        # (npair, 2)
    solimp: np.ndarray        # (npair, 5)
    margin: np.ndarray        # (npair,)
    includemargin: np.ndarray  # (npair,)

    @property
    def ncand(self) -> int:
        return len(self.geom1) * self.cand_per_pair


@dataclasses.dataclass(eq=False)
class CollisionTable:
    groups: list[ContactGroup]

    @property
    def ncand(self) -> int:
        return sum(g.ncand for g in self.groups)

    def cand_meta(self, field) -> np.ndarray:
        """Per-candidate static metadata, concatenated across groups."""
        out = []
        for g in self.groups:
            v = getattr(g, field)
            out.append(np.repeat(v, g.cand_per_pair, axis=0))
        return np.concatenate(out, axis=0)


def _combine_pair(m: PhysicsModel, g1: int, g2: int) -> dict:
    """MuJoCo contact parameter combination for a geom pair."""
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 != p2:
        w = g1 if p1 > p2 else g2
        condim = int(m.geom_condim[w])
        friction3 = m.geom_friction[w]
        solref = m.geom_solref[w]
        solimp = m.geom_solimp[w]
    else:
        condim = int(max(m.geom_condim[g1], m.geom_condim[g2]))
        friction3 = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
        mix = m.geom_solmix[g1] / max(
            m.geom_solmix[g1] + m.geom_solmix[g2], _MJMINVAL
        )
        solref = mix * m.geom_solref[g1] + (1 - mix) * m.geom_solref[g2]
        solimp = mix * m.geom_solimp[g1] + (1 - mix) * m.geom_solimp[g2]
    margin = float(m.geom_margin[g1] + m.geom_margin[g2])
    gap = float(m.geom_gap[g1] + m.geom_gap[g2])
    friction5 = np.array(
        [friction3[0], friction3[0], friction3[1], friction3[2], friction3[2]]
    )
    return dict(
        condim=condim,
        friction=friction5,
        solref=solref,
        solimp=solimp,
        margin=margin,
        includemargin=margin - gap,
    )


def _collide_mask(m: PhysicsModel, g1: int, g2: int) -> bool:
    b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
    if b1 == b2:
        return False
    # parent-child exclusion (unless parent is world)
    if m.body_parentid[b2] == b1 and b1 != 0:
        return False
    if m.body_parentid[b1] == b2 and b2 != 0:
        return False
    t1 = int(m.geom_contype[g1]) & int(m.geom_conaffinity[g2])
    t2 = int(m.geom_contype[g2]) & int(m.geom_conaffinity[g1])
    return bool(t1 or t2)


_CAND_PER_KIND = {
    "plane_sphere": 1,
    "plane_capsule": 2,
    "plane_cylinder": 4,
    "plane_box": 8,
    "sphere_sphere": 1,
    "sphere_capsule": 1,
    "sphere_cylinder": 1,
    "capsule_capsule": 1,
    "capsule_cylinder": 1,
    "cylinder_cylinder": 1,
    "sphere_box": 1,
    "capsule_box": 2,
}


def build_table(m: PhysicsModel, mode: str = "plane") -> CollisionTable:
    """Build the static candidate table.

    mode="plane": only geom-vs-plane pairs (flat-terrain quadruped training;
    matches every contact the reference rewards observe on flat ground).
    mode="full": adds robot self-collision pairs (biped mode needs these for
    the self_collision / unwanted_contact costs, go1_mujoco_env.py:269-312).
    """
    planes = [i for i in range(m.ngeom) if m.geom_type[i] == GEOM_PLANE]
    others = [i for i in range(m.ngeom) if m.geom_type[i] != GEOM_PLANE]

    def kind_of(t1, t2):
        names = {
            GEOM_SPHERE: "sphere",
            GEOM_CAPSULE: "capsule",
            GEOM_CYLINDER: "cylinder",
            GEOM_BOX: "box",
        }
        return names[t1], names[t2]

    buckets: dict[str, list] = {}

    def add(kind, g1, g2):
        buckets.setdefault(kind, []).append((g1, g2))

    for p in planes:
        for g in others:
            if not _collide_mask(m, p, g):
                continue
            tname = kind_of(m.geom_type[g], m.geom_type[g])[0]
            add(f"plane_{tname}", p, g)

    if mode == "full":
        order = {
            GEOM_SPHERE: 0, GEOM_CAPSULE: 1, GEOM_CYLINDER: 2, GEOM_BOX: 3,
        }
        for i, ga in enumerate(others):
            for gb in others[i + 1 :]:
                if not _collide_mask(m, ga, gb):
                    continue
                p1, p2 = ga, gb
                t1, t2 = int(m.geom_type[p1]), int(m.geom_type[p2])
                if order[t1] > order[t2]:
                    p1, p2, t1, t2 = p2, p1, t2, t1
                if t1 == GEOM_SPHERE and t2 == GEOM_CYLINDER:
                    kind = "sphere_cylinder"  # exact narrowphase
                elif t1 == GEOM_CAPSULE and t2 == GEOM_CYLINDER:
                    kind = "capsule_cylinder"  # separation-exact hybrid
                elif t1 == GEOM_CYLINDER and t2 == GEOM_CYLINDER:
                    kind = "cylinder_cylinder"
                else:
                    # remaining cylinder pairs approximated as capsules
                    # (MuJoCo uses MPR there; documented deviation)
                    u1 = GEOM_CAPSULE if t1 == GEOM_CYLINDER else t1
                    u2 = GEOM_CAPSULE if t2 == GEOM_CYLINDER else t2
                    if order[u1] > order[u2]:
                        p1, p2, u1, u2 = p2, p1, u2, u1
                    n1, n2 = kind_of(u1, u2)
                    kind = f"{n1}_{n2}"
                if kind == "box_box":
                    continue  # no box-box pairs on the Go1
                add(kind, p1, p2)

    groups = []
    for kind, pairs in sorted(buckets.items()):
        meta = [_combine_pair(m, g1, g2) for g1, g2 in pairs]
        groups.append(
            ContactGroup(
                kind=kind,
                geom1=np.array([p[0] for p in pairs], dtype=np.int32),
                geom2=np.array([p[1] for p in pairs], dtype=np.int32),
                body1=m.geom_bodyid[[p[0] for p in pairs]].copy(),
                body2=m.geom_bodyid[[p[1] for p in pairs]].copy(),
                cand_per_pair=_CAND_PER_KIND[kind],
                condim=np.array([d["condim"] for d in meta], dtype=np.int32),
                friction=np.stack([d["friction"] for d in meta]),
                solref=np.stack([d["solref"] for d in meta]),
                solimp=np.stack([d["solimp"] for d in meta]),
                margin=np.array([d["margin"] for d in meta]),
                includemargin=np.array([d["includemargin"] for d in meta]),
            )
        )
    return CollisionTable(groups=groups)




# ---------------------------------------------------------------------------
# Narrowphase: each routine returns (dist, pos, normal) of shapes
# (B, npair, c), (B, npair, c, 3), (B, npair, c, 3) for c candidates per
# pair; the normal points from geom1 into geom2 (MuJoCo convention) and
# pos is the midpoint between the surfaces.  Per-pair sizes are (npair,)
# tensors that broadcast against the batch.
# ---------------------------------------------------------------------------


def _sum3(a, b):
    return torch.sum(a * b, dim=-1)


def _plane_sphere(n, ppos, center, r):
    dist = _sum3(n, center - ppos) - r
    pos = center - n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(n, ppos, xpos, xmat, r, half):
    axis = xmat[..., :, 2]
    ends = torch.stack(
        [xpos + half[..., None] * axis, xpos - half[..., None] * axis], dim=-2
    )
    dist = _sum3(n[..., None, :], ends - ppos[..., None, :]) - r[..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    return dist, pos, n[..., None, :].expand_as(pos)


def _plane_cylinder(n, ppos, xpos, xmat, r, half):
    """MuJoCo-exact plane-cylinder: the deepest rim point of the near
    disc, the matching rim point of the far disc, and the two near-disc
    rim points rotated +-120 deg about the axis (reference
    collision._plane_cylinder, which documents the oracle checks)."""
    axis = xmat[..., :, 2]
    prj = _sum3(n, axis)[..., None]
    # snap near-zero projections to exactly zero: a side-lying cylinder
    # keeps MuJoCo's unflipped axis
    prj = torch.where(prj.abs() < 1e-6, torch.zeros_like(prj), prj)
    flip = prj > 0
    axis = torch.where(flip, -axis, axis)
    prj = torch.where(flip, -prj, prj)
    d = axis * prj - n
    dn = norm(d, keepdim=True)
    d = torch.where(dn < 1e-10, xmat[..., :, 0], d / torch.clamp(dn, min=1e-12))
    vec = r[..., None] * d
    axv = cross(axis, vec)
    s3 = float(np.float32(np.sqrt(3.0)) * np.float32(0.5))
    vec_p = -0.5 * vec + s3 * axv
    vec_m = -0.5 * vec - s3 * axv
    ax_h = half[..., None] * axis
    pts = torch.stack(
        [xpos + ax_h + vec, xpos - ax_h + vec, xpos + ax_h + vec_p,
         xpos + ax_h + vec_m],
        dim=-2,
    )
    dist = _sum3(n[..., None, :], pts - ppos[..., None, :])
    pos = pts - n[..., None, :] * (0.5 * dist)[..., None]
    return dist, pos, n[..., None, :].expand_as(pos)


_BOX_CORNERS = np.asarray(
    [[(-1, 1)[(i >> 0) & 1], (-1, 1)[(i >> 1) & 1], (-1, 1)[(i >> 2) & 1]]
     for i in range(8)],
    np.float64,
)  # (8, 3), MuJoCo corner order


def _plane_box(n, ppos, xpos, xmat, cs):
    """MuJoCo-exact plane-box: corners on the lower half of the box along
    the normal (ldist <= 0), the first 4 of them in MuJoCo's enumeration
    order; the others are poisoned with dist 1e10.  cs (npair, 8, 3): the
    signed corner offsets, _BOX_CORNERS * size."""
    rel = torch.einsum("...ij,...cj->...ci", xmat, cs)
    pts = xpos[..., None, :] + rel
    ldist = _sum3(n[..., None, :], rel)
    dist = _sum3(n[..., None, :], pts - ppos[..., None, :])
    lower = ldist <= 0
    rank = torch.cumsum(lower.to(torch.int32), dim=-1) - 1
    keep = lower & (rank < 4)
    dist = torch.where(keep, dist, torch.full_like(dist, 1e10))
    pos = pts - n[..., None, :] * (0.5 * dist)[..., None]
    pos = torch.where(keep[..., None], pos, pts)
    return dist, pos, n[..., None, :].expand_as(pos)


def _sphere_sphere(p1, r1, p2, r2):
    d = p2 - p1
    dn = norm(d)
    n = d / torch.clamp(dn, min=1e-12)[..., None]
    dist = dn - (r1 + r2)
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _closest_on_segment(a_pos, a_axis, a_half, p):
    t = _sum3(p - a_pos, a_axis)
    t = torch.clamp(t, -a_half, a_half)
    return a_pos + t[..., None] * a_axis


def _sphere_capsule(pc, r1, cpos, cmat, r2, half):
    q = _closest_on_segment(cpos, cmat[..., :, 2], half, pc)
    return _sphere_sphere(pc, r1, q, r2)


def _capsule_capsule(p1, m1, r1, h1, p2, m2, r2, h2):
    """Capsule-capsule in the reference's component-unrolled form
    (collision._capsule_capsule_soa): clamped segment-segment closest
    points, then sphere-sphere."""
    p1x, p1y, p1z = p1[..., 0], p1[..., 1], p1[..., 2]
    p2x, p2y, p2z = p2[..., 0], p2[..., 1], p2[..., 2]
    a1x, a1y, a1z = m1[..., 0, 2], m1[..., 1, 2], m1[..., 2, 2]
    a2x, a2y, a2z = m2[..., 0, 2], m2[..., 1, 2], m2[..., 2, 2]
    rx, ry, rz = p1x - p2x, p1y - p2y, p1z - p2z
    A = a1x * a1x + a1y * a1y + a1z * a1z
    Bc = a1x * a2x + a1y * a2y + a1z * a2z
    C = a2x * a2x + a2y * a2y + a2z * a2z
    D = a1x * rx + a1y * ry + a1z * rz
    E = a2x * rx + a2y * ry + a2z * rz
    den = A * C - Bc * Bc
    s = torch.where(
        den > 1e-12, (Bc * E - C * D) / torch.clamp(den, min=1e-12),
        torch.zeros_like(den),
    )
    s = torch.clamp(s, -h1, h1)
    t = torch.clamp((Bc * s + E) / torch.clamp(C, min=1e-12), -h2, h2)
    s = torch.clamp((Bc * t - D) / torch.clamp(A, min=1e-12), -h1, h1)
    q1x, q1y, q1z = p1x + s * a1x, p1y + s * a1y, p1z + s * a1z
    q2x, q2y, q2z = p2x + t * a2x, p2y + t * a2y, p2z + t * a2z
    dx, dy, dz = q2x - q1x, q2y - q1y, q2z - q1z
    dn = torch.sqrt(dx * dx + dy * dy + dz * dz)
    mn = torch.clamp(dn, min=1e-12)
    nx, ny, nz = dx / mn, dy / mn, dz / mn
    dist = dn - (r1 + r2)
    adv = r1 + 0.5 * dist
    pos = torch.stack([q1x + nx * adv, q1y + ny * adv, q1z + nz * adv], dim=-1)
    nn = torch.stack([nx, ny, nz], dim=-1)
    return dist[..., None], pos[..., None, :], nn[..., None, :]


def _proj_solid_cylinder(x, cpos, cmat, r, h):
    """Euclidean projection of x onto a solid cylinder."""
    axis = cmat[..., :, 2]
    rel = x - cpos
    z = _sum3(rel, axis)
    rad = rel - z[..., None] * axis
    rho = norm(rad)
    zc = torch.clamp(z, -h, h)
    raddir = rad / torch.clamp(rho, min=1e-12)[..., None]
    rhoc = torch.minimum(rho, r)
    return cpos + zc[..., None] * axis + rhoc[..., None] * raddir


def _proj_solid_capsule(x, cpos, cmat, r, h):
    s = _closest_on_segment(cpos, cmat[..., :, 2], h, x)
    d = x - s
    dn = norm(d)
    surf = s + d * (r / torch.clamp(dn, min=1e-12))[..., None]
    return torch.where((dn > r)[..., None], surf, x)


def _closest_on_box(bpos, bmat, size, p):
    local = torch.einsum("...ji,...j->...i", bmat, p - bpos)
    clamped = torch.clamp(local, -size, size)
    return bpos + torch.einsum("...ij,...j->...i", bmat, clamped)


def _sphere_cylinder(pc, rs, cpos, cmat, rc, half):
    """MuJoCo-exact sphere vs solid cylinder: closest point on the solid,
    or the least-penetrated face when the centre is inside."""
    axis = cmat[..., :, 2]
    rel = pc - cpos
    z = _sum3(rel, axis)
    radial = rel - z[..., None] * axis
    rho = norm(radial)
    rad_dir = torch.where(
        (rho > 1e-12)[..., None],
        radial / torch.clamp(rho, min=1e-12)[..., None],
        -cmat[..., :, 0],
    )
    inside = (z.abs() < half) & (rho < rc)
    zc = torch.clamp(z, -half, half)
    q = cpos + zc[..., None] * axis + torch.minimum(rho, rc)[..., None] * rad_dir
    dvec = q - pc
    dn = norm(dvec)
    dist_out = dn - rs
    n_out = dvec / torch.clamp(dn, min=1e-12)[..., None]
    d_side = rho - rc
    d_cap = z.abs() - half
    sign_z = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
    n_in = torch.where(
        (d_side >= d_cap)[..., None], -rad_dir, -sign_z[..., None] * axis
    )
    dist_in = torch.maximum(d_side, d_cap) - rs
    dist = torch.where(inside, dist_in, dist_out)
    n = torch.where(inside[..., None], n_in, n_out)
    pos = pc + n * (rs + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_box(pc, r, bpos, bmat, size):
    q = _closest_on_box(bpos, bmat, size, pc)
    d = q - pc
    dn = norm(d)
    n = d / torch.clamp(dn, min=1e-12)[..., None]
    dist = dn - r
    pos = pc + n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_box(cpos, cmat, r, half, bpos, bmat, size):
    axis = cmat[..., :, 2]
    out_d, out_p, out_n = [], [], []
    for sgn in (1.0, -1.0):
        end = cpos + sgn * half[..., None] * axis
        q = _closest_on_box(bpos, bmat, size, end)
        s = _closest_on_segment(cpos, axis, half, q)
        q = _closest_on_box(bpos, bmat, size, s)
        d = q - s
        dn = norm(d)
        n = d / torch.clamp(dn, min=1e-12)[..., None]
        dist = dn - r
        out_d.append(dist)
        out_p.append(s + n * (r + 0.5 * dist)[..., None])
        out_n.append(n)
    return (
        torch.stack(out_d, dim=-1),
        torch.stack(out_p, dim=-2),
        torch.stack(out_n, dim=-2),
    )


def narrowphase(m: PhysicsModel, table: CollisionTable, kin,
                defer_cyl: bool = False):
    """All groups for a batch; returns per-candidate (dist (B, ncand),
    pos (B, ncand, 3), normal (B, ncand, 3)) in table order.

    This is the reference's frames="normal" mode, the one its top-K
    paths use: contact frames are built afterwards for the selected slots
    only (frame_from_normal).

    defer_cyl: return the capsule-capsule approximation for
    capsule_cylinder/cylinder_cylinder pairs and leave the refinement to
    the caller (refine_cylinder_slots on the selected slots).  Sound
    because the capsule encloses the cylinder, so the approximation
    never misses a true contact; see the reference's docstring for the
    pool-saturation caveat, which holds here unchanged."""
    gx, gm = kin.geom_xpos, kin.geom_xmat
    dtype, dev = gx.dtype, gx.device
    size = cached(m, "geom_size", lambda: m.geom_size, dev, dtype)

    dists, poss, normals = [], [], []
    for gi, g in enumerate(table.groups):
        i1 = index(table, f"g{gi}_geom1", lambda: g.geom1, dev)
        i2 = index(table, f"g{gi}_geom2", lambda: g.geom2, dev)
        s1, s2 = size[i1], size[i2]
        if g.kind.startswith("plane_"):
            n, pp = gm[:, i1][..., :, 2], gx[:, i1]
        if g.kind == "plane_sphere":
            d, p, nn = _plane_sphere(n, pp, gx[:, i2], s2[:, 0])
        elif g.kind == "plane_capsule":
            d, p, nn = _plane_capsule(n, pp, gx[:, i2], gm[:, i2], s2[:, 0], s2[:, 1])
        elif g.kind == "plane_cylinder":
            d, p, nn = _plane_cylinder(n, pp, gx[:, i2], gm[:, i2], s2[:, 0], s2[:, 1])
        elif g.kind == "plane_box":
            cs = cached(
                table, f"g{gi}_corners",
                lambda: _BOX_CORNERS[None] * m.geom_size[g.geom2][:, None, :],
                dev, dtype,
            )
            d, p, nn = _plane_box(n, pp, gx[:, i2], gm[:, i2], cs)
        elif g.kind == "sphere_sphere":
            d, p, nn = _sphere_sphere(gx[:, i1], s1[:, 0], gx[:, i2], s2[:, 0])
        elif g.kind == "sphere_capsule":
            d, p, nn = _sphere_capsule(
                gx[:, i1], s1[:, 0], gx[:, i2], gm[:, i2], s2[:, 0], s2[:, 1]
            )
        elif g.kind == "sphere_cylinder":
            d, p, nn = _sphere_cylinder(
                gx[:, i1], s1[:, 0], gx[:, i2], gm[:, i2], s2[:, 0], s2[:, 1]
            )
        elif g.kind in ("capsule_capsule", "capsule_cylinder",
                        "cylinder_cylinder"):
            d, p, nn = _capsule_capsule(
                gx[:, i1], gm[:, i1], s1[:, 0], s1[:, 1],
                gx[:, i2], gm[:, i2], s2[:, 0], s2[:, 1],
            )
            if g.kind != "capsule_capsule" and not defer_cyl:
                kind = CYLKIND_CAPCYL if g.kind == "capsule_cylinder" else CYLKIND_CYLCYL
                d0, p0, n0 = d[..., 0], p[..., 0, :], nn[..., 0, :]
                d, p, nn = _cylinder_refine(
                    gx[:, i1], gm[:, i1], gx[:, i2], gm[:, i2],
                    s1[:, 0], s1[:, 1], s2[:, 0], s2[:, 1],
                    kind == CYLKIND_CAPCYL, d0, p0, n0,
                )
                d, p, nn = d[..., None], p[..., None, :], nn[..., None, :]
        elif g.kind == "sphere_box":
            d, p, nn = _sphere_box(gx[:, i1], s1[:, 0], gx[:, i2], gm[:, i2], s2)
        elif g.kind == "capsule_box":
            d, p, nn = _capsule_box(
                gx[:, i1], gm[:, i1], s1[:, 0], s1[:, 1],
                gx[:, i2], gm[:, i2], s2,
            )
        else:
            raise NotImplementedError(g.kind)
        B = d.shape[0]
        dists.append(d.reshape(B, -1))
        poss.append(p.reshape(B, -1, 3))
        normals.append(nn.reshape(B, -1, 3))
    return torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(normals, 1)


def make_frame(n: torch.Tensor) -> torch.Tensor:
    """Right-handed frames with rows (n, t1, t2) as mju_makeFrame: helper
    axis a = y-hat if |n_y| < 0.5 else z-hat; t2 = normalize(n x a);
    t1 = t2 x n."""
    y = torch.zeros_like(n)
    y[..., 1] = 1.0
    z = torch.zeros_like(n)
    z[..., 2] = 1.0
    a = torch.where((n[..., 1].abs() < 0.5)[..., None], y, z)
    t2 = cross(n, a)
    t2 = t2 / torch.clamp(norm(t2, keepdim=True), min=1e-12)
    t1 = cross(t2, n)
    return torch.stack([n, t1, t2], dim=-2)


def frame_from_normal(nn, pcap, axis, px):
    """Full (..., K, 3, 3) contact frames from slot normals, built after
    top-K selection.  pcap marks plane_capsule slots, whose frame uses
    the capsule axis projected into the plane (axis = geom2 xmat
    z-column, px = geom1 xmat x-column fallback)."""
    base = make_frame(nn)
    proj = axis - _sum3(axis, nn)[..., None] * nn
    pn = norm(proj, keepdim=True)
    t1 = torch.where(pn > 1e-8, proj / torch.clamp(pn, min=1e-12), px)
    t2 = cross(nn, t1)
    special = torch.stack([nn, t1, t2], dim=-2)
    return torch.where(pcap[..., None, None], special, base)


# deferred-refinement kind codes (constraint.EfcLayout.con_cylkind)
CYLKIND_NONE, CYLKIND_CAPCYL, CYLKIND_CYLCYL = 0, 1, 2


def _cylinder_refine(p1, R1, p2, R2, r1, h1, r2, h2, is_capcyl,
                     dist0, pos0, n0, iters: int = 10):
    """Capsule-capsule base contact refined by alternating projections
    between the true solids, so that SEPARATION is exact (reference
    collision._cylinder_hybrid).  is_capcyl: geom1 is a capsule (bool or
    bool tensor); geom2 is always the cylinder."""
    q = p1
    q2 = p2
    isc = torch.as_tensor(is_capcyl, device=p1.device)[..., None]
    for _ in range(iters):
        q2 = _proj_solid_cylinder(q, p2, R2, r2, h2)
        q = torch.where(
            isc,
            _proj_solid_capsule(q2, p1, R1, r1, h1),
            _proj_solid_cylinder(q2, p1, R1, r1, h1),
        )
    gap_vec = q2 - q
    gap = norm(gap_vec)
    separated = gap > 1e-7
    n_ref = torch.where(
        separated[..., None], gap_vec / torch.clamp(gap, min=1e-12)[..., None], n0
    )
    pos_ref = torch.where(separated[..., None], 0.5 * (q + q2), pos0)
    dist_ref = torch.where(separated, gap, dist0)
    return dist_ref, pos_ref, n_ref


def refine_cylinder_slots(kin, g1, g2, r1, h1, r2, h2, kindflag,
                          dist0, pos0, n0, iters: int = 10):
    """Slot-level deferred cylinder refinement: the _cylinder_refine math
    applied after top-K selection.  g1/g2 (B, K) per-slot geom indices,
    r/h the gathered sizes, kindflag 0/1/2 = none/capsule_cylinder/
    cylinder_cylinder; slots of kind 0 pass through untouched."""
    bidx = torch.arange(g1.shape[0], device=g1.device)[:, None]
    p1, R1 = kin.geom_xpos[bidx, g1], kin.geom_xmat[bidx, g1]
    p2, R2 = kin.geom_xpos[bidx, g2], kin.geom_xmat[bidx, g2]
    d, p, n = _cylinder_refine(
        p1, R1, p2, R2, r1, h1, r2, h2, kindflag == CYLKIND_CAPCYL,
        dist0, pos0, n0, iters,
    )
    apply = kindflag > 0
    return (
        torch.where(apply, d, dist0),
        torch.where(apply[..., None], p, pos0),
        torch.where(apply[..., None], n, n0),
    )
