"""Primal Newton solver for MuJoCo-style soft constraints, batch-first.

Counterpart of quadruped_tpu/physics/solver.py.  Minimizes over qacc
    Phi(a) = 1/2 ||a - a_smooth||^2_M  +  sum_i s_i(J a - aref)
where s_i(z) = max_{f in K} [ -f z - 1/2 f R f ] per constraint class:
Huber dof-friction rows, one-sided limit rows and elliptic friction cones
(scaled so the cone is circular with mu_tilde = mu1/sqrt(impratio)).

`solve` sends every batch to the Newton op (ops/newton.py: the CUDA
kernel on the card, its plain PyTorch version on the CPU), under the
reference's dispatch rule (solver.py:311-316): pooled or uniform slot
layout, at least one contact slot, float32.  `_penalty` and `_penalty_S`
are the per-row penalty of the reference's single-env path, batched over
the leading axes; the port's tests hold them against it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mjcf.model import PhysicsModel
from .constraint import Efc

# geometric line-search ladder (the 0 candidate is appended by the
# solve): factor-2 spacing from 4 down to ~1e-4, refined by one parabolic
# step around the best candidate.  The defaults of the reference's
# QTPU_LS_RUNGS / QTPU_LS_RATIO (solver.py:40-43): 16 rungs at ratio 0.5.
_LS_ALPHAS = tuple(4.0 * 0.5**k for k in range(16))

_EXPAND_CACHE: dict[tuple, tuple] = {}


def _row_maps(efc: Efc, ncon: int, device):
    """(inverse row index (ncon*6,), dim mask (ncon, 6), row_con, row_dim)
    as tensors on `device`, built once per layout."""
    key = (efc.row_con, efc.row_dim, ncon, str(device))
    if key not in _EXPAND_CACHE:
        inv = np.zeros((ncon, 6), np.int64)
        msk = np.zeros((ncon, 6), bool)
        for r, (c, d) in enumerate(zip(efc.row_con, efc.row_dim)):
            inv[c, d] = r
            msk[c, d] = True
        _EXPAND_CACHE[key] = tuple(
            torch.as_tensor(np.asarray(x), device=device)
            for x in (inv.reshape(-1), msk, efc.row_con, efc.row_dim)
        )
    return _EXPAND_CACHE[key]


def _expand_rows(efc: Efc, zrows: torch.Tensor, ncon: int) -> torch.Tensor:
    """Compact contact rows (..., nrows) -> padded (..., ncon, 6), the
    dims a slot does not have set to zero (a static masked gather)."""
    if efc.row_con is None:
        return zrows.reshape(zrows.shape[:-1] + (ncon, 6))
    idx, mask, _rc, _rd = _row_maps(efc, ncon, zrows.device)
    gathered = zrows[..., idx].reshape(zrows.shape[:-1] + (ncon, 6))
    return torch.where(mask, gathered, torch.zeros_like(gathered))


def _compact_rows(efc: Efc, padded: torch.Tensor, ncon: int) -> torch.Tensor:
    """Padded (..., ncon, 6) -> compact contact rows."""
    if efc.row_con is None:
        return padded.reshape(padded.shape[:-2] + (ncon * 6,))
    _idx, _mask, rc, rd = _row_maps(efc, ncon, padded.device)
    return padded[..., rc, rd]


def _b(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-env metadata (B, ...) aligned with z (B, C..., n): one axis of
    size 1 per extra leading axis of z (line-search candidates)."""
    extra = z.dim() - 2
    return x.reshape(x.shape[:1] + (1,) * extra + x.shape[1:])


def _penalty_S(efc: Efc, z: torch.Tensor) -> torch.Tensor:
    """Total penalty S(z) only, the lean line-search evaluator.  z is
    (B, ..., nefc); returns (B, ...)."""
    dtype = z.dtype
    nf, nl = efc.nf, efc.nl
    ncon = efc.con_dist.shape[-1]
    S = torch.zeros(z.shape[:-1], dtype=dtype, device=z.device)
    if nf:
        zf = z[..., :nf]
        D, R, fl = (_b(x[:, :nf], z) for x in (efc.D, efc.R, efc.floss))
        quad = (D * zf).abs() <= fl
        S = S + torch.sum(
            torch.where(quad, 0.5 * D * zf * zf, fl * zf.abs() - 0.5 * fl * fl * R),
            dim=-1,
        )
    if nl:
        zl = z[..., nf : nf + nl]
        D = _b(efc.D[:, nf : nf + nl], z)
        act = _b(efc.active[:, nf : nf + nl], z) & (zl < 0)
        S = S + torch.sum(torch.where(act, 0.5 * D * zl * zl, torch.zeros_like(zl)), dim=-1)
    if ncon:
        zc = _expand_rows(efc, z[..., nf + nl :], ncon)
        Rn = _b(efc.con_Rn, z)
        cact = _b(efc.con_active, z).to(dtype)
        mask = _b(efc.con_dim_mask, z).to(dtype) * cact[..., None]
        u = -(zc * _b(efc.con_scale, z) * mask) / Rn[..., None]
        u0 = u[..., 0]
        tt = torch.sum(u[..., 1:] * u[..., 1:], dim=-1)
        t = torch.sqrt(tt + 1e-30)
        mu = _b(efc.con_mu_tilde, z)
        bottom = t <= mu * u0
        top = mu * t <= -u0
        usq = u0 * u0 + tt
        alpha = (u0 + mu * t) / (1.0 + mu * mu)
        mid_d2 = usq - alpha * alpha * (1.0 + mu * mu)
        d2 = torch.where(bottom, torch.zeros_like(usq), torch.where(top, usq, mid_d2))
        s_con = 0.5 * Rn * (usq - d2)
        S = S + torch.sum(s_con * cact, dim=-1)
    return S


def _penalty(efc: Efc, z: torch.Tensor, want_hess: bool = False):
    """Per-row force f(z), total penalty S(z), diagonal weights w(z) and,
    with want_hess, the cone Hessian as (V3 (B, ncon, 3, 6), wV (B, ncon,
    3)): three rank-1 directions per contact, so that
        H = M + J^T diag(w) J + sum_c Jc^T S (sum_v wV_v v v^T) S Jc.
    z is (B, nefc)."""
    dtype = z.dtype
    nf, nl = efc.nf, efc.nl
    ncon = efc.con_dist.shape[-1]
    f = torch.zeros_like(z)
    w = torch.zeros_like(z)
    Bh = None
    S = torch.zeros(z.shape[:-1], dtype=dtype, device=z.device)
    zero = torch.zeros((), dtype=dtype, device=z.device)

    if nf:
        zf = z[..., :nf]
        D, R, fl = efc.D[:, :nf], efc.R[:, :nf], efc.floss[:, :nf]
        f_unc = -D * zf
        quad = f_unc.abs() <= fl
        f[..., :nf] = torch.clamp(f_unc, -fl, fl)
        w[..., :nf] = torch.where(quad, D, zero)
        S = S + torch.sum(
            torch.where(quad, 0.5 * D * zf * zf, fl * zf.abs() - 0.5 * fl * fl * R),
            dim=-1,
        )
    if nl:
        sl = slice(nf, nf + nl)
        zl = z[..., sl]
        D = efc.D[:, sl]
        act = efc.active[:, sl] & (zl < 0)
        f[..., sl] = torch.where(act, -D * zl, zero)
        w[..., sl] = torch.where(act, D, zero)
        S = S + torch.sum(torch.where(act, 0.5 * D * zl * zl, zero), dim=-1)
    if ncon:
        zc = _expand_rows(efc, z[..., nf + nl :], ncon)
        Rn = efc.con_Rn
        cact = efc.con_active.to(dtype)
        mask = efc.con_dim_mask.to(dtype) * cact[..., None]
        u = -(zc * efc.con_scale * mask) / Rn[..., None]
        u0 = u[..., 0]
        ut = u[..., 1:]
        t = torch.sqrt(torch.sum(ut * ut, dim=-1) + 1e-30)
        mu = efc.con_mu_tilde
        bottom = t <= mu * u0
        top = mu * t <= -u0
        middle = ~(bottom | top)
        alpha = (u0 + mu * t) / (1.0 + mu * mu)
        phi0 = torch.where(bottom, u0, torch.where(top, zero, alpha))
        tdir = ut / t[..., None]
        phit = torch.where(
            bottom[..., None], ut,
            torch.where(top[..., None], zero, (mu * alpha)[..., None] * tdir),
        )
        phi = torch.cat([phi0[..., None], phit], dim=-1)
        du = u - phi
        s_con = 0.5 * Rn * (torch.sum(u * u, dim=-1) - torch.sum(du * du, dim=-1))
        S = S + torch.sum(s_con * cact, dim=-1)
        f[..., nf + nl :] = _compact_rows(efc, phi * efc.con_fscale * mask, ncon)
        if want_hess:
            mid_c = mu * alpha / t
            diag_c = torch.where(bottom, torch.ones_like(mid_c), torch.where(top, zero, mid_c))
            Sm = efc.con_scale * mask
            w_con = (diag_c * cact / Rn)[..., None] * Sm * Sm
            nhat = torch.cat([torch.zeros_like(tdir[..., :1]), tdir], dim=-1)
            e0 = torch.zeros_like(nhat)
            e0[..., 0] = 1.0
            v = e0 + mu[..., None] * nhat
            V3 = torch.stack([v, e0, nhat], dim=-2) * Sm[..., None, :]
            is_mid = (middle & efc.con_active).to(dtype)
            wV = torch.stack(
                [is_mid / ((1.0 + mu * mu) * Rn), -is_mid * mid_c / Rn,
                 -is_mid * mid_c / Rn],
                dim=-1,
            )
            w[..., nf + nl :] = _compact_rows(efc, w_con, ncon)
            Bh = (V3, wV)
    return f, S, w, Bh


def newton_args(M, qacc_smooth, warmstart, efc: Efc):
    """The Newton op's 15 arrays and its layout arguments for a batch:
    contiguous float32, masks as 0/1 floats (ops/newton.py:newton_solve).
    Only the reference's kernel layouts are taken (solver.py:311-316):
    pooled or uniform slots, at least one slot, float32."""
    ncon = efc.con_dist.shape[-1]
    if not (
        (efc.row_con is None or efc.pool_dims is not None)
        and ncon > 0
        and qacc_smooth.dtype == torch.float32
    ):
        raise NotImplementedError(
            "the Newton op takes float32 pooled or uniform slot layouts "
            "with at least one slot"
        )
    f32 = torch.float32
    B = qacc_smooth.shape[0]
    args = (
        M.contiguous(), qacc_smooth.contiguous(), warmstart.contiguous(),
        efc.J.contiguous(), efc.aref.contiguous(), efc.D.contiguous(),
        efc.R.contiguous(), efc.floss.expand(B, -1).contiguous(),
        efc.active.to(f32), efc.con_scale.contiguous(),
        efc.con_fscale.contiguous(), efc.con_dim_mask.to(f32),
        efc.con_active.to(f32), efc.con_Rn.contiguous(),
        efc.con_mu_tilde.contiguous(),
    )
    return args, dict(nf=efc.nf, nl=efc.nl, pool_dims=efc.pool_dims)


def solve(
    m: PhysicsModel, M: torch.Tensor, qacc_smooth: torch.Tensor, efc: Efc,
    warmstart: torch.Tensor | None = None,
):
    """Newton iterations for a batch; returns (qacc (B, nv),
    qfrc_constraint (B, nv), con_force (B, K, 6))."""
    # imported here: ops.newton reads this module's _LS_ALPHAS at import
    from ..ops.newton import newton_solve

    a0 = qacc_smooth if warmstart is None else warmstart
    args, static = newton_args(M, qacc_smooth, a0, efc)
    qacc, f, qfrc = newton_solve(*args, iterations=m.opt.iterations, **static)
    con_force = _expand_rows(efc, f[:, efc.nf + efc.nl :], efc.con_dist.shape[-1])
    return qacc, qfrc, con_force
