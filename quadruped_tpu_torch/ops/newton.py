"""Batched Newton constraint solve: the Hopper CUDA kernel and its plain
PyTorch version.

This is the hot op of the physics: 10 substeps x `iterations` Newton
iterations per control step.  It replaces the JAX package's Pallas TPU
kernel (quadruped_tpu/ops/newton.py: _newton_solve_jit -> pl.pallas_call,
body newton_core, gram_mode "vpu").  The kernel source is
csrc/newton.cu; its header says what bounds it and how it is laid out.

`newton_solve` is the entry point.  Its arrays are batch-first float32:
M (B,nv,nv); qacc_smooth, warmstart (B,nv); J (B,ne,nv); aref, D, R,
floss, active (B,ne); con_scale, con_fscale, con_dim_mask (B,K,6);
con_active, con_Rn, con_mu (B,K).  Masks come as 0/1 floats.  It returns
(qacc (B,nv), f (B,ne), qfrc (B,nv)).  On CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs `newton_core_torch`, the same
math in batched PyTorch, which the CPU tests hold against the JAX
package and which the card's smoke run holds the kernel against.

Two contact layouts, as in the reference: uniform slots of 6 rows
(pool_dims None) and condim row pools (pool_dims ((K_p, dim_p), ...)),
each pool contributing K_p slots of dim_p compact rows.
"""

from __future__ import annotations

import ctypes

import torch

from ..physics.math import chol_factor, chol_solve
from ..physics.solver import _LS_ALPHAS
from .build import load

_SHIFT = 1e-3      # Levenberg retry scale (x maxdiag) on a failed Cholesky


def _pool_descs(nf, nl, K, pool_dims):
    """(first row, first slot, K_p, dim_p) per pool, rows counted from the
    first contact row."""
    pools = pool_dims if pool_dims is not None else ((K, 6),)
    descs, row, con = [], 0, 0
    for Kp, dp in pools:
        descs.append((row, con, Kp, dp))
        row += Kp * dp
        con += Kp
    return descs


def _matvec(A, x):
    """(B, r, n) x (B, n) -> (B, r)."""
    return (A @ x[..., None])[..., 0]


def newton_core_torch(
    M, qs, warm, J, aref, D, R, floss, active,
    scale, fscale, maskd, conact, Rn, mu,
    *, nf, nl, iterations, pool_dims=None,
):
    """Plain PyTorch version of the kernel: the reference's newton_core
    (ops/newton.py:200-487) written batch-first, with the same per-pool
    structure, rank-1 cone rows, Cholesky retry, zeroed failed steps,
    NaN-safe ladder argmin and parabolic refinement."""
    B, nv = qs.shape
    dtype, dev = qs.dtype, qs.device
    nfl = nf + nl
    K = scale.shape[1]
    descs = _pool_descs(nf, nl, K, pool_dims)
    nlad = len(_LS_ALPHAS)
    ladder = torch.tensor(list(_LS_ALPHAS) + [0.0], dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye = torch.eye(nv, dtype=dtype, device=dev)

    def cone_u(z, desc):
        """Scaled dual point u and cone zones of one pool; z (B, C, ne)."""
        ro, co, Kp, dp = desc
        zc = z[..., nfl + ro : nfl + ro + Kp * dp].unflatten(-1, (Kp, dp))
        Rn2 = Rn[:, None, co : co + Kp, None]
        mu2 = mu[:, None, co : co + Kp, None]
        mk = maskd[:, None, co : co + Kp, :dp] * conact[:, None, co : co + Kp, None]
        sc = scale[:, None, co : co + Kp, :dp]
        u = -(zc * sc * mk) / Rn2
        u0 = u[..., 0:1]
        ut = u[..., 1:]
        tt = torch.zeros_like(u0)
        for d_ in range(dp - 1):
            tt = tt + ut[..., d_ : d_ + 1] * ut[..., d_ : d_ + 1]
        t = torch.sqrt(tt + 1e-30)
        bottom = t <= mu2 * u0
        top = mu2 * t <= -u0
        return Rn2, mu2, mk, sc, u0, ut, tt, t, bottom, top

    def S_of(z):
        """Total penalty S(z): z (B, C, ne) -> (B, C)."""
        S = torch.zeros(z.shape[:-1], dtype=dtype, device=dev)
        if nf:
            zf = z[..., :nf]
            Df, Rf, fl = D[:, None, :nf], R[:, None, :nf], floss[:, None, :nf]
            quad = (Df * zf).abs() <= fl
            S = S + torch.where(
                quad, 0.5 * Df * zf * zf, fl * zf.abs() - 0.5 * fl * fl * Rf
            ).sum(-1)
        if nl:
            zl, Dl = z[..., nf:nfl], D[:, None, nf:nfl]
            act = (active[:, None, nf:nfl] > 0) & (zl < 0)
            S = S + torch.where(act, 0.5 * Dl * zl * zl, zero).sum(-1)
        for desc in descs:
            Rn2, mu2, _mk, _sc, u0, _ut, tt, t, bottom, top = cone_u(z, desc)
            usq = u0 * u0 + tt
            al = (u0 + mu2 * t) / (1.0 + mu2 * mu2)
            mid_d2 = usq - al * al * (1.0 + mu2 * mu2)
            d2 = torch.where(bottom, zero, torch.where(top, usq, mid_d2))
            S = S + (0.5 * Rn2 * (usq - d2))[..., 0].sum(-1)
        return S

    def penalty_fw(z, want_u):
        """Forces f(z), weights w(z) and the rank-1 cone rows U, wU."""
        zb = z[:, None]
        f_parts, w_parts, U_rows, wU_rows = [], [], [], []
        if nf:
            zf, Df, fl = z[:, :nf], D[:, :nf], floss[:, :nf]
            f_unc = -Df * zf
            quad = f_unc.abs() <= fl
            f_parts.append(torch.clamp(f_unc, -fl, fl))
            w_parts.append(torch.where(quad, Df, zero))
        if nl:
            zl, Dl = z[:, nf:nfl], D[:, nf:nfl]
            act = (active[:, nf:nfl] > 0) & (zl < 0)
            f_parts.append(torch.where(act, -Dl * zl, zero))
            w_parts.append(torch.where(act, Dl, zero))
        for desc in descs:
            ro, co, Kp, dp = desc
            Rn2, mu2, mk, sc, u0, ut, tt, t, bottom, top = (
                x[:, 0] for x in cone_u(zb, desc)
            )
            middle = ~(bottom | top)
            al = (u0 + mu2 * t) / (1.0 + mu2 * mu2)
            phi0 = torch.where(bottom, u0, torch.where(top, zero, al))
            mid_c = mu2 * al / t
            diag_c = torch.where(bottom, torch.ones_like(mid_c), torch.where(top, zero, mid_c))
            fsc = fscale[:, co : co + Kp, :dp]
            cac = conact[:, co : co + Kp, None]
            if dp > 1:
                tdir = ut / t
                phit = torch.where(bottom, ut, torch.where(top, zero, mu2 * al * tdir))
                phi = torch.cat([phi0, phit], dim=-1)
            else:
                phi = phi0
            f_parts.append((phi * fsc * mk).reshape(B, Kp * dp))
            w_con = (diag_c * cac / Rn2) * sc * sc * mk
            w_parts.append(w_con.reshape(B, Kp * dp))
            if want_u and dp > 1:
                Jc = J[:, nfl + ro : nfl + ro + Kp * dp].reshape(B, Kp, dp, nv)
                Sm = sc * mk
                U_e0 = Sm[..., 0:1] * Jc[:, :, 0, :]
                U_n = (Sm[..., 1] * tdir[..., 0])[..., None] * Jc[:, :, 1, :]
                for d_ in range(2, dp):
                    U_n = U_n + (Sm[..., d_] * tdir[..., d_ - 1])[..., None] * Jc[:, :, d_, :]
                U_v = U_e0 + mu2 * U_n
                is_mid = torch.where(middle, 1.0, 0.0).to(dtype) * cac
                wV0 = (is_mid / ((1.0 + mu2 * mu2) * Rn2))[..., 0]
                wVn = (-is_mid * mid_c / Rn2)[..., 0]
                U_rows += [U_v, U_e0, U_n]
                wU_rows += [wV0, wVn, wVn]
        return torch.cat(f_parts, 1), torch.cat(w_parts, 1), U_rows, wU_rows

    a = warm
    for _ in range(iterations):
        z = _matvec(J, a) - aref
        f, w, U_rows, wU_rows = penalty_fw(z, True)
        Mda = _matvec(M, a - qs)
        grad = Mda - _matvec(J.transpose(1, 2), f)
        H = J.transpose(1, 2) @ (w[..., None] * J)
        if U_rows:
            Us = torch.cat(U_rows, 1)
            wU = torch.cat(wU_rows, 1)
            H = H + Us.transpose(1, 2) @ (wU[..., None] * Us)
        H = H + M + 1e-10 * eye
        md = torch.diagonal(H, dim1=-2, dim2=-1).amax(-1)
        L1 = chol_factor(H)
        bad = ~torch.isfinite(L1[:, nv - 1, nv - 1])
        L2 = chol_factor(H + (_SHIFT * md)[:, None, None] * eye)
        L = torch.where(bad[:, None, None], L2, L1)
        delta = -chol_solve(L, grad)
        ok = torch.isfinite(delta).all(-1, keepdim=True)
        delta = torch.where(ok, delta, zero)

        Jd = _matvec(J, delta)
        Md = _matvec(M, delta)
        qa = 0.5 * (delta * Md).sum(-1)
        qb = (delta * Mda).sum(-1)
        S_c = S_of(z[:, None] + ladder[None, :, None] * Jd[:, None])
        pk = ladder * qb[:, None] + (ladder * ladder) * qa[:, None] + S_c
        phis = torch.where(torch.isnan(pk), torch.inf, pk)
        best = torch.argmin(phis, dim=-1)          # first minimum
        best_phi = phis.gather(1, best[:, None])[:, 0]
        a_best = ladder[best]
        il = torch.clamp(best, 1, nlad - 1)
        p_lo = phis.gather(1, (il - 1)[:, None])[:, 0]
        p_mid = phis.gather(1, il[:, None])[:, 0]
        p_hi = phis.gather(1, (il + 1)[:, None])[:, 0]
        a_lo, a_mid, a_hi = ladder[il - 1], ladder[il], ladder[il + 1]
        d_lo = (p_lo - p_mid) / torch.clamp(a_lo - a_mid, min=1e-30)
        d_hi = (p_mid - p_hi) / torch.where(
            (a_mid - a_hi).abs() > 0, a_mid - a_hi, torch.full_like(a_mid, 1e-30)
        )
        curv = (d_lo - d_hi) / torch.clamp(a_lo - a_hi, min=1e-30)
        vertex = 0.5 * (a_lo + a_mid) - 0.5 * d_lo / torch.where(
            curv > 1e-30, curv, torch.full_like(curv, 1e30)
        )
        vertex = torch.clamp(vertex, 0.0, 4.0)
        S_v = S_of((z + vertex[:, None] * Jd)[:, None])[:, 0]
        phi_v = vertex * qb + vertex * vertex * qa + S_v
        alpha = torch.where(phi_v < best_phi, vertex, a_best)
        a = a + alpha[:, None] * delta

    z = _matvec(J, a) - aref
    f, _w, _U, _wU = penalty_fw(z, False)
    return a, f, _matvec(J.transpose(1, 2), f)


def _kernel():
    """The kernel's C entry point, built and loaded at first use."""
    fn = load("newton").newton_solve_f32
    if fn.argtypes is None:
        pi = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = (
            [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
            + [pi, pi, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
               ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


_ARG_NAMES = (
    "M", "qacc_smooth", "warmstart", "J", "aref", "D", "R", "floss",
    "active", "con_scale", "con_fscale", "con_dim_mask", "con_active",
    "con_Rn", "con_mu",
)


def _check(args, nf, nl, pool_dims):
    """Device, dtype, shape and contiguity checks; returns (B, nv, ne, K)."""
    M = args[0]
    dev = M.device
    B, nv = M.shape[0], M.shape[-1]
    ne, K = args[3].shape[1], args[9].shape[1]
    if pool_dims is not None:
        rows = sum(Kp * dp for Kp, dp in pool_dims)
        if sum(Kp for Kp, _dp in pool_dims) != K:
            raise ValueError(f"pool_dims {pool_dims} do not sum to K={K}")
    else:
        rows = 6 * K
    if ne != nf + nl + rows:
        raise ValueError(f"J has {ne} rows; the layout needs {nf + nl + rows}")
    shapes = (
        (B, nv, nv), (B, nv), (B, nv), (B, ne, nv), (B, ne), (B, ne),
        (B, ne), (B, ne), (B, ne), (B, K, 6), (B, K, 6), (B, K, 6), (B, K),
        (B, K), (B, K),
    )
    for name, x, shp in zip(_ARG_NAMES, args, shapes):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(x)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, M on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {x.dtype}")
        if tuple(x.shape) != shp:
            raise ValueError(f"{name}: expected shape {shp}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, nv, ne, K


def newton_solve(
    M, qacc_smooth, warmstart, J, aref, D, R, floss, active,
    con_scale, con_fscale, con_dim_mask, con_active, con_Rn, con_mu,
    *, nf: int, nl: int, iterations: int, pool_dims=None,
):
    """Batched Newton solve (see the module docstring for the shapes).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    args = (M, qacc_smooth, warmstart, J, aref, D, R, floss, active,
            con_scale, con_fscale, con_dim_mask, con_active, con_Rn, con_mu)
    B, nv, ne, K = _check(args, nf, nl, pool_dims)
    if M.device.type == "cpu":
        return newton_core_torch(
            *args, nf=nf, nl=nl, iterations=iterations, pool_dims=pool_dims
        )
    if M.device.type != "cuda":
        raise ValueError(f"newton_solve: unsupported device {M.device}")
    qacc = torch.empty((B, nv), dtype=torch.float32, device=M.device)
    f = torch.empty((B, ne), dtype=torch.float32, device=M.device)
    qfrc = torch.empty((B, nv), dtype=torch.float32, device=M.device)
    if B == 0:
        return qacc, f, qfrc
    fn = _kernel()
    pools = pool_dims if pool_dims is not None else ((K, 6),)
    pool_k = (ctypes.c_int * len(pools))(*[int(Kp) for Kp, _dp in pools])
    pool_dim = (ctypes.c_int * len(pools))(*[int(dp) for _Kp, dp in pools])
    ladder = (ctypes.c_float * len(_LS_ALPHAS))(*_LS_ALPHAS)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = fn(
            *[x.data_ptr() for x in args],
            qacc.data_ptr(), f.data_ptr(), qfrc.data_ptr(),
            B, nv, nf, nl, len(pools), pool_k, pool_dim, iterations, ladder,
            len(_LS_ALPHAS), stream,
        )
    if err != 0:
        raise RuntimeError(f"newton kernel launch failed: cudaError {err}")
    newton_solve.launches += 1
    return qacc, f, qfrc


newton_solve.launches = 0
