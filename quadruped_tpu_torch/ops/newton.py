"""Batched Newton constraint solve: the Hopper CUDA kernel and its plain
PyTorch version.

This is the hot op of the physics: 10 substeps x `iterations` Newton
iterations per control step.  It replaces the JAX package's Pallas TPU
kernel (quadruped_tpu/ops/newton.py: _newton_solve_jit -> pl.pallas_call,
body newton_core) in both of its Gram modes: "vpu" (H on the CUDA cores)
and "mxu" (H on the tensor cores, FP64 mma.sync), selected by
`gram_mode` or, as in the reference, by QTPU_GRAM.  The kernel source is
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

The kernel is instantiated for nv = 18 only (KERNEL_NV); a launch at
another width raises ValueError before anything is built.  Beside the
solve, three entries off the main path: `gram` (the first iteration's H
alone), `newton_profile` (the solve with per-phase cycle stamps) and
`kernel_resources` (the kernel's launch plan, registers, spills and
resident envs per SM).
"""

from __future__ import annotations

import ctypes
import os

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


class Penalty:
    """The penalty of a batch's constraint rows at z: the total S(z) and
    the forces f(z), Hessian weights w(z) and rank-1 cone rows U, wU.

    The plain version's counterpart of the reference kernel's closures
    cone_u / S_of / penalty_fw (quadruped_tpu/ops/newton.py:226-340),
    per condim pool.  tests/test_torch_physics.py holds it against the
    reference's single-env physics/solver._penalty and _penalty_S."""

    def __init__(self, J, D, R, floss, active, scale, fscale, maskd, conact,
                 Rn, mu, *, nf, nl, pool_dims=None):
        self.J, self.D, self.R, self.floss, self.active = J, D, R, floss, active
        self.scale, self.fscale, self.maskd = scale, fscale, maskd
        self.conact, self.Rn, self.mu = conact, Rn, mu
        self.nf, self.nl = nf, nl
        self.descs = _pool_descs(nf, nl, scale.shape[1], pool_dims)
        self.zero = torch.zeros((), dtype=J.dtype, device=J.device)

    def _cone_u(self, z, desc):
        """Scaled dual point u and cone zones of one pool; z (B, C, ne)."""
        ro, co, Kp, dp = desc
        nfl = self.nf + self.nl
        zc = z[..., nfl + ro : nfl + ro + Kp * dp].unflatten(-1, (Kp, dp))
        Rn2 = self.Rn[:, None, co : co + Kp, None]
        mu2 = self.mu[:, None, co : co + Kp, None]
        mk = (self.maskd[:, None, co : co + Kp, :dp]
              * self.conact[:, None, co : co + Kp, None])
        sc = self.scale[:, None, co : co + Kp, :dp]
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

    def S(self, z):
        """Total penalty S(z): z (B, C, ne) -> (B, C)."""
        nf, nl, zero = self.nf, self.nl, self.zero
        nfl = nf + nl
        S = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        if nf:
            zf = z[..., :nf]
            Df, Rf, fl = (x[:, None, :nf] for x in (self.D, self.R, self.floss))
            quad = (Df * zf).abs() <= fl
            S = S + torch.where(
                quad, 0.5 * Df * zf * zf, fl * zf.abs() - 0.5 * fl * fl * Rf
            ).sum(-1)
        if nl:
            zl, Dl = z[..., nf:nfl], self.D[:, None, nf:nfl]
            act = (self.active[:, None, nf:nfl] > 0) & (zl < 0)
            S = S + torch.where(act, 0.5 * Dl * zl * zl, zero).sum(-1)
        for desc in self.descs:
            Rn2, mu2, _mk, _sc, u0, _ut, tt, t, bottom, top = self._cone_u(z, desc)
            usq = u0 * u0 + tt
            al = (u0 + mu2 * t) / (1.0 + mu2 * mu2)
            mid_d2 = usq - al * al * (1.0 + mu2 * mu2)
            d2 = torch.where(bottom, zero, torch.where(top, usq, mid_d2))
            S = S + (0.5 * Rn2 * (usq - d2))[..., 0].sum(-1)
        return S

    def fw(self, z, want_u):
        """Forces f(z) (B, ne), weights w(z) (B, ne) and, with want_u, the
        rank-1 cone rows of the friction pools, U (B, nu, nv) and wU (B,
        nu) with nu = 3 sum K_p over pools with dim_p > 1, per pool the
        blocks U_v, U_e0, U_n of K_p rows each (the kernel's row order);
        U and wU are None without want_u."""
        nf, nl, zero, J = self.nf, self.nl, self.zero, self.J
        B, nv = J.shape[0], J.shape[-1]
        nfl = nf + nl
        zb = z[:, None]
        f_parts, w_parts, U_rows, wU_rows = [], [], [], []
        if nf:
            zf, Df, fl = z[:, :nf], self.D[:, :nf], self.floss[:, :nf]
            f_unc = -Df * zf
            quad = f_unc.abs() <= fl
            f_parts.append(torch.clamp(f_unc, -fl, fl))
            w_parts.append(torch.where(quad, Df, zero))
        if nl:
            zl, Dl = z[:, nf:nfl], self.D[:, nf:nfl]
            act = (self.active[:, nf:nfl] > 0) & (zl < 0)
            f_parts.append(torch.where(act, -Dl * zl, zero))
            w_parts.append(torch.where(act, Dl, zero))
        for desc in self.descs:
            ro, co, Kp, dp = desc
            Rn2, mu2, mk, sc, u0, ut, tt, t, bottom, top = (
                x[:, 0] for x in self._cone_u(zb, desc)
            )
            middle = ~(bottom | top)
            al = (u0 + mu2 * t) / (1.0 + mu2 * mu2)
            phi0 = torch.where(bottom, u0, torch.where(top, zero, al))
            mid_c = mu2 * al / t
            diag_c = torch.where(bottom, torch.ones_like(mid_c), torch.where(top, zero, mid_c))
            fsc = self.fscale[:, co : co + Kp, :dp]
            cac = self.conact[:, co : co + Kp, None]
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
                is_mid = torch.where(middle, 1.0, 0.0).to(z.dtype) * cac
                wV0 = (is_mid / ((1.0 + mu2 * mu2) * Rn2))[..., 0]
                wVn = (-is_mid * mid_c / Rn2)[..., 0]
                U_rows += [U_v, U_e0, U_n]
                wU_rows += [wV0, wVn, wVn]
        f, w = torch.cat(f_parts, 1), torch.cat(w_parts, 1)
        if not want_u:
            return f, w, None, None
        if not U_rows:
            return f, w, J.new_zeros((B, 0, nv)), J.new_zeros((B, 0))
        return f, w, torch.cat(U_rows, 1), torch.cat(wU_rows, 1)

def gram_torch(J, w, U, wU, M, acc_dtype=None):
    """H = M + J^T diag(w) J + U^T diag(wU) U + 1e-10 I for a batch: J (B,
    ne, nv), w (B, ne), U (B, nu, nv), wU (B, nu), M (B, nv, nv).  The
    plain version of the kernel's Gram in both modes (the reference
    forms the same H on the VPU, or its J-part on the MXU).  The Gram
    part is summed in `acc_dtype` (default: the inputs' dtype) and
    rounded to it once before M is added; float64 is the mxu kernel's
    arithmetic."""
    nv = J.shape[-1]
    acc = (lambda x: x) if acc_dtype is None else (lambda x: x.to(acc_dtype))
    G = acc(J).transpose(1, 2) @ (acc(w)[..., None] * acc(J))
    if U.shape[1]:
        G = G + acc(U).transpose(1, 2) @ (acc(wU)[..., None] * acc(U))
    return (G.to(J.dtype) + M) + 1e-10 * torch.eye(nv, dtype=J.dtype, device=J.device)


def newton_core_torch(
    M, qs, warm, J, aref, D, R, floss, active,
    scale, fscale, maskd, conact, Rn, mu,
    *, nf, nl, iterations, pool_dims=None, gram_acc=None,
):
    """Plain PyTorch version of the kernel, in both Gram modes: the
    reference's newton_core (ops/newton.py:200-487) written batch-first,
    with the same per-pool structure, rank-1 cone rows, Cholesky retry,
    zeroed failed steps, NaN-safe ladder argmin and parabolic refinement.
    `gram_acc` is the Gram's summation dtype (`gram_torch`'s acc_dtype):
    chip_smoke.py passes float64 to sample float32 solves in the mxu
    kernel's summation."""
    nv = qs.shape[-1]
    dtype, dev = qs.dtype, qs.device
    nlad = len(_LS_ALPHAS)
    ladder = torch.tensor(list(_LS_ALPHAS) + [0.0], dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye = torch.eye(nv, dtype=dtype, device=dev)
    pen = Penalty(J, D, R, floss, active, scale, fscale, maskd, conact, Rn, mu,
                  nf=nf, nl=nl, pool_dims=pool_dims)

    a = warm
    for _ in range(iterations):
        z = _matvec(J, a) - aref
        f, w, U, wU = pen.fw(z, True)
        Mda = _matvec(M, a - qs)
        grad = Mda - _matvec(J.transpose(1, 2), f)
        H = gram_torch(J, w, U, wU, M, gram_acc)
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
        S_c = pen.S(z[:, None] + ladder[None, :, None] * Jd[:, None])
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
        S_v = pen.S((z + vertex[:, None] * Jd)[:, None])[:, 0]
        phi_v = vertex * qb + vertex * vertex * qa + S_v
        alpha = torch.where(phi_v < best_phi, vertex, a_best)
        a = a + alpha[:, None] * delta

    z = _matvec(J, a) - aref
    f, _w, _U, _wU = pen.fw(z, False)
    return a, f, _matvec(J.transpose(1, 2), f)


KERNEL_NV = (18,)          # widths the kernel is instantiated for (Go1, Go2)


def _check_width(nv: int) -> None:
    """Refuse, before any build or launch, a width the kernel is not
    instantiated for (the plain version takes any)."""
    if nv not in KERNEL_NV:
        raise ValueError(f"the Newton kernel is instantiated for nv in "
                         f"{KERNEL_NV}, not {nv}")


def _pool_arrays(K, pool_dims):
    """(npool, K_p per pool, dim_p per pool) as the C entries take them."""
    pools = pool_dims if pool_dims is not None else ((K, 6),)
    return (len(pools), (ctypes.c_int * len(pools))(*[int(Kp) for Kp, _dp in pools]),
            (ctypes.c_int * len(pools))(*[int(dp) for _Kp, dp in pools]))


# ---- the kernel's entry points ---------------------------------------------

def _lib():
    """The kernels' library, built and loaded at first use, with the C
    entry points' argument types declared (without them ctypes would pass
    64-bit device pointers as 32-bit ints)."""
    lib = load("newton")
    if lib.newton_solve_f32.argtypes is None:
        pi = ctypes.POINTER(ctypes.c_int)
        pf = ctypes.POINTER(ctypes.c_float)
        vp, i = ctypes.c_void_p, ctypes.c_int
        layout = [i] * 5 + [pi, pi]           # B, nv, nf, nl, npool, pools
        solve = [vp] * 18 + layout + [i, pf, i, i, vp]
        lib.newton_solve_f32.argtypes = solve
        lib.newton_profile_f32.argtypes = solve + [vp]
        lib.newton_gram_f32.argtypes = [vp] * 16 + layout + [pf, i, i, vp]
        lib.newton_resources.argtypes = [i] * 5 + [pi, pi, pi]
        for fn in (lib.newton_solve_f32, lib.newton_profile_f32,
                   lib.newton_gram_f32, lib.newton_resources):
            fn.restype = ctypes.c_int
    return lib


GRAM_MODES = ("vpu", "mxu")


def resolve_gram_mode(gram_mode: str | None) -> str:
    """The Gram mode of a solve, selected as the reference selects it
    (quadruped_tpu/ops/newton.py:529-530): None reads QTPU_GRAM, default
    "vpu".  "vpu" forms H on the CUDA cores, "mxu" on the tensor cores
    (csrc/newton.cu); any other value raises ValueError."""
    if gram_mode is None:
        gram_mode = os.environ.get("QTPU_GRAM", "vpu")
    if gram_mode not in GRAM_MODES:
        raise ValueError(f"gram_mode {gram_mode!r}: expected one of {GRAM_MODES}")
    return gram_mode


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


def _launch(entry, args, nf, nl, pool_dims, mode, *, iterations=None, out=None,
            extra=()):
    """Launch one of the kernel's C entry points on CUDA tensors `args`
    (checked); `out` are the entry's output tensors, `iterations` None
    for the Gram entry.  Raises on a refused launch."""
    M = args[0]
    B, nv, ne, K = _check(args, nf, nl, pool_dims)
    if M.device.type != "cuda":
        raise ValueError(f"the Newton kernel runs on CUDA tensors, not {M.device}")
    _check_width(nv)
    if B == 0:
        return
    npool, pool_k, pool_dim = _pool_arrays(K, pool_dims)
    ladder = (ctypes.c_float * len(_LS_ALPHAS))(*_LS_ALPHAS)
    steps = () if iterations is None else (iterations,)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = getattr(_lib(), entry)(
            *[x.data_ptr() for x in args], *[o.data_ptr() for o in out],
            B, nv, nf, nl, npool, pool_k, pool_dim, *steps, ladder,
            len(_LS_ALPHAS), GRAM_MODES.index(mode), stream, *extra,
        )
    if err != 0:
        raise RuntimeError(f"newton kernel ({entry}) launch failed: cudaError {err}")


def _outputs(args):
    M, J = args[0], args[3]
    B, nv, ne = M.shape[0], M.shape[-1], J.shape[1]
    return tuple(torch.empty(shape, dtype=torch.float32, device=M.device)
                 for shape in ((B, nv), (B, ne), (B, nv)))


def newton_solve(
    M, qacc_smooth, warmstart, J, aref, D, R, floss, active,
    con_scale, con_fscale, con_dim_mask, con_active, con_Rn, con_mu,
    *, nf: int, nl: int, iterations: int, pool_dims=None,
    gram_mode: str | None = None,
):
    """Batched Newton solve (see the module docstring for the shapes).
    CPU tensors run the plain version, which computes the same function
    in both Gram modes; CUDA tensors launch the kernel in the mode
    `resolve_gram_mode` gives and count the launch under that mode."""
    args = (M, qacc_smooth, warmstart, J, aref, D, R, floss, active,
            con_scale, con_fscale, con_dim_mask, con_active, con_Rn, con_mu)
    mode = resolve_gram_mode(gram_mode)
    B = _check(args, nf, nl, pool_dims)[0]
    if M.device.type == "cpu":
        return newton_core_torch(
            *args, nf=nf, nl=nl, iterations=iterations, pool_dims=pool_dims
        )
    out = _outputs(args)
    _launch("newton_solve_f32", args, nf, nl, pool_dims, mode,
            iterations=iterations, out=out)
    if B:
        newton_solve.launches[mode] += 1
    return out


newton_solve.launches = {mode: 0 for mode in GRAM_MODES}

# phases of the kernel's cycle profile (`newton_profile`), in order
PHASES = ("staging", "z_fw", "grad", "gram", "cholesky_solves", "jd_md",
          "ladder", "argmin_vertex", "update")


def newton_profile(*args, nf: int, nl: int, iterations: int, pool_dims=None,
                   gram_mode: str | None = None):
    """The kernel's solve with SM clock stamps at its phase boundaries,
    on CUDA tensors only; off the main path and not counted in
    `newton_solve.launches`.  Returns (qacc, f, qfrc, cycles): cycles
    (B, len(PHASES) + 1) int64, per env the SM cycles of each phase of
    PHASES summed over the iterations, then the whole solve (which also
    holds the final forces and the stamps)."""
    mode = resolve_gram_mode(gram_mode)
    out = _outputs(args)
    cyc = torch.zeros((args[0].shape[0], len(PHASES) + 1), dtype=torch.int64,
                      device=args[0].device)
    _launch("newton_profile_f32", args, nf, nl, pool_dims, mode,
            iterations=iterations, out=out, extra=(cyc.data_ptr(),))
    return (*out, cyc)


def gram(M, qacc_smooth, warmstart, J, aref, D, R, floss, active,
         con_scale, con_fscale, con_dim_mask, con_active, con_Rn, con_mu,
         *, nf: int, nl: int, pool_dims=None, gram_mode: str | None = None):
    """H (B, nv, nv) of the solve's first iteration, at the warm start,
    alone: on CUDA tensors through the kernel's own staging, penalty and
    Gram device code in the given mode (no solve, not counted in
    `newton_solve.launches`); on CPU tensors `gram_torch` of Penalty.fw
    at z = J warmstart - aref.  Off the main path: chip_smoke.py and the
    card tests hold each mode's Gram against a float64 `gram_torch`."""
    args = (M, qacc_smooth, warmstart, J, aref, D, R, floss, active,
            con_scale, con_fscale, con_dim_mask, con_active, con_Rn, con_mu)
    mode = resolve_gram_mode(gram_mode)
    B, nv, _ne, _K = _check(args, nf, nl, pool_dims)
    if M.device.type == "cpu":
        z = _matvec(J, warmstart) - aref
        _f, w, U, wU = Penalty(J, *args[5:], nf=nf, nl=nl,
                               pool_dims=pool_dims).fw(z, True)
        return gram_torch(J, w, U, wU, M)
    H = torch.empty((B, nv, nv), dtype=torch.float32, device=M.device)
    _launch("newton_gram_f32", args, nf, nl, pool_dims, mode, out=(H,))
    return H


def kernel_resources(nv: int, nf: int, nl: int, K: int, pool_dims=None,
                     gram_mode: str | None = None) -> dict:
    """The solve kernel's launch plan and resources on the current card
    for a layout, as its launches compute them (csrc/newton.cu:
    make_params): envs per block, shared bytes per env and per block,
    resident blocks and envs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spill) bytes per thread.  Raises ValueError for
    an nv the kernel is not instantiated for, RuntimeError for a layout
    it refuses."""
    mode = resolve_gram_mode(gram_mode)
    _check_width(nv)
    npool, pool_k, pool_dim = _pool_arrays(K, pool_dims)
    out = (ctypes.c_int * 5)()
    err = _lib().newton_resources(nv, GRAM_MODES.index(mode), nf, nl, npool,
                                  pool_k, pool_dim, out)
    if err != 0:
        raise RuntimeError(f"newton kernel resources: cudaError {err}")
    epb, env_bytes, blocks, regs, local = list(out)
    return dict(envs_per_block=epb, env_bytes=env_bytes,
                smem_bytes_per_block=epb * env_bytes, blocks_per_sm=blocks,
                envs_per_sm=blocks * epb, registers=regs, local_bytes=local)
