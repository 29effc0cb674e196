"""Primal Newton solver for MuJoCo-style soft constraints, batch-first.

Counterpart of quadruped_tpu/physics/solver.py.  Minimizes over qacc
    Phi(a) = 1/2 ||a - a_smooth||^2_M  +  sum_i s_i(J a - aref)
where s_i(z) = max_{f in K} [ -f z - 1/2 f R f ] per constraint class:
Huber dof-friction rows, one-sided limit rows and elliptic friction cones
(scaled so the cone is circular with mu_tilde = mu1/sqrt(impratio)).

`solve` sends every batch to the Newton op (ops/newton.py: the CUDA
kernel on the card, its plain PyTorch version on the CPU): pooled or
uniform slot layouts, as under the reference's dispatch rule
(solver.py:311-316), and also the compact rows without pools of the
floor-only table (collision_mode="plane"), which the reference solves
with its single-env path (`_solve_single`, vmapped).  Their slots come in
runs of one static condim, which are the kernel's pools (`pool_runs`),
so the port routes that layout to the op as well; the results agree
within the tolerances the reference holds its kernel to its single-env
path (tests/test_torch_plane.py).  At least one contact slot, float32.  It passes no Gram mode, as
the reference's solver passes none (solver.py:321-330), so QTPU_GRAM
selects it.  The per-row penalty of the reference's single-env path
(`_penalty`, `_penalty_S`) has one counterpart, the plain Newton
version's `ops.newton.Penalty`.
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
_POOL_CACHE: dict[tuple, tuple] = {}

# the most condim runs the Newton kernel takes as pools (csrc/newton.cu:
# MAX_POOLS)
MAX_POOLS = 4


def _row_maps(efc: Efc, ncon: int, device):
    """(inverse row index (ncon*6,), dim mask (ncon, 6)) as tensors on
    `device`, built once per layout."""
    key = (efc.row_con, efc.row_dim, ncon, str(device))
    if key not in _EXPAND_CACHE:
        inv = np.zeros((ncon, 6), np.int64)
        msk = np.zeros((ncon, 6), bool)
        for r, (c, d) in enumerate(zip(efc.row_con, efc.row_dim)):
            inv[c, d] = r
            msk[c, d] = True
        _EXPAND_CACHE[key] = (
            torch.as_tensor(inv.reshape(-1), device=device),
            torch.as_tensor(msk, device=device),
        )
    return _EXPAND_CACHE[key]


def _expand_rows(efc: Efc, zrows: torch.Tensor, ncon: int) -> torch.Tensor:
    """Compact contact rows (..., nrows) -> padded (..., ncon, 6), the
    dims a slot does not have set to zero (a static masked gather)."""
    if efc.row_con is None:
        return zrows.reshape(zrows.shape[:-1] + (ncon, 6))
    idx, mask = _row_maps(efc, ncon, zrows.device)
    gathered = zrows[..., idx].reshape(zrows.shape[:-1] + (ncon, 6))
    return torch.where(mask, gathered, torch.zeros_like(gathered))


def pool_runs(row_con: tuple, ncon: int) -> tuple:
    """The pools ((K_run, condim), ...) of a compact row layout without
    pools: the runs of equal static condim over the slots (the rows of
    slot k are row_con's entries equal to k), built once per layout.
    The floor-only Go1 table gives ((112, 3), (4, 6)), Go2's ((96, 3),
    (4, 6)).  More than MAX_POOLS runs raise NotImplementedError."""
    key = (row_con, ncon)
    if key not in _POOL_CACHE:
        runs: list[list[int]] = []
        for d in np.bincount(np.asarray(row_con, np.int64), minlength=ncon):
            if runs and runs[-1][1] == d:
                runs[-1][0] += 1
            else:
                runs.append([1, int(d)])
        if len(runs) > MAX_POOLS:
            raise NotImplementedError(
                f"the contact slots' condims form {len(runs)} runs; the "
                f"Newton kernel takes at most {MAX_POOLS} pools (see "
                "ROADMAP.md, queue 3)"
            )
        _POOL_CACHE[key] = tuple((k, d) for k, d in runs)
    return _POOL_CACHE[key]


def newton_args(M, qacc_smooth, warmstart, efc: Efc):
    """The plain Newton solve's 15 arrays and its layout arguments for a
    batch, in the batch's own dtype, masks as 0/1 floats.  Pooled or
    uniform slots, or compact rows without pools (their condim runs as
    pools, `pool_runs`); at least one slot.  The benchmark's reference
    runs it in float64 on every candidate, which the port's CUDA kernel
    (float32, at most MAX_POOLS pools) does not take."""
    ncon = efc.con_dist.shape[-1]
    if ncon == 0:
        raise NotImplementedError("the Newton solve takes at least one slot")
    pool_dims = efc.pool_dims
    if efc.row_con is not None and pool_dims is None:
        pool_dims = pool_runs(efc.row_con, ncon)
    fl = qacc_smooth.dtype
    B = qacc_smooth.shape[0]
    args = (
        M.contiguous(), qacc_smooth.contiguous(), warmstart.to(fl).contiguous(),
        efc.J.contiguous(), efc.aref.contiguous(), efc.D.contiguous(),
        efc.R.contiguous(), efc.floss.to(fl).expand(B, -1).contiguous(),
        efc.active.to(fl), efc.con_scale.contiguous(),
        efc.con_fscale.contiguous(), efc.con_dim_mask.to(fl),
        efc.con_active.to(fl), efc.con_Rn.contiguous(),
        efc.con_mu_tilde.contiguous(),
    )
    return args, dict(nf=efc.nf, nl=efc.nl, pool_dims=pool_dims)


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
