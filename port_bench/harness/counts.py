"""The yardstick's arithmetic: the H100's published peaks, the Newton
solve's operations and bytes, and the actor-critic's operations.

`newton_counts` and `bound_ms` are a frozen copy of chip_smoke.py's
(the repo's kernel smoke script), so a later change there does not move
the benchmark's roofline; port_bench/tests/test_pb_harness.py holds the
copy to the original on one input set.
"""

from __future__ import annotations

import torch

H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores, H100 SXM
H100_FP64_TC_FLOPS = 67e12   # FP64 tensor cores (DMMA), dense, H100 SXM
H100_HBM_BYTES = 3.35e12     # HBM3 bytes/s, H100 SXM


def newton_counts(args, kw, iterations, active_only=True):
    """(operations, Gram operations, bytes) one launch needs on these
    inputs; the first count includes the second.

    The work depends on the data: a contact slot that is not active
    (con_active 0) has zero forces, weights and rank-1 rows, adds nothing
    to grad or H, adds to the penalty only a constant below float32
    resolution (tests/test_torch_newton_layout.py), and the kernel skips
    it.  With `active_only` (the bound of the kernels line) each env's
    rows and contacts are its dof-friction and limit rows and its active
    slots; without it, every slot (the count of a kernel that skipped
    none).  Operations and bytes count the same rows and contacts.

    Operations per env and iteration, counting a multiply-add as 2: z = J
    a - aref (2 nv per row), the row penalties and the rank-1 cone rows,
    grad (2 nv^2 + 2 nv per row), the upper-triangle Gram over the rows
    and the 3 rank-1 rows per friction contact (the weighted rows w J
    once, one multiply per row and column, then a multiply-add per row
    and pair: the Gram operations), the Cholesky (nv^3/3 multiply-adds)
    and the two triangular solves (2 nv^2), J d and M d, and 18 penalty
    evaluations of the line search (17 ladder candidates and the
    parabolic vertex).  The Levenberg retry, taken only when the first
    factorization fails, is not counted (it adds one more Cholesky, under
    2% of an iteration).

    Bytes: what the function must read, each input element once, and
    write, each output once: M, qs and warm; J's rows and aref of the
    dof-friction and limit rows and of the counted slots; D of the
    dof-friction and limit rows, R and floss of the dof-friction rows,
    active of the limit rows; con_active of every slot (which slots
    count); scale, fscale and con_dim_mask of each counted slot's condim
    entries, its Rn and mu; qacc, qfrc and every row of f.

    Bounds: "vpu" runs everything on the CUDA cores, so its bound is
    operations / 67 TFLOP/s (FP32).  "mxu" runs the Gram on the FP64
    tensor cores, so its bound is (operations - Gram operations) / 67
    TFLOP/s + Gram operations / 67 TFLOP/s (H100 SXM dense FP64 tensor-core
    peak): the two peaks are equal, and so are the two bounds."""
    M, J = args[0], args[3]
    B, nv, ne = M.shape[0], M.shape[-1], J.shape[1]
    nf, nl = kw["nf"], kw["nl"]
    nfl = nf + nl
    conact = args[12].double()
    K = conact.shape[1]
    pools = kw["pool_dims"] or ((K, 6),)
    npairs = nv * (nv + 1) // 2
    # per env: rows, rank-1 rows, cone operations (u, zones, S), rank-1
    # ops, input words of the counted slots (scale, fscale, mask; Rn, mu)
    rows = torch.full((B,), float(nfl), dtype=torch.float64, device=M.device)
    nu = torch.zeros_like(rows)
    per_con = torch.zeros_like(rows)
    rank1 = torch.zeros_like(rows)
    con_words = torch.zeros_like(rows)
    co = 0
    for Kp, dp in pools:
        n = (conact[:, co:co + Kp].sum(1) if active_only
             else torch.full_like(rows, float(Kp)))
        co += Kp
        rows += n * dp
        per_con += n * (8 * dp + 20)
        con_words += n * (3 * dp + 2)
        if dp > 1:
            nu += 3 * n
            rank1 += n * nv * (2 * dp + 3)
    S_eval = 10 * nfl + per_con + 2 * rows                 # z + alpha Jd
    gram = (2 * npairs + nv) * (rows + nu)
    it = (
        2 * rows * nv                                    # z
        + 8 * nfl + per_con + 4 * (rows - nfl) + rank1   # f, w, U
        + 2 * nv * nv + 2 * rows * nv                    # grad
        + gram + 2 * nv * nv                             # Gram + M
        + 2 * nv ** 3 // 3 + 2 * 2 * nv * nv             # Cholesky + solves
        + 2 * rows * nv + 2 * nv * nv + 4 * nv           # Jd, Md, qa, qb
        + 18 * (S_eval + 4)                              # line search
    )
    final = 2 * rows * nv + 8 * nfl + per_con + 4 * (rows - nfl) + 2 * rows * nv
    flops = (iterations * it + final).sum().item()
    gram_flops = iterations * gram.sum().item()
    words = (nv * nv + 2 * nv                            # M, qs, warm
             + rows * (nv + 1)                           # J rows, aref
             + nfl + 2 * nf + nl + K                     # D, R, floss, active, con_active
             + con_words                                 # the counted slots
             + 2 * nv + ne)                              # qacc, qfrc, f
    return flops, gram_flops, 4 * words.sum().item()


def bound_ms(flops, gram_flops, nbytes, mode):
    """(least ms, what bounds it) of one launch in `mode` (newton_counts)."""
    gram_rate = H100_FP64_TC_FLOPS if mode == "mxu" else H100_FP32_FLOPS
    t_ops = ((flops - gram_flops) / H100_FP32_FLOPS + gram_flops / gram_rate) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlp_flops(sizes) -> int:
    """Operations of one sample through a dense MLP of these widths,
    counting a multiply-add as 2 (biases and activations left out)."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def actor_critic_flops(obs_dim: int, act_dim: int, hidden=(64, 64)) -> int:
    """Operations of one sample through the actor (obs -> 64 -> 64 ->
    act) and the critic (obs -> 64 -> 64 -> 1)."""
    return (mlp_flops((obs_dim, *hidden, act_dim))
            + mlp_flops((obs_dim, *hidden, 1)))
