"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--envs 4096] [--steps 20]

Phases, in order; any failure exits non-zero and prints no result line:
  1. device   CUDA must be available; prints the card's name and power
              limit (nvidia-smi).
  2. build    builds every kernel of the port from csrc/ with nvcc.
  3. kernels  holds the Newton kernel in each Gram mode ("vpu": CUDA
              cores, "mxu": FP64 tensor cores) against its plain PyTorch
              version on the card, on inputs from the port's own assemble
              at --envs envs (reset states, states after a few control
              steps, the stiff contact fixture of the tests).  At 2
              Newton iterations every env whose float32 solve is stable
              (the plain version within 1e-4 of its float64 run and of
              each of 8 runs on inputs moved by one float32 rounding)
              agrees within 1e-3 (scaled as in tests/test_ops.py), and
              the two modes agree with each other there within 1e-3;
              every env is held against a float64 run within a limit set
              by its own float32 noise floor (see check_kernel_set).  At 8
              iterations every output is finite.  Each mode's Gram alone
              (the first iteration's H through the kernel's own staging,
              penalty and Gram code) is held within 1e-5 of a float64
              Gram.  Both modes are timed on each input set, with each
              set's bound (the kernel's work follows the set's active
              contact slots); the plain version on the after-step set,
              the headline, and each mode again there at 4x --envs (the
              inputs repeated).  Per mode, one line of the kernel's
              resources (resident envs per SM from the CUDA occupancy
              API, registers, spill bytes; pooled and uniform layouts)
              and one of its phase split (SM cycles per phase from the
              kernel's clock-stamp profile entry).
  4. main     drives the configuration of record (Go1, torque, full
              collision table, condim pools (8, 28, 12), 8 Newton
              iterations) through its entry points: policy sample, then
              Go1Env.step_autoreset, 3 warm-up and --steps timed control
              steps.  Checks that outputs are finite, that the vpu kernel
              launched exactly 10 times per control step (the mxu one
              never), and that one control step on the card agrees with
              the plain path on the CPU at a small batch.  Prints control
              steps/s, the kernel's time in both modes on the main path's
              states after its timed steps, and the per-phase device ms.
  5. train    PPO at the training configuration of record (PPOConfig()
              defaults, 4096 envs x 32 steps): init, then one
              train_iteration with QTPU_GRAM unset and one with
              QTPU_GRAM=mxu, each launching its own mode 320 times and
              the other none, with finite metrics and params that move;
              then one update on the card against the same update on the
              CPU (params within 1e-5, lr_mult equal).  Prints rollout env
              control steps/s, update ms, iteration s, approx_kl and
              clip_fraction per iteration.
  6. breadth  every other env option.  (a) The training CLI's default
              env (cli/train.py: position servos, full table, 48 uniform
              6-row slots, the model's 15 Newton iterations): PPO.init
              and one train_iteration at PPOConfig() with QTPU_GRAM unset
              (320 vpu launches, no mxu), then the kernel in both modes on
              the path's states after it (check_kernel_set: the kernel
              phase's checks at 2 iterations and finite at 15; timed at
              15 with its bound).  (b) At --envs envs, 3 warm-up and 5
              timed control steps each: biped (torque, condim pools),
              Go2 with position servos and centered actions, rough
              terrain (amplitude 0.04) with gait conditioning (53-dim
              obs), and domain randomization with actuator latency 2 plus
              the "shaped" profile with the three anti-standing levers,
              and collision_mode="plane" (Go1 torque, the floor-only
              table: 116 slots, every candidate, in condim runs (112, 3),
              (4, 6) that the kernel takes as pools); finite obs and
              reward of the env's width and exactly 10 vpu launches per
              control step.  Every config's step_autoreset on the card is
              held against the CPU at B = 8 (same state, env 1 resetting
              into the same injected state) within 1e-3; the Go2, terrain
              and plane runs' states are kernel input sets too.  (c) The
              plane path: the kernel's resources on its layout (envs per
              SM) and one train_iteration at PPOConfig() (320 vpu
              launches, no mxu).
  7. runner   the training CLI as a user starts it, in a temporary
              working directory (printed, then removed):
              cli.train.main(["--run", "train", ...]) at the CLI's
              default env and PPOConfig() (4096 envs x 32 steps), 2
              iterations with an eval of 50 control steps at 2 envs and a
              checkpoint and a video after each (exactly 1,640 vpu
              launches, no mxu; best_model, checkpoint_131072,
              final_model, a history of 2 evals, a tfevents file, the eval
              spool read back); a resume from checkpoint_131072 (one
              iteration, the loaded state bit for bit the saved one, the
              history reloaded); the 3 training videos of 50 frames each,
              with the render backend that drew them (the wireframe from
              one batched fk on the card, on a host without mujoco), then
              monitor.server over the work directory (the videos listed, a
              range request answered with the file's bytes); playback of
              best_model through --run test (5 episodes of 1 s, each
              recorded to eval_videos/ with one frame per control step);
              the gate (8 episodes of 1 s); the capacity probe at 1024,
              4096 and 16384 envs.  Prints iteration and eval seconds, ms
              per eval control step at 2, 5 and 8 envs, the projected eval
              share of a run at the CLI defaults, checkpoint ms and the
              capacity table.
  8. orbax   the JAX package's committed orbax checkpoints through the
              port's reader (no JAX, orbax, tensorstore or zstandard on the
              card host): (a) the three payloads read, each leaf's shape
              as _METADATA's write_shape, its dtype as expected, each
              tree's sha256 the constant tests/test_torch_orbax.py ties
              to orbax's restore (arrays, bytes and seconds each); (b) the gate on
              results/walk_r5_progress (train_state/), 8 episodes of 5 s:
              healthy_ok, length_ok and stepping_ok true, as the JAX
              package's 20-s gate found them; (c) playback of
              multigait-r5/best_model (params/) through --run test, 4
              episodes of 50 control steps, all healthy; (d) --run train
              --model_path multigait-r5/latest_checkpoint, one iteration at
              64 envs x 8 steps: the restored params and Adam state
              bit-equal to (a)'s arrays, the global step continuing from
              the checkpoint's, finite loss and approx_kl, final_model
              reloading to the state saved.
  9. parallel data parallelism over a gloo process group, each rank a
              spawned process with its own CUDA context on this card
              (quadruped_tpu_torch/parallel/).  (a) One
              multichip_train_iteration of RECORD at PPOConfig() over 2
              ranks (2048 of the 4096 envs each): 320 vpu launches per
              rank, finite metrics, params and lr_mult bit-equal across
              the ranks, params moved; per rank and in aggregate the
              rollout's env control steps/s, update s, iteration s and
              the minibatch all-reduce's ms (timed alone, the device
              synchronized), beside the train phase's single-process
              iteration.  (b) 2 ranks x 256 envs against one process on
              the same 512 envs, fallen starts included
              (tests/torch_parallel_ranks.py: mean-sample policy, n_steps
              2, one minibatch, one epoch), held to
              tests/test_multichip_equiv.py's tolerances or, where larger,
              3 x the float32 noise floor of 8 moved runs.  (c)
              dryrun_multichip(2, backend="gloo") and one NCCL rank.  A
              failed rank, a refused backend or a rank set past its time
              limit fails the run.
 10. report   a JSON line with the main path's, the kernels', the train,
              the breadth, the runner, the orbax and the parallel phases'
              numbers;
              one JSON line listing each kernel (launches in the run of
              the path that runs it, named in launches_over, and in each
              breadth, runner, orbax and parallel path (per rank), named in
              launches_by_path; max abs error against its plain version
              on the stable envs at 2 iterations over every input set,
              named in max_abs_err_over; times and bound on the
              after-step set, the bound counting the operations and
              bytes of its active contact slots, the work the function
              needs); the card's name and power limit; and last the line
              {"ok": true, "device": {"platform": "gpu", ...}}.

The main, train and breadth phases select the Gram mode through
QTPU_GRAM, as the reference does; the script clears any inherited value
first, and the runner, orbax and parallel phases run with it unset.
Weights and states are random, made from --seed, except in the orbax
phase, which runs the repo's committed policies.  Nothing is fetched.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores, H100 SXM
H100_FP64_TC_FLOPS = 67e12   # FP64 tensor cores (DMMA), dense, H100 SXM
H100_HBM_BYTES = 3.35e12     # HBM3 bytes/s, H100 SXM
RECORD = dict(ctrl_type="torque", solver_iterations=8,
              contact_pools=(8, 28, 12))
MODES = ("vpu", "mxu")       # the Newton kernel's Gram modes


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def solver_inputs(env, qpos, qvel, ctrl, params):
    """The Newton op's arguments at these states (zero warm start), from
    the port's own fk / smooth / assemble, as physics.solver.solve
    prepares them."""
    from quadruped_tpu_torch.physics.constraint import assemble
    from quadruped_tpu_torch.physics.kinematics import fk
    from quadruped_tpu_torch.physics.smooth import smooth_dynamics
    from quadruped_tpu_torch.physics.solver import newton_args
    from quadruped_tpu_torch.physics.terrain import terrain_of

    m, pl = env.m, env.pipeline
    kin = fk(m, qpos, qvel)
    M, _L, _qf, qs, _qa = smooth_dynamics(m, params, kin, qpos, qvel, ctrl)
    efc = assemble(m, pl.layout, pl.table, kin, qpos, qvel,
                   terrain=terrain_of(params))
    return newton_args(M, qs, torch.zeros_like(qs), efc)


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


def scaled_err(a, b):
    """Per-env max |a - b| / (1 + max |b|) (tests/test_ops.py scaling)."""
    return ((a - b).abs().amax(-1) / (1.0 + b.abs().amax(-1)))


def kernel_input_sets(env, gen, dev, B, seed):
    """(qpos, qvel, ctrl, params) of the three input sets: reset states,
    states after 3 random-torque control steps, and the stiff contact
    fixture of the tests (noise of 1e-4 on every env but the first)."""
    rng = np.random.default_rng(seed)
    sets = {}
    st = env.reset(B, gen)
    zero_ctrl = torch.zeros((B, env.nu), device=dev)
    sets["reset"] = (st.qpos, st.qvel, zero_ctrl, st.params)
    s2 = st
    for _ in range(3):
        a = torch.randn((B, env.nu), generator=gen, device=dev) * 0.5
        s2, *_ = env.step_autoreset(s2, a, gen)
    sets["after_steps"] = (s2.qpos, s2.qvel, zero_ctrl, s2.params)
    d = np.load(ROOT / "tests" / "data" / "stiff_contact_state.npz")
    qp = d["qpos"][None] + rng.normal(0, 1e-4, (B, 19)).astype(np.float32) * (
        np.arange(B)[:, None] > 0)
    qv = np.broadcast_to(d["qvel"], (B, 18))
    prm = {k[6:]: torch.as_tensor(d[k], device=dev).expand(B, *d[k].shape)
           for k in d.files if k.startswith("param_")}
    sets["stiff"] = (
        torch.as_tensor(qp, dtype=torch.float32, device=dev),
        torch.as_tensor(np.ascontiguousarray(qv), device=dev),
        torch.as_tensor(np.broadcast_to(d["action"], (B, 12)).copy(), device=dev),
        prm,
    )
    return sets


def time_kernel(args, kw, it, reps=20):
    """Both Gram modes of the kernel timed on one input set, in the order
    vpu, mxu, mxu, vpu (each the mean device ms of `reps` launches after a
    warm-up), with each mode's bound on these inputs (newton_counts):
    {mode: {ms, ms_runs, bound_ms, bound_by}, active_slots_per_env,
    flops, gram_flops, bytes}.  These launches are not checked against
    the launch counts."""
    from quadruped_tpu_torch.ops import newton as N

    runs = {mode: [] for mode in MODES}
    for mode in ("vpu", "mxu", "mxu", "vpu"):
        runs[mode].append(cuda_time_ms(
            lambda: N.newton_solve(*args, iterations=it, gram_mode=mode, **kw), reps))
    flops, gram_flops, nbytes = newton_counts(args, kw, it)
    out = dict(active_slots_per_env=args[12].sum().item() / args[0].shape[0],
               flops=flops, gram_flops=gram_flops, bytes=nbytes)
    for mode in MODES:
        bound, by = bound_ms(flops, gram_flops, nbytes, mode)
        out[mode] = dict(ms=sum(runs[mode]) / 2, ms_runs=runs[mode],
                         bound_ms=bound, bound_by=by)
    return out


def log_timing(what, B, it, t):
    log(f"kernel timing [{what}] ({B} envs, {it} iterations, "
        f"{t['active_slots_per_env']:.2f} active contact slots per env): "
        + "; ".join(f"{mode} {t[mode]['ms_runs'][0]:.4f} / "
                    f"{t[mode]['ms_runs'][1]:.4f} ms, bound "
                    f"{t[mode]['bound_ms']:.4f} ms by {t[mode]['bound_by']}"
                    for mode in MODES)
        + f" ({t['flops'] / 1e9:.3f} GFLOP, of it Gram "
          f"{t['gram_flops'] / 1e9:.3f}; {t['bytes'] / 1e6:.2f} MB)")


ERR_KEYS = ("max_abs_err", "max_abs_err_all_envs", "max_scaled_err_2it",
            "max_scaled_err_2it_well", "max_scaled_err_full_it",
            "max_err_over_env_limit")


def check_kernel_set(name, args, kw, full_it, seed):
    """Each Gram mode of the kernel against the plain version on one input
    set (the Newton op's arguments at B envs), at 2 iterations and at
    full_it, and the two modes against each other.  Raises on any check
    that fails; returns {mode: the set's errors (ERR_KEYS; mxu also
    max_scaled_err_vs_vpu_2it_well)}."""
    from quadruped_tpu_torch.ops import newton as N

    dev, B = args[0].device, args[0].shape[0]
    report = {mode: {} for mode in MODES}

    def env_err(x, y):      # per env, worst of qacc and qfrc
        return torch.maximum(scaled_err(x[0].double(), y[0].double()),
                             scaled_err(x[2].double(), y[2].double()))

    p2 = N.newton_core_torch(*args, iterations=2, **kw)
    t2 = N.newton_core_torch(*[a.double() for a in args], iterations=2, **kw)
    # the plain version again on 4 inputs moved by one float32
    # rounding (relative 2^-23 noise on M, J, aref, D, R), in each
    # kernel's summation precision: the Gram summed in float32 (vpu)
    # and accumulated in float64, rounded once (mxu)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    moved_args = [
        [a * (1 + 2.0**-23 * torch.randn(a.shape, generator=g, device=dev))
         if i in (0, 3, 4, 5, 6) else a for i, a in enumerate(args)]
        for _ in range(4)
    ]
    moved_runs = [
        N.newton_core_torch(*a2, iterations=2, gram_acc=acc, **kw)
        for acc in (None, torch.float64) for a2 in moved_args
    ]
    pf = N.newton_core_torch(*args, iterations=full_it, **kw)
    # float32 noise floor of each env's solve: how far the plain
    # version lies from its float64 run, and how far it moves when
    # its inputs move by one rounding (every moved run; and how far
    # each lies from float64, for `spread`)
    e_pt = env_err(p2, t2)
    e_moved = [env_err(m2, p2) for m2 in moved_runs]
    floor = e_pt
    spread = e_pt
    for m2, e_m in zip(moved_runs, e_moved):
        floor = torch.maximum(floor, e_m)
        spread = torch.maximum(spread, torch.maximum(e_m, env_err(m2, t2)))
    # Tolerance (2 iterations).  On every env whose float32 solve is
    # stable (noise floor <= 1e-4) the kernel agrees with the plain
    # version within 1e-3, scaled as in tests/test_ops.py.  On the
    # others (deep penetration: fallen starts, the stiff fixture; or a
    # discrete choice, a line-search argmin or a cone zone, that one
    # rounding flips) the float32 Newton step is ill-conditioned and any
    # two float32 solves differ by up to the floor.  So every env,
    # stable or not, is also held to its own limit: no further from the
    # float64 solve than 2e-3 + 3 x the spread of its float32 solves
    # (the plain version and the 8 moved runs, in both precisions).
    well = floor <= 1e-4
    lim = 2e-3 + 3.0 * spread
    # the envs a floor from the first moved run alone would call stable:
    # the ones the other moved runs show unstable, and how far the
    # kernel and those runs lie from the plain version there
    flip = (torch.maximum(e_pt, e_moved[0]) <= 1e-4) & ~well
    flip_moved = max((e_m[flip].max().item() for e_m in e_moved), default=0.0) \
        if flip.any() else 0.0
    k2s, kfs, e_kts = {}, {}, {}
    for mode in MODES:
        before = dict(N.newton_solve.launches)
        k2s[mode] = N.newton_solve(*args, iterations=2, gram_mode=mode, **kw)
        kfs[mode] = N.newton_solve(*args, iterations=full_it, gram_mode=mode, **kw)
        torch.cuda.synchronize()
        want = {m: before[m] + (2 if m == mode else 0) for m in MODES}
        if N.newton_solve.launches != want:
            raise RuntimeError(f"the {mode} kernel check launched "
                               f"{N.newton_solve.launches}, expected {want}")
    # 8 moved runs sample an env's float32 spread; on the rare env where a
    # kernel lies beyond the limit that sample gives, draw 64 more moved
    # runs of that env (32 inputs, both summations) and take the spread
    # of all 72.  The limit's rule is unchanged; only its sample grows,
    # and where the kernel is a float32 solve the wider sample reaches it
    # (on the plane path's states one env needed 50 runs to show a
    # float32 solve at 0.2989 of float64, where the kernel lay at 0.2983).
    over0 = torch.zeros_like(well)
    for mode in MODES:
        over0 |= env_err(k2s[mode], t2) > lim
    resampled = int(over0.sum())
    if resampled:
        idx = over0.nonzero()[:, 0]
        sub = [a[idx].contiguous() for a in args]
        t2_sub = tuple(x[idx] for x in t2)
        sp = spread[idx]
        for _ in range(32):
            moved = [a * (1 + 2.0**-23 * torch.randn(a.shape, generator=g, device=dev))
                     if i in (0, 3, 4, 5, 6) else a for i, a in enumerate(sub)]
            for acc in (None, torch.float64):
                m2 = N.newton_core_torch(*moved, iterations=2, gram_acc=acc, **kw)
                sp = torch.maximum(sp, env_err(m2, t2_sub))
        log(f"  {resampled} envs over their limit at 8 moved runs ({name}), "
            f"re-sampled with 64 more: spread "
            + ", ".join(f"env {i} {a:.3e} -> {b:.3e}" for i, a, b in
                        zip(idx.tolist(), spread[idx].tolist(), sp.tolist())))
        spread = spread.clone()
        spread[idx] = sp
        lim = 2e-3 + 3.0 * spread
    for mode in MODES:
        k2, kf = k2s[mode], kfs[mode]
        e_kp = env_err(k2, p2)   # kernel vs plain, float32 both
        e_kt = e_kts[mode] = env_err(k2, t2)   # kernel vs float64
        e2_well = e_kp[well].max().item() if well.any() else 0.0
        over = e_kt > lim
        n_over = int(over.sum())
        ratio = (e_kt / lim).max().item()
        for i in over.nonzero()[:, 0].tolist():
            log(f"  over its limit ({mode}, {name}) env {i}: kernel vs "
                f"float64 {e_kt[i].item():.3e}, plain vs float64 "
                f"{e_pt[i].item():.3e}, spread {spread[i].item():.3e}, "
                f"kernel vs plain {e_kp[i].item():.3e}")
        e2 = e_kp.max().item()
        ef = max(scaled_err(kf[i], pf[i]).max().item() for i in (0, 2))
        abs2 = max((k2[i] - p2[i]).abs().max().item() for i in (0, 2))
        abs2_well = max(
            (k2[i] - p2[i])[well].abs().max().item() if well.any() else 0.0
            for i in (0, 2)
        )
        fin = all(torch.isfinite(x).all().item() for x in kf)
        ncon = args[12].sum().item()
        log(f"kernel {mode}[{name}]: B={B} active contacts/env "
            f"{ncon / B:.2f}; 2 it: kernel vs plain max scaled err "
            f"{e2:.3e} (abs {abs2:.3e}), over the {int(well.sum())} envs "
            f"float32 solves stably: {e2_well:.3e} (abs {abs2_well:.3e}); "
            f"kernel vs float64 {e_kt.max().item():.3e}, plain vs float64 "
            f"{e_pt.max().item():.3e}, largest float32 noise floor "
            f"{floor.max().item():.3e}, {int((e_kp > 1e-3).sum())} envs "
            f"above 1e-3 of plain; worst kernel-vs-float64 error over its "
            f"own env's limit {ratio:.3e}, {n_over} envs over it; "
            f"{int(flip.sum())} envs stable on the first moved run but not "
            f"on every one (kernel vs plain there up to "
            f"{e_kp[flip].max().item() if flip.any() else 0.0:.3e}, moved "
            f"runs up to {flip_moved:.3e}); "
            f"{full_it} it: max scaled err {ef:.3e}, finite={fin}")
        if not fin:
            raise RuntimeError(f"{mode} kernel outputs not finite at "
                               f"{full_it} iterations ({name})")
        if not (e2_well <= 1e-3 and n_over == 0):
            raise RuntimeError(
                f"{mode} kernel vs plain at 2 iterations out of tolerance "
                f"({name}): {e2_well:.3e} on stable envs, {n_over} envs "
                f"over their float64 limit"
            )
        report[mode].update(zip(ERR_KEYS, (abs2_well, abs2, e2, e2_well, ef, ratio)))
        report[mode]["envs_resampled"] = resampled
    # the two modes against each other on the stable envs, 1e-3
    e_mv = env_err(k2s["mxu"], k2s["vpu"])
    e_mv_well = e_mv[well].max().item() if well.any() else 0.0
    log(f"kernel mxu vs vpu [{name}], 2 it: max scaled err over the stable "
        f"envs {e_mv_well:.3e}, over all envs {e_mv.max().item():.3e}")
    if not e_mv_well <= 1e-3:
        raise RuntimeError(f"mxu vs vpu at 2 iterations ({name}): {e_mv_well:.3e}")
    report["mxu"]["max_scaled_err_vs_vpu_2it_well"] = e_mv_well
    # the mxu kernel against the plain version in its own summation
    # (Gram accumulated in float64), and at its worst env the float64
    # distances of the float32 solves the limit samples, by summation
    e_kr = env_err(k2s["mxu"], N.newton_core_torch(
        *args, iterations=2, gram_acc=torch.float64, **kw))
    i = int(torch.argmax(e_kts["mxu"] / lim))
    far = [env_err(m2, t2)[i].item() for m2 in moved_runs]
    log(f"kernel mxu vs the plain version in its own summation [{name}], "
        f"2 it: median {e_kr.median().item():.3e}, max over the stable "
        f"envs {e_kr[well].max().item() if well.any() else 0.0:.3e}; at "
        f"env {i}, its worst against its limit: kernel vs float64 "
        f"{e_kts['mxu'][i].item():.4e}, plain {e_pt[i].item():.4e}, moved "
        f"runs up to {max(far[:4]):.4e} (float32 summation) and "
        f"{max(far[4:]):.4e} (float64-accumulated Gram)")
    return report


def phase_kernels(env, gen, dev, B, seed):
    """Each Gram mode of the kernel vs the plain version on the card, per
    input set; the isolated Gram vs float64; times and bounds per set."""
    from quadruped_tpu_torch.ops import newton as N

    it = env.m.opt.iterations
    timings = {}
    report = {mode: dict.fromkeys(ERR_KEYS, 0.0) for mode in MODES}
    report["mxu"]["max_scaled_err_vs_vpu_2it_well"] = 0.0
    for name, (qpos, qvel, ctrl, params) in kernel_input_sets(
            env, gen, dev, B, seed).items():
        args, kw = solver_inputs(env, qpos, qvel, ctrl, params)
        got = check_kernel_set(name, args, kw, it, seed)
        for mode, errs in got.items():
            for k, v in errs.items():
                report[mode][k] = max(report[mode].get(k, 0), v)
        t = timings[name] = time_kernel(args, kw, it)
        log_timing(name, B, it, t)
        if name == "after_steps":
            timed = (args, kw)

    # the Gram alone, through the kernel's own staging, penalty and Gram
    # device code at the warm start, against a float64 gram_torch:
    # separates a wrong fragment layout from the line search (the
    # reference measured ~2e-6 for its MXU Gram, tests/test_ops.py:160-166)
    args, kw = timed
    J, M = args[3], args[0]
    z = (J @ args[2][..., None])[..., 0] - args[4]
    _f, w, U, wU = N.Penalty(J, *args[5:], **kw).fw(z, True)
    H64 = N.gram_torch(*(x.double() for x in (J, w, U, wU, M)))
    for mode in MODES:
        H = N.gram(*args, gram_mode=mode, **kw)
        err = ((H.double() - H64).abs().amax((1, 2))
               / (1.0 + H64.abs().amax((1, 2)))).max().item()
        log(f"gram {mode} (after_steps, B={B}, nu={U.shape[1]}): H vs float64, "
            f"max scaled err {err:.3e} (limit 1e-5)")
        if not err <= 1e-5:
            raise RuntimeError(f"{mode} Gram vs float64: {err:.3e} > 1e-5")
        report[mode]["gram_err_vs_float64"] = err

    # the headline set: after steps; the plain version, the count over
    # every slot and 4x the batch (the inputs repeated: does the time
    # follow the waves of resident envs?) there alone
    t = timings["after_steps"]
    plain_ms = cuda_time_ms(lambda: N.newton_core_torch(*args, iterations=it, **kw), 3)
    flops_all, gram_all, bytes_all = newton_counts(args, kw, it, active_only=False)
    bound_all = bound_ms(flops_all, gram_all, bytes_all, "vpu")[0]
    args4 = [a.repeat(4, *([1] * (a.dim() - 1))).contiguous() for a in args]
    for mode in MODES:
        ms4 = cuda_time_ms(
            lambda: N.newton_solve(*args4, iterations=it, gram_mode=mode, **kw), 10)
        report[mode].update(
            **t[mode], plain_ms=plain_ms, flops=t["flops"],
            gram_flops=t["gram_flops"], bytes=t["bytes"], ms_4x_envs=ms4,
            bound_ms_every_slot=bound_all, flops_every_slot=flops_all,
            bytes_every_slot=bytes_all,
            by_set={name: dict(tt[mode], active_slots_per_env=tt["active_slots_per_env"])
                    for name, tt in timings.items()},
        )
        log(f"kernel timing {mode} ({B} envs, {it} iterations, after_steps "
            f"inputs): kernel {t[mode]['ms']:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {t[mode]['bound_ms']:.4f} ms by {t[mode]['bound_by']}; "
            f"counting every slot: {flops_all / 1e9:.3f} GFLOP, "
            f"{bytes_all / 1e6:.2f} MB, bound {bound_all:.4f} ms; at {4 * B} "
            f"envs (the inputs x4) {ms4:.4f} ms ({ms4 / t[mode]['ms']:.3f}x)")
    kernel_profile(env, args, kw, it, report)
    return report


def kernel_profile(env, args, kw, it, report):
    """Per mode: the solve kernel's resources (resident envs per SM from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers, spills)
    on the pooled layout of these inputs and on the uniform layout with
    as many slots, and the split of its SM cycles by phase from the
    profile entry (SM clock stamps at the phase boundaries, summed over
    envs and iterations; "other" is the rest of the total: the final
    forces and the stamps themselves)."""
    from quadruped_tpu_torch.ops import newton as N

    nv, K = args[0].shape[-1], args[9].shape[1]
    for mode in MODES:
        res = {layout: N.kernel_resources(nv, kw["nf"], kw["nl"], K, pools, mode)
               for layout, pools in (("pooled", kw["pool_dims"]),
                                     ("uniform", None))}
        report[mode]["resources"] = res
        log(f"kernel resources {mode}: " + "; ".join(
            f"{layout} {r['envs_per_sm']} envs per SM ({r['blocks_per_sm']} "
            f"blocks of {r['envs_per_block']} envs, {r['smem_bytes_per_block']} "
            f"shared bytes per block), {r['registers']} registers, "
            f"{r['local_bytes']} local (spill) bytes per thread"
            for layout, r in res.items()))
        *_out, cyc = N.newton_profile(*args, iterations=it, gram_mode=mode, **kw)
        tot = cyc.sum(0).double()
        shares = {ph: (tot[i] / tot[-1]).item() for i, ph in enumerate(N.PHASES)}
        shares["other"] = 1.0 - sum(shares.values())
        per_env = (tot[-1] / cyc.shape[0]).item()
        report[mode]["phase_shares"] = shares
        report[mode]["cycles_per_env"] = per_env
        log(f"kernel phases {mode} ({cyc.shape[0]} envs, {it} iterations, "
            f"{per_env:.0f} SM cycles per env): "
            + ", ".join(f"{ph} {100 * v:.1f}%" for ph, v in shares.items()))


def phase_main(env, policy, gen, dev, B, steps):
    """The configuration of record through its entry points."""
    from quadruped_tpu_torch.ops import newton as N
    from quadruped_tpu_torch.timing import TIMER

    state = env.reset(B, gen)
    obs = env.obs(state)

    def control_step(state, obs):
        action, _logp, _value, _mean = policy.sample(obs, gen)
        state, obs, reward, term, trunc, _info = env.step_autoreset(
            state, action, gen
        )
        return state, obs, reward

    for _ in range(3):
        state, obs, reward = control_step(state, obs)
    torch.cuda.synchronize()
    for mode in MODES:
        N.newton_solve.launches[mode] = 0
    t0 = time.perf_counter()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(steps):
        state, obs, reward = control_step(state, obs)
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(N.newton_solve.launches)
    launches = counts["vpu"]
    if not bool(finite):
        raise RuntimeError("non-finite obs or reward on the main path")
    if tuple(obs.shape) != (B, env.obs_dim):
        raise RuntimeError(f"obs shape {tuple(obs.shape)}")
    expect = {"vpu": env.cfg.frame_skip * steps, "mxu": 0}
    if counts != expect:
        raise RuntimeError(f"Newton kernel launched {counts}, expected {expect}")
    log(f"main: {steps} control steps x {B} envs in {dt:.4f} s: "
        f"{steps / dt:.3f} batched control steps/s, "
        f"{B * steps / dt:.1f} env control steps/s; "
        f"Newton launches {launches} ({launches / steps:g} per control step)")

    # the kernel alone on the main path's states after its timed steps
    # (zero control and warm start, as the input sets of phase_kernels)
    kargs, kkw = solver_inputs(env, state.qpos, state.qvel,
                               torch.zeros((B, env.nu), device=dev), state.params)
    t_main = time_kernel(kargs, kkw, env.m.opt.iterations)
    log_timing(f"main path states after {3 + steps} control steps", B,
               env.m.opt.iterations, t_main)

    # per-phase device ms, in a separate instrumented run
    TIMER.reset()
    TIMER.enabled = True
    n_prof = 5
    for _ in range(n_prof):
        with TIMER.phase("policy"):
            action, *_ = policy.sample(obs, gen)
        state, obs, _r, _t, _tr, _i = env.step_autoreset(state, action, gen)
    tot = TIMER.totals_ms()
    TIMER.enabled = False
    per_step = {k: v / n_prof for k, v in tot.items()}
    log("main phases (device ms per control step, 10 substeps): "
        + json.dumps({k: round(v, 4) for k, v in per_step.items()}))
    return {"launches": launches, "steps_per_s": steps / dt,
            "env_steps_per_s": B * steps / dt, "phases_ms": per_step,
            "kernel_on_main_states": t_main}


def train_iteration(trainer, ts, mode, label):
    """One PPO.train_iteration in Gram `mode` (QTPU_GRAM set by the
    caller), with the phase timer on: it must launch its own mode's kernel
    frame_skip x n_steps times and the other's none, give finite metrics
    and move the params.  Returns (ts, row)."""
    from quadruped_tpu_torch.ops import newton as N
    from quadruped_tpu_torch.timing import TIMER

    env, cfg = trainer.env, trainer.cfg
    params = [p.detach().clone() for p in ts.policy.parameters()]
    for m in MODES:
        N.newton_solve.launches[m] = 0
    TIMER.reset()
    TIMER.enabled = True
    t0 = time.perf_counter()
    ts, metrics = trainer.train_iteration(ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    TIMER.enabled = False
    counts = dict(N.newton_solve.launches)
    phases = TIMER.totals_ms()
    expect = {m: (env.cfg.frame_skip * cfg.n_steps if m == mode else 0)
              for m in MODES}
    if counts != expect:
        raise RuntimeError(f"{label} ({mode}) launched {counts}, expected {expect}")
    metrics = {k: v.item() for k, v in metrics.items()}
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite train metrics ({label}, {mode}): {bad}")
    new = [p.detach().clone() for p in ts.policy.parameters()]
    if not all(torch.isfinite(p).all().item() for p in new):
        raise RuntimeError(f"non-finite params after the {label} ({mode})")
    moved = max((a - b).abs().max().item() for a, b in zip(new, params))
    if not moved > 0.0:
        raise RuntimeError(f"params unchanged by the {label} ({mode})")
    row = dict(
        gram_mode=mode, launches=counts,
        rollout_s=phases["rollout"] / 1e3,
        rollout_env_steps_per_s=cfg.num_envs * cfg.n_steps
        / (phases["rollout"] / 1e3),
        update_ms=phases["update"], iteration_s=dt,
        max_param_change=moved, metrics=metrics,
        phases_ms={k: v for k, v in phases.items()
                   if k not in ("rollout", "update")},
    )
    log(f"{label} ({mode}): {cfg.num_envs} envs x "
        f"{cfg.n_steps} steps; rollout {row['rollout_s']:.3f} s = "
        f"{row['rollout_env_steps_per_s']:.1f} env control steps/s; "
        f"update {row['update_ms']:.1f} ms ({cfg.n_epochs} epochs x "
        f"{cfg.num_minibatches} minibatches); iteration {dt:.3f} s; "
        f"approx_kl {metrics['approx_kl']:.4e}, clip_fraction "
        f"{metrics['clip_fraction']:.4f}, loss {metrics['loss']:.4f}, "
        f"mean_reward {metrics['mean_reward']:.4f}; Newton launches "
        f"{counts}; largest param change {moved:.3e}")
    return ts, row


def phase_train(env, dev, seed):
    """The training configuration of record through PPO's entry points:
    the env of RECORD and PPOConfig()'s defaults, which are cli/train.py's
    (4096 envs, n_steps 32, 32 minibatches, 10 epochs, lr 3e-4).
    PPO.init, then two train_iterations: the first with QTPU_GRAM unset
    (the vpu Gram), the second with QTPU_GRAM=mxu; each must launch its
    own mode's kernel 10 x 32 = 320 times and the other's none.  The
    phase timer is on (rollout / update split, device events).  The
    training CLI's own default env (position servos) trains in the
    breadth phase."""
    from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig

    cfg = PPOConfig()
    trainer = PPO(env, cfg)
    ts = trainer.init(seed)
    torch.cuda.synchronize()
    saved = os.environ.pop("QTPU_GRAM", None)
    rows = []
    try:
        for mode in MODES:
            if mode == "mxu":
                os.environ["QTPU_GRAM"] = "mxu"
            ts, row = train_iteration(trainer, ts, mode, "train iteration")
            rows.append(row)
    finally:
        if saved is None:
            os.environ.pop("QTPU_GRAM", None)
        else:
            os.environ["QTPU_GRAM"] = saved
    return {"envs": cfg.num_envs, "n_steps": cfg.n_steps,
            "n_epochs": cfg.n_epochs, "num_minibatches": cfg.num_minibatches,
            "iterations": rows}


def phase_train_reference(seed):
    """One PPO.update on the card and on the CPU from the same params, the
    same injected trajectory (B = 64, T = 4, made with numpy) and the same
    permutations, with kl_target=0.01 (2 epochs x 4 minibatches): params
    within 1e-5 absolute, lr_mult exactly equal."""
    from quadruped_tpu_torch.learn.ppo import (PPO, PPOConfig, TrainState,
                                               Transition, make_optimizer)
    from quadruped_tpu_torch.models.actor_critic import ActorCritic

    T, B = 4, 64
    cfg = PPOConfig(num_envs=B, n_steps=T, n_epochs=2, num_minibatches=4,
                    kl_target=0.01)
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    net = ActorCritic(device="cpu", generator=torch.Generator().manual_seed(seed))
    obs, action = f32(T, B, 48), f32(T, B, 12)
    with torch.no_grad():
        mean, log_std, _v = net(torch.as_tensor(obs))
        logp = ActorCritic.log_prob(mean, log_std, torch.as_tensor(action))
    terminated = rng.uniform(size=(T, B)) < 0.1
    done = terminated | (rng.uniform(size=(T, B)) < 0.1)
    traj = dict(
        obs=obs, action=action,
        log_prob=(logp.numpy() + 0.05 * f32(T, B)).astype(np.float32),
        value=f32(T, B), reward=f32(T, B), terminated=terminated, done=done,
        bootstrap_value=np.where(terminated, 0.0, f32(T, B)).astype(np.float32),
    )
    last_obs = f32(B, 48)
    perms = [rng.permutation(T * B) for _ in range(cfg.n_epochs)]
    out = {}
    for dev in ("cpu", "cuda"):
        policy = copy.deepcopy(net).to(dev)
        ts = TrainState(
            policy=policy, optimizer=make_optimizer(policy, cfg),
            env_state=None, obs=torch.as_tensor(last_obs, device=dev),
            generator=torch.Generator(device=dev),
            rand_power=torch.zeros((), device=dev),
            lr_mult=torch.ones((), device=dev),
        )
        ts, metrics = PPO(None, cfg, device=dev).update(
            ts, Transition(**{k: torch.as_tensor(v, device=dev)
                              for k, v in traj.items()}),
            perms=[torch.as_tensor(p, device=dev) for p in perms])
        out[dev] = ([p.detach().cpu() for p in ts.policy.parameters()],
                    ts.lr_mult.item(), metrics["approx_kl"].item())
    err = max((a - b).abs().max().item() for a, b in zip(out["cpu"][0], out["cuda"][0]))
    moved = max((a - b.detach()).abs().max().item()
                for a, b in zip(out["cpu"][0], net.parameters()))
    log(f"train reference (B={B}, T={T}, 2 epochs x 4 minibatches, kl_target "
        f"0.01): params card vs CPU max abs err {err:.3e} (limit 1e-5; largest "
        f"param change {moved:.3e}); lr_mult card {out['cuda'][1]!r}, CPU "
        f"{out['cpu'][1]!r}; approx_kl card {out['cuda'][2]:.6e}, CPU "
        f"{out['cpu'][2]:.6e}")
    if not (err <= 1e-5 and out["cuda"][1] == out["cpu"][1] and moved > 0.0):
        raise RuntimeError(f"card vs CPU update: params {err:.3e}, lr_mult "
                           f"{out['cuda'][1]} vs {out['cpu'][1]}")
    return {"update_card_vs_cpu_max_abs_err": err, "lr_mult": out["cuda"][1]}


def phase_reference(env_gpu, seed):
    """One control step on the card (kernel) against the plain path on
    the CPU, from the same near-keyframe states at a small batch."""
    from quadruped_tpu_torch.env.config import Go1Config
    from quadruped_tpu_torch.env.go1 import Go1Env

    env_cpu = Go1Env(Go1Config(**RECORD), device="cpu")
    B = 8
    rng = np.random.default_rng(seed)
    st = env_cpu.reset(B, torch.Generator().manual_seed(seed))
    st.qpos = torch.as_tensor(
        (env_cpu.key_qpos + rng.normal(0, 0.01, (B, 19))).astype(np.float32))
    st.qvel = torch.as_tensor(rng.normal(0, 0.1, (B, 18)).astype(np.float32))
    action = torch.as_tensor(rng.uniform(-1, 1, (B, 12)).astype(np.float32))
    out_c = env_cpu.step(st, action)
    st_g = type(st)(**{
        k: ({n: t.cuda() for n, t in v.items()} if k == "params" else v.cuda())
        for k, v in vars(st).items()
    })
    out_g = env_gpu.step(st_g, action.cuda())
    worst = 0.0
    for name, c, g in (("qpos", out_c[0].qpos, out_g[0].qpos),
                       ("qvel", out_c[0].qvel, out_g[0].qvel),
                       ("obs", out_c[1], out_g[1])):
        err = scaled_err(g.cpu(), c).max().item()
        worst = max(worst, err)
        log(f"reference step (B={B}): {name} max scaled err card vs CPU {err:.3e}")
    # one control step = 10 substeps x 8 iterations; the CPU tests hold
    # the plain path to the JAX package at 1e-3 on such states
    if not worst <= 1e-3:
        raise RuntimeError(f"card vs CPU control step: {worst:.3e} > 1e-3")
    return worst


def breadth_configs():
    """The per-option configurations of the breadth phase: together every
    Go1Config option of the reference.  "plane" is the floor-only table
    (116 candidates, every one a solver slot, condim runs (112, 3), (4, 6)
    as the kernel's pools) of the reference's learning-regression env
    (tests/test_learning_regression.py)."""
    from quadruped_tpu_torch.env.config import (DomainRandomization, Go1Config,
                                                RewardWeights)

    return {
        "biped": Go1Config(ctrl_type="torque", biped=True,
                           contact_pools=(8, 28, 12)),
        "go2": Go1Config(robot="go2", ctrl_type="position",
                         action_mode="centered"),
        "terrain": Go1Config(ctrl_type="position", terrain="rough",
                             terrain_amplitude=0.04, gait_conditioning=True),
        # DR with latency, and cli/train.py's "shaped" profile with the
        # three anti-standing levers on, as its make_env builds it
        "levers": Go1Config(
            ctrl_type="position",
            dr=DomainRandomization(enabled=True, max_latency_steps=2),
            reward_floor=False, accel_cost_mode="plain",
            rewards=RewardWeights(recovery=0.0, get_up=0.0),
            fallen_start_prob=0.0, command_speed_floor=0.2,
            stand_still_cost=1.0, stand_still_mode="velocity",
            feet_airtime_bootstrap=0.5),
        "plane": Go1Config(ctrl_type="torque", collision_mode="plane",
                           fallen_start_prob=0.0),
    }


def slots_of(env) -> str:
    lay = env.pipeline.layout
    if lay.pools is not None:
        return "pools " + str(env.cfg.contact_pools)
    if lay.max_contacts is not None:
        return f"{lay.max_contacts} uniform"
    return f"{lay.ncon} (every candidate)"


def to_device(state, dev):
    return type(state)(**{
        k: ({n: t.to(dev) for n, t in v.items()} if k == "params" else v.to(dev))
        for k, v in vars(state).items()
    })


def reference_autoreset(env_gpu, seed, label):
    """One step_autoreset on the card (kernel) against the plain path on
    the CPU, same config, from the same near-keyframe states (on the drawn
    ground, with the CPU reset's params: terrain, randomized params,
    latencies, gaits) at B = 8, env 1 truncating into the same injected
    reset state (fresh=): qpos, qvel and obs within 1e-3 scaled, as
    phase_reference holds the record path.  The reward is printed, not
    held: the reference's "dynamic" acceleration cost divides qacc^2 by
    |qvel| + 1e-6, which magnifies float32 rounding of near-rest joints."""
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.physics.terrain import height_normal

    env_cpu = Go1Env(env_gpu.cfg, device="cpu")
    B = 8
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    st = env_cpu.reset(B, g)
    fresh = env_cpu.reset(B, g, params=st.params, rand_power=st.rand_power)
    qpos = torch.as_tensor(
        (env_cpu.key_qpos + rng.normal(0, 0.01, (B, 19))).astype(np.float32))
    if "terrain_amp" in st.params:
        qpos[:, 2] += height_normal(st.params, qpos[:, :2])[0]
    st.qpos = qpos
    st.qvel = torch.as_tensor(rng.normal(0, 0.1, (B, 18)).astype(np.float32))
    st.steps[1] = env_cpu.cfg.max_episode_steps - 1
    action = torch.as_tensor(rng.uniform(-1, 1, (B, 12)).astype(np.float32))
    out_c = env_cpu.step_autoreset(st, action, fresh=fresh)
    out_g = env_gpu.step_autoreset(to_device(st, "cuda"), action.cuda(),
                                   fresh=to_device(fresh, "cuda"))
    if not (bool(out_c[4][1]) and bool(out_g[4][1])):
        raise RuntimeError(f"reference step ({label}): env 1 did not truncate")
    errs = {name: scaled_err(g_.cpu(), c).max().item()
            for name, c, g_ in (("qpos", out_c[0].qpos, out_g[0].qpos),
                                ("qvel", out_c[0].qvel, out_g[0].qvel),
                                ("obs", out_c[1], out_g[1]))}
    worst = max(errs.values())
    rew = scaled_err(out_g[2][:, None].cpu(), out_c[2][:, None]).max().item()
    log(f"breadth reference step [{label}] (B={B}, step_autoreset, env 1 "
        f"reset): max scaled err card vs CPU "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (reward, not held: {rew:.3e})")
    if not worst <= 1e-3:
        raise RuntimeError(f"card vs CPU control step ({label}): {worst:.3e} > 1e-3")
    return errs


def run_option(name, cfg, dev, B, seed, warm=3, steps=5):
    """One configuration's control step at full width through its entry
    points (policy.sample -> Go1Env.step_autoreset), warm-up steps then
    timed ones, the launch counts zeroed just before the timed steps and
    read just after: finite obs and reward of the env's width, exactly
    frame_skip vpu launches per control step and no mxu one."""
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.models.actor_critic import ActorCritic
    from quadruped_tpu_torch.ops import newton as N

    env = Go1Env(cfg, device=dev)
    policy = ActorCritic(obs_dim=env.obs_dim, act_dim=env.nu, device=dev,
                         generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = env.reset(B, gen)
    obs = env.obs(state)
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def control_step(state, obs):
        nonlocal finite
        action, *_ = policy.sample(obs, gen)
        state, obs, reward, *_ = env.step_autoreset(state, action, gen)
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
        return state, obs

    for _ in range(warm):
        state, obs = control_step(state, obs)
    torch.cuda.synchronize()
    for m in MODES:
        N.newton_solve.launches[m] = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, obs = control_step(state, obs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(N.newton_solve.launches)
    if not bool(finite):
        raise RuntimeError(f"non-finite obs or reward ({name})")
    if tuple(obs.shape) != (B, env.obs_dim):
        raise RuntimeError(f"obs shape {tuple(obs.shape)} ({name})")
    expect = {"vpu": env.cfg.frame_skip * steps, "mxu": 0}
    if counts != expect:
        raise RuntimeError(f"{name}: Newton kernel launched {counts}, expected {expect}")
    row = {"env_steps_per_s": B * steps / dt, "launches": counts,
           "obs_dim": env.obs_dim, "iterations": env.m.opt.iterations,
           "candidates": env.pipeline.table.ncand, "slots": slots_of(env)}
    log(f"breadth [{name}]: {steps} timed control steps x {B} envs in "
        f"{dt:.4f} s: {B * steps / dt:.1f} env control steps/s; obs "
        f"{env.obs_dim}; {row['candidates']} candidates, {row['slots']} "
        f"slots, {row['iterations']} Newton iterations; Newton launches "
        f"{counts} ({counts['vpu'] / steps:g} per control step)")
    return env, state, row


def kernel_set(name, env, state, seed, report):
    """The kernel in both modes against its plain version on a path's
    states (check_kernel_set), at the env's own Newton iterations, then
    timed there with its bound."""
    its = env.m.opt.iterations
    B = state.qpos.shape[0]
    args, kw = solver_inputs(env, state.qpos, state.qvel,
                             torch.zeros((B, env.nu), device=state.qpos.device),
                             state.params)
    errs = check_kernel_set(name, args, kw, its, seed)
    t = time_kernel(args, kw, its)
    log_timing(name, B, its, t)
    flops_all, gram_all, bytes_all = newton_counts(args, kw, its, active_only=False)
    t["bound_ms_every_slot"] = bound_ms(flops_all, gram_all, bytes_all, "vpu")[0]
    log(f"kernel timing [{name}]: counting every slot, {flops_all / 1e9:.3f} "
        f"GFLOP, {bytes_all / 1e6:.2f} MB, bound {t['bound_ms_every_slot']:.4f} ms")
    report[name] = {"iterations": its, "errors": errs, "timing": t,
                    "layout": dict(nf=kw["nf"], nl=kw["nl"], K=args[9].shape[1],
                                   pool_dims=kw["pool_dims"])}


def phase_plane(env, seed, kset):
    """The plane path beyond its option run: the kernel's launch plan on
    its layout (envs per SM from the occupancy API, shared bytes per env,
    registers, spills) in both modes, and one PPO train_iteration at
    PPOConfig() with QTPU_GRAM unset (320 vpu launches, no mxu)."""
    from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig
    from quadruped_tpu_torch.ops import newton as N

    lay = kset["layout"]
    res = {mode: N.kernel_resources(env.m.nv, lay["nf"], lay["nl"], lay["K"],
                                    lay["pool_dims"], mode) for mode in MODES}
    for mode in MODES:
        log(f"kernel resources [plane] {mode}: nf {lay['nf']}, nl {lay['nl']}, "
            f"{lay['K']} slots in pools {lay['pool_dims']}: "
            + json.dumps(res[mode]))
    trainer = PPO(env, PPOConfig())
    ts = trainer.init(seed)
    torch.cuda.synchronize()
    _ts, row = train_iteration(trainer, ts, "vpu", "breadth plane train iteration")
    return {"kernel_resources": res, "train": row}


def phase_breadth(dev, B, seed):
    """(a) The training CLI's default env, Go1Config(ctrl_type="position")
    with every other field at its default (full table, 48 uniform 6-row
    slots, the model's 15 Newton iterations, full reward profile): PPO.init
    and one train_iteration at PPOConfig() with QTPU_GRAM unset, 320 vpu
    launches and no mxu one; its states after the iteration as a kernel
    input set.  (b) Each other option at B envs (breadth_configs), 3
    warm-up and 5 timed control steps, and one step_autoreset on the card
    against the CPU; the Go2, terrain and plane runs' states as kernel
    input sets (a new model; contact normals that are not vertical; the
    floor-only table's 116 slots in condim runs).  (c) The plane path's
    kernel resources and one PPO iteration (phase_plane)."""
    from quadruped_tpu_torch.env.config import Go1Config
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig

    if os.environ.get("QTPU_GRAM") is not None:
        raise RuntimeError("QTPU_GRAM must be unset for the breadth phase")
    out = {"kernel_sets": {}, "options": {}, "reference": {}}
    env = Go1Env(Go1Config(ctrl_type="position"), device=dev)
    trainer = PPO(env, PPOConfig())
    ts = trainer.init(seed)
    torch.cuda.synchronize()
    ts, out["cli_train"] = train_iteration(
        trainer, ts, "vpu", "breadth cli-default train iteration")
    out["reference"]["cli"] = reference_autoreset(env, seed, "cli")
    kernel_set("cli_uniform", env, ts.env_state, seed, out["kernel_sets"])
    del trainer, ts, env
    for name, cfg in breadth_configs().items():
        env, state, row = run_option(name, cfg, dev, B, seed)
        out["options"][name] = row
        out["reference"][name] = reference_autoreset(env, seed, name)
        if name in ("go2", "terrain", "plane"):
            kernel_set(name, env, state, seed, out["kernel_sets"])
        if name == "plane":
            out["plane"] = phase_plane(env, seed, out["kernel_sets"]["plane"])
        del env, state
    return out


class _Instrument:
    """Wraps the runner's iteration, evaluation and checkpoint functions
    for the runner phase: times each call (device synchronized before and
    after), keeps the train metrics, and copies the train state at each
    save and just after each load to the host.  The wrappers count and
    time; they change no result."""

    def __init__(self):
        from quadruped_tpu_torch import checkpoint as ckpt
        from quadruped_tpu_torch.learn.runner import Runner

        from quadruped_tpu_torch.viz.render import TrajectoryRenderer

        self.rows = {"_iterate": [], "evaluate": [], "save_train_state": [],
                     "save_policy": [], "load_train_state": [],
                     "load_policy": [], "frames": []}
        self.saved, self.loaded, self.metrics = {}, {}, []
        self._undo = []
        inst = self

        def timed(owner, name, after=None):
            orig = getattr(owner, name)

            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inst.rows[name].append((dt, after(a, out) if after else None))
                return out

            setattr(owner, name, wrapper)
            self._undo.append((owner, name, orig))

        def iterate(a, out):
            inst.metrics.append(out[1])

        def evaluate(a, out):
            return tuple(out[3]["qpos"].shape[:2])     # (envs, steps)

        def save(a, out):
            inst.saved[Path(a[0]).name] = host_train_state(a[1])

        def load(a, out):
            inst.loaded[Path(a[0]).name] = host_train_state(out[0])

        def frames(a, out):     # (backend, frames, fk device)
            return a[0].backend, len(out), str(a[0].device)

        timed(Runner, "_iterate", iterate)
        timed(Runner, "evaluate", evaluate)
        timed(ckpt, "save_train_state", save)
        timed(ckpt, "save_policy")
        timed(ckpt, "load_train_state", load)
        timed(ckpt, "load_policy")
        timed(TrajectoryRenderer, "frames", frames)

    def restore(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def host_train_state(ts) -> dict:
    """Params and Adam state of a TrainState, copied to the host."""
    return {
        "policy": {k: v.detach().cpu().clone()
                   for k, v in ts.policy.state_dict().items()},
        "optimizer": {i: {k: v.detach().cpu().clone() for k, v in s.items()}
                      for i, s in ts.optimizer.state_dict()["state"].items()},
    }


def same_state(a: dict, b: dict) -> bool:
    return (a["policy"].keys() == b["policy"].keys()
            and all(torch.equal(a["policy"][k], b["policy"][k]) for k in a["policy"])
            and a["optimizer"].keys() == b["optimizer"].keys()
            and all(a["optimizer"][i].keys() == b["optimizer"][i].keys()
                    and all(torch.equal(v, b["optimizer"][i][k])
                            for k, v in a["optimizer"][i].items())
                    for i in a["optimizer"]))


def zero_launches():
    from quadruped_tpu_torch.ops import newton as N

    for m in MODES:
        N.newton_solve.launches[m] = 0


def read_launches(label, expect_vpu):
    from quadruped_tpu_torch.ops import newton as N

    counts = dict(N.newton_solve.launches)
    expect = {"vpu": expect_vpu, "mxu": 0}
    if counts != expect:
        raise RuntimeError(f"{label}: Newton kernel launched {counts}, "
                           f"expected {expect}")
    return counts


def finite_gait(g: dict, label: str):
    """Every gait metric finite; tracking_error may be NaN only where no
    step was healthy (the reference's convention)."""
    bad = [k for k, v in g.items() if not math.isfinite(v)
           and not (k == "tracking_error" and g["healthy_frac"] == 0.0)]
    if bad:
        raise RuntimeError(f"{label}: non-finite gait metrics {bad}")


def video_frames(path: Path) -> int:
    """The frames cv2 decodes from an MP4 (0 for an unreadable file)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def check_monitor(work: Path, videos: list) -> dict:
    """monitor.server.serve(background=True) over the run's working
    directory, on a free loopback port: /api/videos lists exactly the
    training videos, and a range request on one of them is answered 206
    with the file's bytes of that range."""
    import urllib.request

    from quadruped_tpu_torch.monitor.server import serve

    httpd = serve(port=0, base=str(work), background=True)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/api/videos", timeout=30) as r:
            listed = sorted(v["name"] for v in json.loads(r.read()))
        if listed != sorted(v.name for v in videos):
            raise RuntimeError(f"monitor lists {listed}, expected "
                               f"{sorted(v.name for v in videos)}")
        data = videos[0].read_bytes()
        lo, hi = 10, min(len(data) - 1, 70_000)
        req = urllib.request.Request(url + f"/stream/{videos[0].name}",
                                     headers={"Range": f"bytes={lo}-{hi}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            status, body = r.status, r.read()
            crange = r.headers["Content-Range"]
        if status != 206 or body != data[lo:hi + 1] or \
                crange != f"bytes {lo}-{hi}/{len(data)}":
            raise RuntimeError(f"monitor range request: status {status}, "
                               f"{len(body)} bytes, Content-Range {crange}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"runner monitor (monitor.server.serve over the work directory): "
        f"/api/videos lists {listed}; /stream/{videos[0].name} with Range "
        f"bytes={lo}-{hi}: 206, {len(body)} bytes equal to the file's")
    return {"listed": listed, "range": [lo, hi], "status": status}


def print_tree(root: Path):
    log(f"runner work directory {root.name}:")
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root)
        size = f" ({p.stat().st_size} B)" if p.is_file() else "/"
        log(f"  {rel.as_posix()}{size}")


RUN_ENVS = 4096
RUN_ITER_STEPS = RUN_ENVS * 32        # PPOConfig().n_steps
EVAL_STEPS = 50                       # --eval_max_time 1.0 at dt 0.02
VIDEO_FRAMES = 50                     # every = int(1 / (0.02 * 30)) = 1


def phase_runner(seed):
    """The training CLI on the card, then what a user runs on its
    artifacts, in a temporary working directory (the runner writes
    models/, logs/ and training_progress.png into the cwd), removed at
    the end after its file tree is printed:

    (1) `cli.train.main(["--run", "train", ...])` at the CLI's default
        env and PPOConfig() (4096 envs x 32 steps), 2 iterations, an
        eval of 50 control steps at 2 envs, a checkpoint and a video
        after each: exactly 2 x 320 + 2 x 50 x 10 = 1,640 vpu launches
        and no mxu one; best_model, checkpoint_131072, final_model,
        training_history.json with 2 evals, a tfevents file, the spool
        trajectories/eval_131072.qtl read back with nq 19 and 50
        records; finite metrics.
    (2) Resume from checkpoint_131072 (with the run's history as it was
        at that step beside it, as a persisted snapshot carries it):
        one iteration (131072 -> 262144), the loaded params and Adam
        state bit for bit those saved, the history reloaded.
    Then the videos: one MP4 per eval (3) of 50 frames in
        training_videos/, and the monitor server over the directory.
    (3) Playback: best_model through cli.train.run_test (`--run test
        --record_test_episodes`), 5 episodes cut to 1 s of sim time, one
        MP4 per episode of as many frames as the episode's steps.
    (4) The gate on best_model, 8 episodes of 1 s.
    (5) The capacity probe at 1024, 4096 and 16384 envs, 5 steps.
    Prints the iteration seconds, the eval seconds and ms per eval
    control step at 2, 5 and 8 envs, the projected eval share of a run
    at the CLI defaults, checkpoint save and load ms and the capacity
    table."""
    import shutil
    import tempfile

    from quadruped_tpu_torch.checkpoint import TrainingHistory
    from quadruped_tpu_torch.cli import capacity
    from quadruped_tpu_torch.cli import train as cli
    from quadruped_tpu_torch.learn.gate import evaluate_gate
    from quadruped_tpu_torch.native import read_log

    if os.environ.get("QTPU_GRAM") is not None:
        raise RuntimeError("QTPU_GRAM must be unset for the runner phase")
    rep = {"launches": {}}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_runner_"))
    cwd = os.getcwd()
    inst = _Instrument()
    try:
        os.chdir(work)
        train_argv = [
            "--run", "train", "--num_parallel_envs", str(RUN_ENVS),
            "--eval_frequency", str(RUN_ITER_STEPS),
            "--checkpoint_interval", str(RUN_ITER_STEPS),
            "--eval_max_time", "1.0", "--seed", str(seed),
            "--video_interval", str(RUN_ITER_STEPS), "--run_name", "smoke",
        ]
        # (1) train
        zero_launches()
        t0 = time.perf_counter()
        _ts, history, run_dir = cli.main(
            train_argv + ["--total_timesteps", str(2 * RUN_ITER_STEPS)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        rep["launches"]["train"] = read_launches(
            "runner train", 2 * 320 + 2 * EVAL_STEPS * 10)
        run_dir = work / run_dir
        ck = run_dir / f"checkpoint_{RUN_ITER_STEPS}"
        need = [run_dir / "best_model" / "policy.pt",
                run_dir / "best_model" / "metadata.json",
                ck / "train_state.pt", ck / "metadata.json",
                run_dir / "final_model" / "train_state.pt",
                run_dir / "training_history.json"]
        missing = [str(p.relative_to(work)) for p in need if not p.exists()]
        if missing:
            raise RuntimeError(f"runner train: missing {missing}")
        if not list((work / "logs").rglob("events.out.tfevents.*")):
            raise RuntimeError("runner train: no tfevents file")
        h = TrainingHistory.load(run_dir / "training_history.json")
        if h.series["timesteps"] != [RUN_ITER_STEPS, 2 * RUN_ITER_STEPS]:
            raise RuntimeError(f"runner train: evals at {h.series['timesteps']}")
        steps, rewards, qpos = read_log(
            run_dir / "trajectories" / f"eval_{RUN_ITER_STEPS}.qtl")
        if qpos.shape != (EVAL_STEPS, 19) or len(steps) != EVAL_STEPS:
            raise RuntimeError(f"runner train: spool holds {qpos.shape}")
        if not (np.isfinite(qpos).all() and np.isfinite(rewards).all()):
            raise RuntimeError("runner train: non-finite spool")
        for m in inst.metrics:
            bad = [k for k, v in m.items() if not math.isfinite(v)]
            if bad:
                raise RuntimeError(f"runner train: non-finite metrics {bad}")
        if not all(math.isfinite(v) for k in ("rewards", "lengths")
                   for v in h.series[k]):
            raise RuntimeError("runner train: non-finite eval reward or length")
        finite_gait(json.loads(
            (run_dir / "best_model" / "metadata.json").read_text())["gait_metrics"],
            "runner train")
        iters = [dt for dt, _ in inst.rows["_iterate"]]
        evals = [(dt, shape) for dt, shape in inst.rows["evaluate"]]
        log(f"runner train (cli.train.main, CLI-default env, {RUN_ENVS} envs "
            f"x 32 steps, 2 iterations, an eval of {EVAL_STEPS} control steps "
            f"at 2 envs after each): {train_s:.3f} s in all; iterations "
            + ", ".join(f"{dt:.3f}" for dt in iters) + " s; evals "
            + ", ".join(f"{dt:.3f} s ({1e3 * dt / s[1]:.2f} ms per control "
                        f"step at {s[0]} envs)" for dt, s in evals)
            + f"; Newton launches {rep['launches']['train']}; eval rewards "
            f"{h.series['rewards']}, lengths {h.series['lengths']}; approx_kl "
            + ", ".join(f"{m['approx_kl']:.4e}" for m in inst.metrics))

        # (2) resume from the first checkpoint, with the history as it
        # stood at that step beside it
        payload = json.loads((run_dir / "training_history.json").read_text())
        for k in TrainingHistory.FIELDS:
            payload[k] = payload[k][:1]
        payload["gait"] = {k: v[:1] for k, v in payload["gait"].items()}
        payload["best_reward"] = payload["best_score"] = payload["rewards"][0]
        (ck / "training_history.json").write_text(json.dumps(payload))
        n_it, n_ev = len(inst.rows["_iterate"]), len(inst.rows["evaluate"])
        zero_launches()
        _ts, h2, run2 = cli.main(
            train_argv + ["--run_name", "resumed", "--total_timesteps",
                          str(2 * RUN_ITER_STEPS), "--model_path", str(ck)])
        torch.cuda.synchronize()
        rep["launches"]["resume"] = read_launches(
            "runner resume", 320 + EVAL_STEPS * 10)
        if len(inst.rows["_iterate"]) - n_it != 1 or len(inst.rows["evaluate"]) - n_ev != 1:
            raise RuntimeError("runner resume: not exactly one iteration and one eval")
        if h2.series["timesteps"] != [RUN_ITER_STEPS, 2 * RUN_ITER_STEPS]:
            raise RuntimeError(f"runner resume: history {h2.series['timesteps']}")
        final = json.loads((work / run2 / "final_model" / "metadata.json").read_text())
        if final != {"global_step": 2 * RUN_ITER_STEPS}:
            raise RuntimeError(f"runner resume: final metadata {final}")
        if not same_state(inst.saved[ck.name], inst.loaded[ck.name]):
            raise RuntimeError("runner resume: loaded state differs from the saved one")
        log(f"runner resume from {ck.name}: global step {RUN_ITER_STEPS} -> "
            f"{2 * RUN_ITER_STEPS} in one iteration "
            f"({inst.rows['_iterate'][-1][0]:.3f} s); params and Adam state "
            f"loaded bit for bit as saved; history reloaded, evals at "
            f"{h2.series['timesteps']}; Newton launches {rep['launches']['resume']}")

        # the videos: one per eval (2 in the run, 1 in the resume), each
        # of the first eval episode's 50 control steps at 30 fps
        videos = sorted((work / "training_videos").glob("*.mp4"))
        got = {v.name: video_frames(v) for v in videos}
        steps_named = sorted(int(v.name.split("_")[1][1:]) for v in videos)
        if steps_named != [RUN_ITER_STEPS, 2 * RUN_ITER_STEPS, 2 * RUN_ITER_STEPS] \
                or any(n != VIDEO_FRAMES for n in got.values()):
            raise RuntimeError(f"runner videos: {got}, expected 3 of "
                               f"{VIDEO_FRAMES} frames")
        drawn = inst.rows["frames"]
        log(f"runner videos (training_videos/, one per eval): "
            + ", ".join(f"{k} {n} frames" for k, n in got.items())
            + "; render backend, frames, fk device per video: "
            + "; ".join(f"{b} {n} on {d} in {dt:.3f} s" for dt, (b, n, d) in drawn))
        rep["videos"] = {"frames": got, "backends": [b for _dt, (b, _n, _d) in drawn],
                         "render_s": [dt for dt, _ in drawn]}
        rep["monitor"] = check_monitor(work, videos)

        # (3) playback through --run test (cli.train.run_test), episodes
        # cut to 1 s, each recorded (--record_test_episodes)
        best = run_dir / "best_model"
        meta = json.loads((best / "metadata.json").read_text())
        args = cli.fill_iface_defaults(cli.build_parser().parse_args(
            ["--run", "test", "--model_path", str(best),
             "--num_test_episodes", "5", "--seed", str(seed),
             "--record_test_episodes"]))
        make_config = cli.make_config
        cli.make_config = lambda a: dataclasses.replace(make_config(a),
                                                        max_episode_time=1.0)
        try:
            zero_launches()
            ep_rew, ep_len, success, out = cli.run_test(args, "cuda")
            torch.cuda.synchronize()
        finally:
            cli.make_config = make_config
        rep["launches"]["playback"] = read_launches("runner playback", EVAL_STEPS * 10)
        if out["qpos"].shape != (5, EVAL_STEPS, 19) or not (
                np.isfinite(ep_rew).all() and np.isfinite(out["qpos"]).all()):
            raise RuntimeError(f"runner playback: qpos {out['qpos'].shape}")
        finite_gait(out["gait_metrics"], "runner playback")
        recorded = {v.name: video_frames(v)
                    for v in sorted((work / "eval_videos").glob("*.mp4"))}
        names = [f"test_ep{i}_r{ep_rew[i]:.1f}.mp4" for i in range(5)]
        if sorted(recorded) != sorted(names) or any(
                n != int(ep_len[i]) for i, n in enumerate(recorded[k] for k in names)):
            raise RuntimeError(f"runner playback: recorded {recorded}, lengths "
                               f"{ep_len.tolist()}")
        rep["recorded"] = recorded
        log(f"runner playback (cli.train.run_test on {best.name}, metadata "
            f"ctrl_type {meta['ctrl_type']}, 5 episodes of 1 s, "
            f"--record_test_episodes): rewards "
            f"{np.round(ep_rew, 4).tolist()}, lengths {ep_len.tolist()}; "
            f"{inst.rows['evaluate'][-1][0]:.3f} s; recorded "
            + ", ".join(f"{k} {n} frames" for k, n in recorded.items())
            + f" ({inst.rows['frames'][-1][1][0]}); Newton launches "
            f"{rep['launches']['playback']}")

        # (4) the gate
        zero_launches()
        v = evaluate_gate(best, episodes=8, eval_time=1.0)
        torch.cuda.synchronize()
        rep["launches"]["gate"] = read_launches("runner gate", EVAL_STEPS * 10)
        keys = ("healthy_ok", "tracking_ok", "length_ok", "distance_ok",
                "stepping_ok", "gate")
        if any(not isinstance(v[k], bool) for k in keys):
            raise RuntimeError("runner gate: verdict keys")
        nums = {k: x for k, x in v.items()
                if not k.startswith("_") and k not in keys}
        finite_gait({k: float(x) for k, x in nums.items()}, "runner gate")
        log("runner gate (best_model, 8 episodes of 1 s): "
            + json.dumps({k: v[k] for k in (*nums, *keys)})
            + f"; Newton launches {rep['launches']['gate']}")

        # (5) capacity
        zero_launches()
        cap = capacity.probe([1024, 4096, 16384], steps=5)
        rep["launches"]["capacity"] = read_launches("runner capacity", 3 * 2 * 5 * 10)
        if len(cap) != 3 or not all(r["steps_per_sec"] > 0 and r["mem_gb"]
                                    for r in cap):
            raise RuntimeError(f"runner capacity: {cap}")
        print_tree(work)
    finally:
        inst.restore()
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    # the numbers
    evals = inst.rows["evaluate"]
    ms_step = {}
    for dt, (envs, steps) in evals:
        ms_step.setdefault(envs, []).append(1e3 * dt / steps)
    iters = [dt for dt, _ in inst.rows["_iterate"]]
    iter_s = float(np.mean(iters))
    ms2 = float(np.mean(ms_step[2]))
    # CLI defaults: a 1,000-step eval at 2 envs per 300,000 timesteps
    # (2.289 iterations of 131,072); the eval falls due every third
    # iteration at that batch (the first at step 131,072)
    eval_default_s = 1000 * ms2 / 1e3
    share = {n: eval_default_s / (eval_default_s + n * iter_s)
             for n in (300_000 / RUN_ITER_STEPS, 3)}
    save_ms = [1e3 * dt for dt, _ in inst.rows["save_train_state"]]
    policy_ms = [1e3 * dt for dt, _ in inst.rows["save_policy"]]
    load_ms = [1e3 * dt for dt, _ in inst.rows["load_train_state"]]
    loadp_ms = [1e3 * dt for dt, _ in inst.rows["load_policy"]]
    log(f"runner timing: iteration {iter_s:.3f} s (mean of {len(iters)}: "
        + ", ".join(f"{x:.3f}" for x in iters) + "); eval ms per control step "
        + "; ".join(f"{n} envs " + ", ".join(f"{x:.2f}" for x in v)
                    for n, v in sorted(ms_step.items())))
    log(f"runner projection at the CLI defaults (a 1,000-step eval at 2 envs "
        f"= {eval_default_s:.1f} s): eval share of wall time "
        f"{100 * share[300_000 / RUN_ITER_STEPS]:.1f}% per 300,000 timesteps "
        f"(2.289 iterations), {100 * share[3]:.1f}% at the actual cadence "
        f"(every third iteration)")
    log("runner checkpoints: save_train_state ms "
        + ", ".join(f"{x:.1f}" for x in save_ms) + "; save_policy ms "
        + ", ".join(f"{x:.1f}" for x in policy_ms) + "; load_train_state ms "
        + ", ".join(f"{x:.1f}" for x in load_ms) + "; load_policy ms "
        + ", ".join(f"{x:.1f}" for x in loadp_ms))
    log("runner capacity (torque, 48 uniform slots, 15 Newton iterations, "
        "5 steps): " + "; ".join(
            f"{r['n']} envs {r['steps_per_sec']:.1f} env control steps/s, first "
            f"call {r['first_call_s']:.2f} s, {r['mem_gb']:.3f} GB allocated "
            f"(peak {r['peak_gb']:.3f} GB)"
            for r in cap))
    rep.update(iteration_s=iters, eval_ms_per_step=ms_step,
               eval_share_cli_defaults={"per_300k": share[300_000 / RUN_ITER_STEPS],
                                        "every_third_iteration": share[3]},
               checkpoint_ms={"save_train_state": save_ms, "save_policy": policy_ms,
                              "load_train_state": load_ms, "load_policy": loadp_ms},
               capacity=cap)
    return rep


# the JAX package's committed orbax payloads, and the sha256 of each
# tree's leaves in sorted key order as little-endian bytes
# (checkpoint.orbax_format.tree_digest); tests/test_torch_orbax.py holds
# these to the digests of orbax's own restore
ORBAX_PAYLOADS = {
    "best_model": ROOT / "results" / "live" / "multigait-r5" / "best_model",
    "latest_checkpoint": ROOT / "results" / "live" / "multigait-r5"
                         / "latest_checkpoint",
    "walk_r5_progress": ROOT / "results" / "walk_r5_progress",
}
ORBAX_DIGESTS = {
    "best_model": "c913bcf600db7cdc52de287b4307a7b94cee919abb2c8ae3b89ac4b5dd767f62",
    "latest_checkpoint": "a3a7f9cc149d8a6ebec79e4147d1d86a9d82e6cbc83f5f1bcaddf8133f43b5f8",
    "walk_r5_progress": "4ef42cd604b03820204db632664dd9deb7296fba8d1c0ef7d04e8c62285be989",
}
ORBAX_GATE_TIME = 5.0              # s of sim per gate episode: 250 steps
ORBAX_RESUME = dict(envs=64, n_steps=8, eval_steps=5)


def orbax_read(name: str, path: Path) -> tuple:
    """(a) of the orbax phase for one payload -> (tree, row)."""
    from quadruped_tpu_torch.checkpoint.orbax_format import (nest, read_leaves,
                                                             tree_digest)

    sub = path / ("params" if name == "best_model" else "train_state")
    t0 = time.perf_counter()
    leaves = read_leaves(sub)
    read_s = time.perf_counter() - t0
    meta = json.loads((sub / "_METADATA").read_text())["tree_metadata"]
    for key, leaf in meta.items():
        keys = tuple(k["key"] for k in leaf["key_metadata"])
        a = leaves[keys]
        shape = leaf["value_metadata"].get("write_shape")
        if shape is None:
            if a is not None:
                raise RuntimeError(f"orbax read {name}: {key} is not None")
            continue
        want = {"count": np.int32, "rng": np.uint32}.get(keys[-1], np.float32)
        if a.shape != tuple(shape) or a.dtype != want:
            raise RuntimeError(f"orbax read {name}: {key} is {a.dtype} "
                               f"{a.shape}; expected {want.__name__} and "
                               f"_METADATA's write_shape {tuple(shape)}")
    tree = nest(leaves)
    digest = tree_digest(tree)
    if digest != ORBAX_DIGESTS[name]:
        raise RuntimeError(f"orbax read {name}: sha256 {digest}, expected "
                           f"{ORBAX_DIGESTS[name]}")
    arrays = [a for a in leaves.values() if a is not None]
    row = {"arrays": len(arrays), "array_bytes": sum(a.nbytes for a in arrays),
           "file_bytes": sum(f.stat().st_size for f in sub.rglob("*")
                             if f.is_file()),
           "read_s": read_s, "sha256": digest}
    log(f"orbax read {name} ({sub.relative_to(ROOT)}): {row['arrays']} "
        f"arrays, {row['array_bytes']} bytes of arrays from "
        f"{row['file_bytes']} bytes of files in {read_s:.3f} s; shapes as "
        f"_METADATA's write_shape, dtypes as expected; sha256 "
        f"{digest[:16]}... as orbax's restore")
    return tree, row


def phase_orbax(seed):
    """The JAX package's orbax checkpoints on the card host, through the
    port's reader (checkpoint/zstd.py, ocdbt.py, orbax_format.py: no JAX,
    orbax, tensorstore or zstandard), in a temporary working directory:

    (a) Read the three committed payloads: each leaf's shape as
        _METADATA's write_shape, its dtype int32 for Adam's count, uint32
        for the JAX key, float32 else; each tree's sha256 the constant that
        tests/test_torch_orbax.py ties to orbax's restore.
    (b) The gate on results/walk_r5_progress (a train_state/ layout, read
        through load_policy_any), 8 episodes of 5 s (250 control steps):
        healthy_ok, length_ok and stepping_ok true, as the JAX package's
        20-s gate found them (metadata.json's gate_eval).
    (c) Playback of multigait-r5/best_model (params/: gait conditioning,
        53-dim obs) through cli.train.run_test, 4 envs x 50 control
        steps: finite metrics, every episode healthy throughout.
    (d) `--run train --model_path multigait-r5/latest_checkpoint`: one
        iteration at 64 envs x 8 steps and an eval of 5 steps; the Adam
        step and moments and the params it restores bit-equal, on the
        host, to the arrays (a) read; global_step continuing from
        metadata.json's; finite loss and approx_kl; the port checkpoint
        it writes (final_model) reloading to the state saved.
    """
    import shutil
    import tempfile

    from quadruped_tpu_torch import checkpoint as ckpt
    from quadruped_tpu_torch.cli import train as cli
    from quadruped_tpu_torch.convert import opt_state_from_jax, policy_from_jax
    from quadruped_tpu_torch.learn.gate import evaluate_gate

    if os.environ.get("QTPU_GRAM") is not None:
        raise RuntimeError("QTPU_GRAM must be unset for the orbax phase")
    rep = {"read": {}, "launches": {}}
    trees = {}
    for name, path in ORBAX_PAYLOADS.items():
        trees[name], rep["read"][name] = orbax_read(name, path)

    # (b) the gate on the train-state layout
    walk = ORBAX_PAYLOADS["walk_r5_progress"]
    jax_gate = json.loads((walk / "metadata.json").read_text())["gate_eval"]
    steps = int(ORBAX_GATE_TIME / 0.02)
    zero_launches()
    t0 = time.perf_counter()
    v = evaluate_gate(walk, episodes=8, eval_time=ORBAX_GATE_TIME)
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    rep["launches"]["gate"] = read_launches("orbax gate", steps * 10)
    nums = ("healthy_frac", "mean_length", "touchdowns_per_sec",
            "tracking_error", "distance", "distance_floor", "feet_airtime")
    oks = ("healthy_ok", "length_ok", "stepping_ok", "tracking_ok",
           "distance_ok", "gate")
    finite_gait({k: float(v[k]) for k in nums}, "orbax gate")
    held = [k for k in ("healthy_ok", "length_ok", "stepping_ok") if not v[k]]
    if held:
        raise RuntimeError(f"orbax gate: {held} false where the JAX package's "
                           f"20-s gate has them true: "
                           + json.dumps({k: v[k] for k in (*nums, *oks)}))
    rep["gate"] = {k: v[k] for k in (*nums, *oks)}
    rep["gate"].update(episodes=8, eval_time_s=ORBAX_GATE_TIME, seconds=gate_s)
    log(f"orbax gate (walk_r5_progress/train_state via load_policy_any, 8 "
        f"episodes of {ORBAX_GATE_TIME} s): {gate_s:.1f} s; port "
        + json.dumps({k: v[k] for k in (*nums, *oks)})
        + "; JAX package at 20 s (gate_eval) "
        + json.dumps({k: jax_gate[k] for k in (*nums, *oks)})
        + f"; Newton launches {rep['launches']['gate']}")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_orbax_"))
    cwd = os.getcwd()
    inst = _Instrument()
    try:
        os.chdir(work)
        # (c) playback of the params layout through --run test
        best = ORBAX_PAYLOADS["best_model"]
        args = cli.fill_iface_defaults(cli.build_parser().parse_args(
            ["--run", "test", "--model_path", str(best),
             "--num_test_episodes", "4", "--seed", str(seed)]))
        make_config = cli.make_config
        cli.make_config = lambda a: dataclasses.replace(make_config(a),
                                                        max_episode_time=1.0)
        try:
            zero_launches()
            t0 = time.perf_counter()
            ep_rew, ep_len, _success, out = cli.run_test(args, "cuda")
            torch.cuda.synchronize()
            play_s = time.perf_counter() - t0
        finally:
            cli.make_config = make_config
        rep["launches"]["playback"] = read_launches("orbax playback", 50 * 10)
        g = out["gait_metrics"]
        finite_gait(g, "orbax playback")
        if args.gait_conditioning is not True or not inst.rows["load_policy"]:
            raise RuntimeError("orbax playback: not the gait-conditioned env "
                               "or no load_policy call")
        if not (np.isfinite(ep_rew).all() and (ep_len == 50).all()
                and np.asarray(out["healthy"]).all()):
            raise RuntimeError(f"orbax playback: rewards {ep_rew}, lengths "
                               f"{ep_len}, healthy_frac {g['healthy_frac']}")
        rep["playback"] = {"rewards": ep_rew.tolist(), "lengths": ep_len.tolist(),
                           "gait_metrics": g, "seconds": play_s}
        log(f"orbax playback (cli.train.run_test on multigait-r5/best_model "
            f"params/, 4 episodes of 50 control steps, gait-conditioned, "
            f"53-dim obs): {play_s:.1f} s; rewards "
            f"{np.round(ep_rew, 4).tolist()}, lengths {ep_len.tolist()}, "
            f"every step healthy; tracking_error {g['tracking_error']:.4f}, "
            f"touchdowns_per_sec {g['touchdowns_per_sec']:.3f}; Newton "
            f"launches {rep['launches']['playback']}")

        # (d) resume from the JAX package's train_state/
        latest = ORBAX_PAYLOADS["latest_checkpoint"]
        step0 = json.loads((latest / "metadata.json").read_text())["global_step"]
        r = ORBAX_RESUME
        per_iter = r["envs"] * r["n_steps"]
        zero_launches()
        t0 = time.perf_counter()
        ts, _h, run_dir = cli.main([
            "--run", "train", "--model_path", str(latest),
            "--gait_conditioning", "--action_mode", "centered",
            "--num_parallel_envs", str(r["envs"]), "--n_steps", str(r["n_steps"]),
            "--num_minibatches", "2", "--n_epochs", "1",
            "--total_timesteps", str(step0 + per_iter),
            "--eval_max_time", str(r["eval_steps"] * 0.02), "--no_videos",
            "--seed", str(seed), "--run_name", "orbax_resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        rep["launches"]["resume"] = read_launches(
            "orbax resume", (r["n_steps"] + r["eval_steps"]) * 10)
        tree = trees["latest_checkpoint"]
        cpu_policy = policy_from_jax(tree["params"], device="cpu")
        adam = opt_state_from_jax(tree["opt_state"]["1"]["0"], cpu_policy)
        want = [adam[p] for p in cpu_policy.parameters()]   # optimizer order
        loaded = inst.loaded[latest.name]
        same_params = all(torch.equal(loaded["policy"][k], w)
                          for k, w in cpu_policy.state_dict().items())
        same_adam = len(loaded["optimizer"]) == len(want) and all(
            torch.equal(loaded["optimizer"][i][k], w[k])
            for i, w in enumerate(want) for k in ("step", "exp_avg", "exp_avg_sq"))
        if not (same_params and same_adam):
            raise RuntimeError(f"orbax resume: restored params equal {same_params}, "
                               f"Adam state equal {same_adam} to the arrays read")
        final = work / run_dir / "final_model"
        final_meta = json.loads((final / "metadata.json").read_text())
        if final_meta.get("global_step") != step0 + per_iter:
            raise RuntimeError(f"orbax resume: final metadata {final_meta}")
        m = inst.metrics[-1]
        if len(inst.metrics) != 1 or not all(
                math.isfinite(m[k]) for k in ("loss", "approx_kl")):
            raise RuntimeError(f"orbax resume: metrics {inst.metrics}")
        ckpt.load_train_state(final, ts)
        if not same_state(inst.saved["final_model"], inst.loaded["final_model"]):
            raise RuntimeError("orbax resume: final_model reloads to another state")
        rep["resume"] = {"global_step": [step0, final_meta["global_step"]],
                         "approx_kl": m["approx_kl"], "loss": m["loss"],
                         "adam_step": float(want[0]["step"]), "seconds": resume_s}
        log(f"orbax resume (cli.train.main --model_path "
            f"multigait-r5/latest_checkpoint, {r['envs']} envs x "
            f"{r['n_steps']} steps, one iteration and an eval of "
            f"{r['eval_steps']} steps): {resume_s:.1f} s; params and Adam state "
            f"(step {float(want[0]['step']):.0f}) restored bit for bit as read; "
            f"global step {step0} -> {final_meta['global_step']}; loss "
            f"{m['loss']:.4e}, approx_kl {m['approx_kl']:.4e}; final_model "
            f"reloads to the state saved; Newton launches "
            f"{rep['launches']['resume']}")
    finally:
        inst.restore()
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return rep


PAR_RANKS = 2               # gloo ranks sharing the card
PAR_TIMEOUT_S = 300.0       # a rank set that runs longer is killed: failure
COLLECTIVE_REPS = 50
EQUIV_ENVS = 512            # part (b): 2 ranks x 256 against one process
EQUIV_MOVED = 8             # part (b): the single process's moved runs


def parallel_train_rank(rank, world_size, init_method, seed, reps):
    """Part (a), one gloo rank on the card: the configuration of record at
    PPOConfig() (4096 envs global), init_sharded, then one
    multichip_train_iteration with the phase timer on (vpu 320 launches,
    mxu none), then the minibatch collective alone: `reps` all-reduces of
    a buffer of the gradient's size, each followed by a device sync."""
    import torch.distributed as dist

    from quadruped_tpu_torch.env.config import Go1Config
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig
    from quadruped_tpu_torch.parallel.mesh import (init_sharded, make_mesh,
                                                   multichip_train_iteration)
    from quadruped_tpu_torch.timing import TIMER
    from torch_parallel_ranks import flat_params

    dev = torch.device("cuda")
    group = make_mesh(world_size, rank, "gloo", init_method)
    env = Go1Env(Go1Config(**RECORD), device=dev)
    trainer = PPO(env, PPOConfig(), group=group)
    ts = init_sharded(trainer, seed, rank, world_size)
    params0 = flat_params(ts.policy)
    torch.cuda.synchronize()
    dist.barrier(group=group)
    zero_launches()
    TIMER.reset()
    TIMER.enabled = True
    t0 = time.perf_counter()
    ts, metrics = multichip_train_iteration(trainer, ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    TIMER.enabled = False
    launches = read_launches(f"parallel train rank {rank}",
                             env.cfg.frame_skip * trainer.cfg.n_steps)
    phases = TIMER.totals_ms()
    buf = torch.zeros(params0.numel(), device=dev)
    trainer.all_reduce_mean(buf)
    torch.cuda.synchronize()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.all_reduce_mean(buf)
        torch.cuda.synchronize()
    coll_ms = (time.perf_counter() - t0) / reps * 1e3
    params = flat_params(ts.policy)
    return dict(
        envs=ts.obs.shape[0], launches=launches,
        rollout_s=phases["rollout"] / 1e3, update_s=phases["update"] / 1e3,
        iteration_s=dt, collective_ms=coll_ms, collective_floats=buf.numel(),
        params=params, moved=(params - params0).abs().max().item(),
        lr_mult=ts.lr_mult.cpu(),
        metrics={k: v.item() for k, v in metrics.items()},
    )


def replicas_equal(ranks, label) -> float:
    """The ranks' params and lr_mult must be bit-equal: returns the max
    abs diff of the params across ranks (0.0)."""
    diff = max((r["params"] - ranks[0]["params"]).abs().max().item()
               for r in ranks)
    if diff != 0.0 or not all(torch.equal(r["lr_mult"], ranks[0]["lr_mult"])
                              for r in ranks):
        raise RuntimeError(f"{label}: the replicas differ (params max abs "
                           f"diff {diff:.3e})")
    return diff


def phase_parallel(seed, single):
    """Data parallelism over a gloo process group, ranks spawned by
    quadruped_tpu_torch.parallel.mesh.spawn_ranks (each its own process
    and CUDA context, all on this card):

    (a) the slice at full width: 2 ranks x 2048 envs of RECORD at
        PPOConfig() (4096 envs x 32 steps global, 10 epochs x 32
        minibatches), one multichip_train_iteration each: 320 vpu
        launches per rank, finite metrics, params and lr_mult bit-equal
        across the ranks, params moved.  Per rank and in aggregate the
        rollout's env control steps/s, update s, iteration s and the
        minibatch collective's ms, beside `single` (the train phase's vpu
        iteration at the same config in this call).
    (b) equivalence: 2 ranks x 256 envs against one process (this one) on
        the same 512 envs of RECORD, fallen starts included, with
        tests/torch_parallel_ranks.py's rank function and check: the
        mean-sample policy, n_steps 2, one minibatch, one epoch, no
        advantage normalization; test_multichip_equiv.py's tolerances,
        or 3 x the float32 noise floor of EQUIV_MOVED runs of the single
        process with its actions moved by one rounding, where larger.
    (c) dryrun_multichip(2, backend="gloo") and one NCCL rank
        (dryrun_multichip(1, backend="nccl")), 20 vpu launches per rank.
    Any rank's failure, a refused backend or a rank set past
    PAR_TIMEOUT_S raises."""
    from quadruped_tpu_torch.parallel.dryrun import dryrun_multichip
    from quadruped_tpu_torch.parallel.mesh import spawn_ranks

    sys.path.insert(0, str(ROOT / "tests"))   # the ranks inherit sys.path
    from torch_parallel_ranks import (check_equivalence, iteration_rank,
                                      single_iteration)

    if os.environ.get("QTPU_GRAM") is not None:
        raise RuntimeError("QTPU_GRAM must be unset for the parallel phase")
    rep = {"launches": {}}
    # (a)
    t0 = time.perf_counter()
    ranks = spawn_ranks(parallel_train_rank, PAR_RANKS,
                        (seed, COLLECTIVE_REPS), PAR_TIMEOUT_S)
    wall = time.perf_counter() - t0
    steps = 32
    for r, row in enumerate(ranks):
        bad = [k for k, v in row["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"parallel train rank {r}: non-finite {bad}")
        if not row["moved"] > 0.0:
            raise RuntimeError(f"parallel train rank {r}: params unchanged")
        row["env_steps_per_s"] = row["envs"] * steps / row["rollout_s"]
        rep["launches"][f"parallel train rank {r}"] = row["launches"]
        log(f"parallel train rank {r} of {PAR_RANKS} (gloo, one card): "
            f"{row['envs']} envs x {steps} steps; rollout "
            f"{row['rollout_s']:.3f} s = {row['env_steps_per_s']:.1f} env "
            f"control steps/s; update {row['update_s']:.3f} s; iteration "
            f"{row['iteration_s']:.3f} s; collective "
            f"{row['collective_ms']:.4f} ms per minibatch "
            f"({row['collective_floats']} floats, mean of {COLLECTIVE_REPS}, "
            f"device synchronized); Newton launches {row['launches']}")
    diff = replicas_equal(ranks, "parallel train")
    total = sum(r["envs"] for r in ranks) * steps
    agg = dict(
        env_steps_per_s=total / max(r["rollout_s"] for r in ranks),
        env_steps_per_s_sum=sum(r["env_steps_per_s"] for r in ranks),
        update_s=max(r["update_s"] for r in ranks),
        iteration_s=max(r["iteration_s"] for r in ranks),
        collective_ms=max(r["collective_ms"] for r in ranks),
        spawn_wall_s=wall,
    )
    ratio = agg["env_steps_per_s"] / single["rollout_env_steps_per_s"]
    log(f"parallel train aggregate ({PAR_RANKS} gloo ranks on one card, "
        f"{total} env control steps): {agg['env_steps_per_s']:.1f} env "
        f"control steps/s (over the slowest rollout; sum of the ranks' "
        f"{agg['env_steps_per_s_sum']:.1f}); update {agg['update_s']:.3f} s, "
        f"iteration {agg['iteration_s']:.3f} s (slowest rank); spawn to "
        f"join {wall:.1f} s | single process (train phase, this call): "
        f"{single['rollout_env_steps_per_s']:.1f} env control steps/s, "
        f"update {single['update_ms'] / 1e3:.3f} s, iteration "
        f"{single['iteration_s']:.3f} s | aggregate / single {ratio:.3f}")
    log(f"parallel replication: params max abs diff across the ranks {diff}, "
        f"lr_mult equal; largest param change {ranks[0]['moved']:.3e}; "
        f"approx_kl {ranks[0]['metrics']['approx_kl']:.4e}, loss "
        f"{ranks[0]['metrics']['loss']:.4f}")
    rep["train"] = dict(
        ranks=[{k: v for k, v in r.items() if k not in ("params", "lr_mult")}
               for r in ranks],
        aggregate=agg, aggregate_over_single=ratio,
        params_max_abs_diff_across_ranks=diff,
        single={k: single[k] for k in ("rollout_env_steps_per_s", "update_ms",
                                       "iteration_s")})
    # (b)
    ranks = spawn_ranks(iteration_rank, PAR_RANKS,
                        (EQUIV_ENVS, seed, "cuda", RECORD), PAR_TIMEOUT_S)
    one = single_iteration(EQUIV_ENVS, seed, "cuda", RECORD, moved=EQUIV_MOVED)
    err = check_equivalence(ranks, one)
    for r, row in enumerate(ranks + [one]):
        name = f"rank {r}" if r < PAR_RANKS else "single process"
        if row["launches"] != {"vpu": 20, "mxu": 0}:
            raise RuntimeError(f"parallel equivalence {name}: Newton launches "
                               f"{row['launches']}, expected 20 vpu")
        rep["launches"][f"parallel equivalence {name}"] = row["launches"]
    log(f"parallel equivalence ({PAR_RANKS} gloo ranks x "
        f"{EQUIV_ENVS // PAR_RANKS} envs against one process on {EQUIV_ENVS}, "
        f"{err['fallen_envs']} fallen starts, mean-sample policy, n_steps 2, "
        f"1 minibatch, 1 epoch): max abs diff metrics {err['metrics']:.3e}, "
        f"params {err['params']:.3e} (rtol 1e-5 / atol 1e-7), qpos "
        f"{err['qpos']:.3e} (atol 1e-5); noise floor over "
        f"{err['moved_runs']} moved runs: metrics {err['metrics_noise_floor']:.3e}, "
        f"params {err['params_noise_floor']:.3e}, fallen envs' qpos "
        f"{err['qpos_noise_floor']:.3e} (limit 3x where larger); largest "
        f"share of a limit: metrics {err['metrics_share_of_limit']:.3f}, params "
        f"{err['params_share_of_limit']:.3f}, qpos {err['qpos_share_of_limit']:.3f}; "
        f"Newton launches per rank {ranks[0]['launches']}, single "
        f"{one['launches']}")
    rep["equivalence"] = err
    # (c)
    for n, backend in ((PAR_RANKS, "gloo"), (1, "nccl")):
        out = dryrun_multichip(n, device="cuda", backend=backend,
                               timeout=PAR_TIMEOUT_S)
        for r, row in enumerate(out):
            if row["launches"] != {"vpu": 20, "mxu": 0}:
                raise RuntimeError(f"dryrun {backend} rank {r}: Newton launches "
                                   f"{row['launches']}, expected 20 vpu")
            bad = [k for k, v in row["metrics"].items() if not math.isfinite(v)]
            if bad:
                raise RuntimeError(f"dryrun {backend} rank {r}: non-finite {bad}")
            rep["launches"][f"parallel dryrun {backend} rank {r} of {n}"] = row["launches"]
        rep[f"dryrun_{backend}"] = out[0]["metrics"]
        log(f"parallel dryrun ({backend}, {n} rank(s) on {out[0]['device']}): "
            f"Newton launches per rank {[r['launches'] for r in out]}")
    log(f"parallel nccl across cards: not tried (this script runs on one "
        f"card; the host has {torch.cuda.device_count()})")
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    os.environ.pop("QTPU_GRAM", None)   # the phases select the mode

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    import quadruped_tpu_torch  # noqa: F401  (sets the precision rule)
    from quadruped_tpu_torch.env.config import Go1Config
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.models.actor_critic import ActorCritic
    from quadruped_tpu_torch.ops import build as kbuild

    # 2. build
    t0 = time.perf_counter()
    kbuild.build("newton", verbose=True)   # prints registers and spills
    log(f"build: newton.cu in {time.perf_counter() - t0:.2f} s "
        f"-> {kbuild.library_path('newton').name}")

    torch.manual_seed(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    env = Go1Env(Go1Config(**RECORD), device=dev)
    policy = ActorCritic(
        act_dim=env.nu, device=dev,
        generator=torch.Generator().manual_seed(args.seed),
    )

    # 3. kernels against their plain versions
    krep = phase_kernels(env, gen, dev, args.envs, args.seed)
    # 4. main path, then the small reference step
    mrep = phase_main(env, policy, gen, dev, args.envs, args.steps)
    phase_reference(env, args.seed)
    # 5. training, then the small reference update
    trep = phase_train(env, dev, args.seed)
    trep.update(phase_train_reference(args.seed))
    del env, policy
    # 6. every other env option, the training CLI's default env first
    brep = phase_breadth(dev, args.envs, args.seed)
    # 7. the training CLI, resume, playback, gate and capacity probe
    rrep = phase_runner(args.seed)
    # 8. the JAX package's orbax checkpoints: read, gate, playback, resume
    orep = phase_orbax(args.seed)
    # 9. data parallelism: gloo ranks on this card, the dry run, NCCL
    prep = phase_parallel(args.seed, trep["iterations"][0])

    # 10. report
    sets = ["reset", "after_steps", "stiff", *brep["kernel_sets"]]
    over = ("envs whose float32 solve is stable (noise floor <= 1e-4), "
            "2 Newton iterations, qacc and qfrc, over the input sets "
            + ", ".join(sets))
    by_path = {"breadth cli-default train iteration (QTPU_GRAM unset, "
               "32 control steps)": brep["cli_train"]["launches"],
               "breadth plane train iteration (QTPU_GRAM unset, 32 control "
               "steps)": brep["plane"]["train"]["launches"]}
    by_path.update({f"breadth {name}: 5 timed control steps, QTPU_GRAM unset":
                    row["launches"] for name, row in brep["options"].items()})
    by_path.update({
        f"runner {name}: {what}": rrep["launches"][name]
        for name, what in (
            ("train", "cli.train.main, 2 iterations + 2 evals of 50 control "
                      "steps at 2 envs"),
            ("resume", "cli.train.main from checkpoint_131072, 1 iteration + "
                       "1 eval of 50 steps at 2 envs"),
            ("playback", "cli.train.run_test --record_test_episodes, 5 envs "
                         "x 50 steps"),
            ("gate", "evaluate_gate, 8 envs x 50 steps"),
            ("capacity", "probe at 1024, 4096, 16384 envs, 2 x 5 steps each"),
        )})
    by_path.update({
        f"orbax {name}: {what}": orep["launches"][name]
        for name, what in (
            ("gate", f"evaluate_gate on walk_r5_progress, 8 envs x "
                     f"{int(ORBAX_GATE_TIME / 0.02)} steps"),
            ("playback", "cli.train.run_test on multigait-r5/best_model, 4 "
                         "envs x 50 steps"),
            ("resume", f"cli.train.main from multigait-r5/latest_checkpoint, "
                       f"1 iteration of {ORBAX_RESUME['n_steps']} steps + 1 "
                       f"eval of {ORBAX_RESUME['eval_steps']} steps"),
        )})
    for name, counts in prep["launches"].items():
        what = ("multichip_train_iteration, 2048 of 4096 envs x 32 control "
                "steps" if name.startswith("parallel train") else
                "one iteration of 2 control steps")
        by_path[f"{name}: {what}"] = counts
    kernels = []
    for mode, name, launches, launches_over in (
        ("vpu", "newton_solve", mrep["launches"],
         f"main path: {args.steps} timed control steps, QTPU_GRAM unset"),
        ("mxu", "newton_solve_mxu", trep["iterations"][1]["launches"]["mxu"],
         "train phase: the QTPU_GRAM=mxu train_iteration (32 control steps)"),
    ):
        r = krep[mode]
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            ks["errors"][mode]["max_abs_err"] for ks in brep["kernel_sets"].values()])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "quadruped_tpu_torch/csrc/newton.cu",
            "replaces": "quadruped_tpu/ops/newton.py:641"
                        + (' (gram_mode="mxu")' if mode == "mxu" else ""),
            "launches": launches,
            "launches_over": launches_over,
            "launches_by_path": {k: v[mode] for k, v in by_path.items()},
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_over": over,
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    log(json.dumps({
        "main": {"envs": args.envs, "control_steps": args.steps,
                 "env_steps_per_s": mrep["env_steps_per_s"],
                 "phases_ms": mrep["phases_ms"],
                 "kernel_on_main_states": mrep["kernel_on_main_states"]},
        "newton": {mode: {k: v for k, v in krep[mode].items()
                          if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "max_abs_err")}
                   for mode in MODES},
        "train": trep,
        "breadth": brep,
        "runner": rrep,
        "orbax": orep,
        "parallel": {k: v for k, v in prep.items() if k != "launches"},
    }))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
