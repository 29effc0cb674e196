"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--envs 4096] [--steps 20]

Phases, in order; any failure exits non-zero and prints no result line:
  1. device   CUDA must be available; prints the card's name and power
              limit (nvidia-smi).
  2. build    builds every kernel of the port from csrc/ with nvcc.
  3. kernels  holds each kernel against its plain PyTorch version on the
              card, on inputs from the port's own assemble at --envs envs
              (reset states, states after a few control steps, the stiff
              contact fixture of the tests), and times both.  At 2 Newton
              iterations every env whose float32 solve is stable agrees
              within 1e-3 (scaled as in tests/test_ops.py); every env is
              held against a float64 run within a limit set by its own
              float32 noise floor (see phase_kernels).  At 8
              iterations every output is finite.
  4. main     drives the configuration of record (Go1, torque, full
              collision table, condim pools (8, 28, 12), 8 Newton
              iterations) through its entry points: policy sample, then
              Go1Env.step_autoreset, 3 warm-up and --steps timed control
              steps.  Checks that outputs are finite, that the Newton
              kernel launched exactly 10 times per control step, and that
              one control step on the card agrees with the plain path on
              the CPU at a small batch.  Prints control steps/s and the
              per-phase device ms.
  5. report   one JSON line listing each kernel (launches in the main
              path's timed run, max abs error against its plain version
              on the stable envs at 2 iterations, named in
              max_abs_err_over, times and bound), the
              card's name and power limit, and last the line
              {"ok": true, "device": {"platform": "gpu", ...}}.

Weights and states are random, made from --seed.  Nothing is fetched.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12     # HBM3 bytes/s, H100 SXM
RECORD = dict(ctrl_type="torque", solver_iterations=8,
              contact_pools=(8, 28, 12))


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

    m, pl = env.m, env.pipeline
    kin = fk(m, qpos, qvel)
    M, _L, _qf, qs, _qa = smooth_dynamics(m, params, kin, qpos, qvel, ctrl)
    efc = assemble(m, pl.layout, pl.table, kin, qpos, qvel)
    return newton_args(M, qs, torch.zeros_like(qs), efc)


def newton_counts(args, kw, iterations):
    """(FP32 operations, bytes) one launch needs on these inputs.

    Bytes: every input read once, every output written once.  Operations
    per env and iteration, counting a multiply-add as 2: z = J a - aref
    (2 ne nv), the row penalties and the rank-1 cone rows, grad (2 nv^2 +
    2 ne nv), the upper-triangle Gram over the J rows and the 3 rank-1
    rows per friction contact (the weighted rows w J once, one multiply
    per row and column, then a multiply-add per row and pair), the Cholesky
    (nv^3/3 multiply-adds) and the two triangular solves (2 nv^2), J d and
    M d, and 18 penalty evaluations of the line search (17 ladder
    candidates and the parabolic vertex).  The Levenberg retry, taken
    only when the first factorization fails, is not counted (it adds one
    more Cholesky, under 2% of an iteration)."""
    M, J = args[0], args[3]
    B, nv, ne = M.shape[0], M.shape[-1], J.shape[1]
    nf, nl = kw["nf"], kw["nl"]
    K = args[9].shape[1]
    pools = kw["pool_dims"] or ((K, 6),)
    nu = sum(3 * Kp for Kp, dp in pools if dp > 1)
    cone_rows = sum(Kp * dp for Kp, dp in pools)
    per_con = sum(Kp * (8 * dp + 20) for Kp, dp in pools)  # u, zones, S
    rank1 = sum(Kp * nv * (2 * dp + 3) for Kp, dp in pools if dp > 1)
    npairs = nv * (nv + 1) // 2
    S_eval = 10 * (nf + nl) + per_con + 2 * ne          # z + alpha Jd
    it = (
        2 * ne * nv                      # z
        + 8 * (nf + nl) + per_con + 4 * cone_rows + rank1  # f, w, U
        + 2 * nv * nv + 2 * ne * nv      # grad
        + (2 * npairs + nv) * (ne + nu) + 2 * nv * nv  # Gram + M
        + 2 * nv ** 3 // 3 + 2 * 2 * nv * nv    # Cholesky + solves
        + 2 * ne * nv + 2 * nv * nv + 4 * nv    # Jd, Md, qa, qb
        + 18 * (S_eval + 4)              # line search
    )
    final = 2 * ne * nv + 8 * (nf + nl) + per_con + 4 * cone_rows + 2 * ne * nv
    flops = B * (iterations * it + final)
    nbytes = 4 * (sum(a.numel() for a in args) + B * (2 * nv + ne))
    return flops, nbytes


def scaled_err(a, b):
    """Per-env max |a - b| / (1 + max |b|) (tests/test_ops.py scaling)."""
    return ((a - b).abs().amax(-1) / (1.0 + b.abs().amax(-1)))


def phase_kernels(env, gen, dev, B, seed):
    """Kernel vs plain version on the card, per input set."""
    from quadruped_tpu_torch.ops import newton as N

    rng = np.random.default_rng(seed)
    sets = {}
    st = env.reset(B, gen)
    zero_ctrl = torch.zeros((B, env.nu), device=dev)
    sets["reset"] = (st.qpos, st.qvel, zero_ctrl, st.params)
    # a few control steps of random torques from the reset states
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
    report = {"max_abs_err": 0.0, "max_abs_err_all_envs": 0.0,
              "max_scaled_err_2it": 0.0,
              "max_scaled_err_2it_well": 0.0, "max_scaled_err_8it": 0.0,
              "max_err_over_env_limit": 0.0}
    for name, (qpos, qvel, ctrl, params) in sets.items():
        args, kw = solver_inputs(env, qpos, qvel, ctrl, params)
        before = N.newton_solve.launches
        k2 = N.newton_solve(*args, iterations=2, **kw)
        p2 = N.newton_core_torch(*args, iterations=2, **kw)
        t2 = N.newton_core_torch(*[a.double() for a in args], iterations=2, **kw)
        # the plain version again, 4 times, on inputs moved by one float32
        # rounding (relative 2^-23 noise on M, J, aref, D, R)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        moved_runs = [
            N.newton_core_torch(*[
                a * (1 + 2.0**-23 * torch.randn(a.shape, generator=g, device=dev))
                if i in (0, 3, 4, 5, 6) else a for i, a in enumerate(args)
            ], iterations=2, **kw)
            for _ in range(4)
        ]
        k8 = N.newton_solve(*args, iterations=8, **kw)
        p8 = N.newton_core_torch(*args, iterations=8, **kw)
        torch.cuda.synchronize()
        if N.newton_solve.launches != before + 2:
            raise RuntimeError("the kernel check did not launch the kernel")

        def env_err(x, y):      # per env, worst of qacc and qfrc
            return torch.maximum(scaled_err(x[0].double(), y[0].double()),
                                 scaled_err(x[2].double(), y[2].double()))

        e_kp = env_err(k2, p2)   # kernel vs plain, float32 both
        e_kt = env_err(k2, t2)   # kernel vs the float64 solve
        # float32 noise floor of each env's solve: how far the plain
        # version lies from its float64 run, and how far it moves when
        # its inputs move by one rounding (the first moved run; every
        # moved run, and how far each lies from float64, for `spread`)
        e_pt = env_err(p2, t2)
        floor = torch.maximum(e_pt, env_err(moved_runs[0], p2))
        spread = e_pt
        for m2 in moved_runs:
            spread = torch.maximum(spread, torch.maximum(
                env_err(m2, p2), env_err(m2, t2)))
        # Tolerance (2 iterations).  On every env whose float32 solve is
        # stable (noise floor <= 1e-4) the kernel agrees with the plain
        # version within 1e-3, scaled as in tests/test_ops.py.  On the
        # others (deep penetration: fallen starts, the stiff fixture) the
        # float32 Newton step is ill-conditioned and any two float32
        # solves differ by up to the floor.  So every env, stable or not,
        # is also held to its own limit: no further from the float64
        # solve than 2e-3 + 3 x the spread of its float32 solves.
        well = floor <= 1e-4
        e2_well = e_kp[well].max().item() if well.any() else 0.0
        lim = 2e-3 + 3.0 * spread
        over = e_kt > lim
        n_over = int(over.sum())
        ratio = (e_kt / lim).max().item()
        for i in over.nonzero()[:, 0].tolist():
            log(f"  over its limit ({name}) env {i}: kernel vs float64 "
                f"{e_kt[i].item():.3e}, plain vs float64 {e_pt[i].item():.3e}, "
                f"spread {spread[i].item():.3e}, kernel vs plain "
                f"{e_kp[i].item():.3e}")
        e2 = e_kp.max().item()
        e8 = max(scaled_err(k8[i], p8[i]).max().item() for i in (0, 2))
        abs2 = max((k2[i] - p2[i]).abs().max().item() for i in (0, 2))
        abs2_well = max(
            (k2[i] - p2[i])[well].abs().max().item() if well.any() else 0.0
            for i in (0, 2)
        )
        fin = all(torch.isfinite(x).all().item() for x in k8)
        ncon = args[12].sum().item()
        log(f"kernel[{name}]: B={B} active contacts/env {ncon / B:.2f}; "
            f"2 it: kernel vs plain max scaled err {e2:.3e} (abs {abs2:.3e}), "
            f"over the {int(well.sum())} envs float32 solves stably: "
            f"{e2_well:.3e} (abs {abs2_well:.3e}); kernel vs float64 "
            f"{e_kt.max().item():.3e}, "
            f"plain vs float64 {e_pt.max().item():.3e}, largest float32 "
            f"noise floor {floor.max().item():.3e}, "
            f"{int((e_kp > 1e-3).sum())} envs above 1e-3 of plain; "
            f"worst kernel-vs-float64 error over its own env's limit "
            f"{ratio:.3e}, {n_over} envs over it; "
            f"8 it: max scaled err {e8:.3e}, finite={fin}")
        if not fin:
            raise RuntimeError(f"kernel outputs not finite at 8 iterations ({name})")
        if not (e2_well <= 1e-3 and n_over == 0):
            raise RuntimeError(
                f"kernel vs plain at 2 iterations out of tolerance ({name}): "
                f"{e2_well:.3e} on stable envs, {n_over} envs over their "
                f"float64 limit"
            )
        report["max_abs_err"] = max(report["max_abs_err"], abs2_well)
        report["max_abs_err_all_envs"] = max(report["max_abs_err_all_envs"], abs2)
        report["max_scaled_err_2it"] = max(report["max_scaled_err_2it"], e2)
        report["max_scaled_err_2it_well"] = max(report["max_scaled_err_2it_well"], e2_well)
        report["max_scaled_err_8it"] = max(report["max_scaled_err_8it"], e8)
        report["max_err_over_env_limit"] = max(report["max_err_over_env_limit"], ratio)
        if name == "after_steps":
            timed = (args, kw)
    args, kw = timed
    it = env.m.opt.iterations
    report["ms"] = cuda_time_ms(lambda: N.newton_solve(*args, iterations=it, **kw), 20)
    report["plain_ms"] = cuda_time_ms(
        lambda: N.newton_core_torch(*args, iterations=it, **kw), 3
    )
    flops, nbytes = newton_counts(args, kw, it)
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
    report.update(
        flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    log(f"kernel timing ({B} envs, {it} iterations, after_steps inputs): "
        f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
        f"bound {report['bound_ms']:.4f} ms by {report['bound_by']} "
        f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return report


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
    N.newton_solve.launches = 0
    t0 = time.perf_counter()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(steps):
        state, obs, reward = control_step(state, obs)
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = N.newton_solve.launches
    if not bool(finite):
        raise RuntimeError("non-finite obs or reward on the main path")
    if tuple(obs.shape) != (B, env.obs_dim):
        raise RuntimeError(f"obs shape {tuple(obs.shape)}")
    expect = env.cfg.frame_skip * steps
    if launches != expect:
        raise RuntimeError(f"Newton kernel launched {launches} times, expected {expect}")
    log(f"main: {steps} control steps x {B} envs in {dt:.4f} s: "
        f"{steps / dt:.3f} batched control steps/s, "
        f"{B * steps / dt:.1f} env control steps/s; "
        f"Newton launches {launches} ({launches / steps:g} per control step)")

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
            "env_steps_per_s": B * steps / dt, "phases_ms": per_step}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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

    # 5. report
    kernels = [{
        "name": "newton_solve",
        "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/newton.cu",
        "replaces": "quadruped_tpu/ops/newton.py:641",
        "launches": mrep["launches"],
        "max_abs_err": krep["max_abs_err"],
        "max_abs_err_over": "envs whose float32 solve is stable (noise "
                            "floor <= 1e-4), 2 Newton iterations, qacc and qfrc",
        "ms": krep["ms"],
        "plain_ms": krep["plain_ms"],
        "bound_ms": krep["bound_ms"],
        "bound_by": krep["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({
        "main": {"envs": args.envs, "control_steps": args.steps,
                 "env_steps_per_s": mrep["env_steps_per_s"],
                 "phases_ms": mrep["phases_ms"]},
        "newton": {k: krep[k] for k in (
            "max_abs_err_all_envs", "max_scaled_err_2it",
            "max_scaled_err_2it_well", "max_err_over_env_limit",
            "max_scaled_err_8it", "flops", "bytes")},
    }))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
