"""One run of one cell: set-up, the measured window, the traced slice
when asked, then the reference's judgement.

Set-up builds the program's env and trainer from the configuration's
literal values, initializes them from the seed, spreads the episode
counters, loads the benchmark's weights, and warms up every shape the
window's calls use (the entry's `warm`).  The window then drives the
entry's call back to back on the same objects until `seconds` have
passed and the calls the check records (drawn from the seed) have run,
and ends in a synchronize.  The entry is found by the traffic's name
(port_bench/entries/<entry>.py).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from . import capture, check, spec, trace
from .counts import actor_critic_flops


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sample(rng, n: int, k: int):
    return sorted(int(x) for x in rng.choice(n, size=min(k, n), replace=False))


class Setup:
    """The program's objects for a cell, built from the configuration's
    literal values, and what `prepare` hands the window and the check."""

    def __init__(self, cell, device, sizes: dict | None = None, fault=None):
        from quadruped_tpu_torch.env.config import Go1Config
        from quadruped_tpu_torch.env.go1 import Go1Env
        from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig

        sizes = sizes or {}
        self.cell, self.cfg = cell, cell.config
        traffic = dict(cell.traffic)
        os.environ["QTPU_GRAM"] = self.cfg["gram_mode"]
        self.dev = dev = torch.device(device)
        self.env = Go1Env(spec.env_config(Go1Config, self.cfg), device=dev)
        self.ppo_cfg = spec.ppo_config(PPOConfig, self.cfg, traffic)
        for k, v in sizes.get("ppo", {}).items():
            setattr(self.ppo_cfg, k, v)
        self.ppo_dict = dict(self.cfg["ppo"], **sizes.get("ppo", {}))
        for k in ("check", "trace"):
            traffic[k] = dict(traffic[k], **sizes.get(k, {}))
        for k in ("length", "warmup_steps", "steps_from"):
            if k in sizes:
                traffic[k] = sizes[k]
        self.traffic = traffic
        self.B = self.ppo_cfg.num_envs
        self.trainer = PPO(self.env, self.ppo_cfg, device=dev)
        self.mod = spec.entry_module(traffic["entry"])
        self.entry = self.mod.Entry(self)
        if fault is not None:
            fault(self.env, self.trainer)

    def prepare(self, seed: int):
        """Initializes the trainer from `seed` with the benchmark's
        weights and episode counters, draws what the check samples, and
        warms up.  Returns the TrainState."""
        env, trainer, chk = self.env, self.trainer, self.traffic["check"]
        self.seed_env = seed + 1
        ts = trainer.init(self.seed_env)
        self.start = dict(qpos=ts.env_state.qpos.clone(),
                          qvel=ts.env_state.qvel.clone(),
                          desired_vel=ts.env_state.desired_vel.clone(),
                          obs=ts.obs.clone())
        capture.draw_counters(ts.env_state, seed + 2,
                              int(self.traffic.get("steps_from", 0)),
                              env.cfg.max_episode_steps,
                              env.cfg.max_unhealthy_time, self.dev)
        self.weights = capture.make_weights(seed, env.obs_dim, env.nu, self.dev)
        capture.load_weights(ts.policy, self.weights)
        rng = np.random.default_rng(seed)
        self.rows = torch.tensor(_sample(rng, self.B, chk["rows"]), device=self.dev)
        self.record_at = int(rng.integers(0, int(chk["record_from"])))
        self.record_calls = int(chk["record_calls"])
        self.steps = _sample(rng, self.record_calls * self.entry.control_steps,
                             chk["steps"])
        ts = self.entry.warm(ts)
        _sync(self.dev)
        return ts

    def records_due(self, calls: int) -> bool:
        """True until the calls the check records have run."""
        return calls < self.record_at + self.record_calls

    def drive(self, ts, calls: int):
        """The window's call number `calls`, recorded where due."""
        if calls == self.record_at:
            self.entry.arm(ts)
        try:
            return self.entry.call(ts)
        finally:
            if calls == self.record_at + self.record_calls - 1:
                self.entry.disarm()

    def judge(self) -> dict:
        return judge_run(self.cfg, self.start, self.entry, self.steps,
                         self.rows, self.ppo_dict, self.B, self.seed_env,
                         self.dev)


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool,
             t_start: float, device="cuda", sizes: dict | None = None,
             fault=None):
    """Runs the cell once -> (result dict, list of check lines).

    `sizes` overrides the PPOConfig fields, the traffic's num_envs,
    length, warm-up, counters and check/trace positions (the CPU tests'
    small runs); `fault(env, trainer)` plants a fault in the program
    before set-up (the tests'); neither is used by a benchmark run."""
    from quadruped_tpu_torch.timing import TIMER

    cell = spec.load_cell(workload)
    marks = [("imports", time.perf_counter())]
    su = Setup(cell, device, sizes, fault)
    marks.append(("env and trainer built", time.perf_counter()))
    dev, env, trainer, ppo_cfg = su.dev, su.env, su.trainer, su.ppo_cfg
    traffic, entry, B = su.traffic, su.entry, su.B
    ts = su.prepare(seed)
    marks.append(("init and warm-up", time.perf_counter()))
    prev = t_start
    for name, t in marks:
        print(f"setup {name}: {t - prev:.3f} s", file=sys.stderr)
        prev = t

    # ---- the measured window
    timing = trace_on and dev.type == "cuda"
    if timing:
        TIMER.reset()
        TIMER.enabled = True
    units, outs, marks = 0, [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    try:
        while time.perf_counter() - t0 < seconds or su.records_due(units):
            ts, out = su.drive(ts, units)
            outs.append(out)
            units += 1
            marks.append(time.perf_counter() - t0)
        _sync(dev)
        elapsed = time.perf_counter() - t0
    finally:
        TIMER.enabled = False
    timer_ms = TIMER.totals_ms() if timing else {}
    # host time at which each call was issued (the card follows a
    # launch-bound host closely), and the synchronize that ends the window
    print(f"window calls issued at s (call {su.record_at} to "
          f"{su.record_at + su.record_calls - 1} recorded): "
          + " ".join(f"{t:.3f}" for t in marks) + f"; synchronized {elapsed:.3f}",
          file=sys.stderr)
    control_steps = units * entry.control_steps
    failed = sum(1 for x in outs if not math.isfinite(float(x)))

    metrics = {}
    e2e_values = {"setup_s": setup_s, su.mod.METRIC: units * entry.work / elapsed}

    # ---- the traced slice
    ctx, breakdown, device_extra = {}, None, {}
    if trace_on:
        slices = trace.TraceSlices(trainer, ts.policy, traffic["trace"])
        try:
            ts, _ = entry.call(ts)
            _sync(dev)
        finally:
            slices.close()
        fwd = actor_critic_flops(env.obs_dim, env.nu)
        summ = {}
        if slices.rollout.summary is not None:
            s = slices.rollout.summary
            s.update(steps=slices.rollout.count,
                     newton_bound_s=slices.tap.bound_s(),
                     flops=slices.rollout.count * B * 2 * fwd + slices.tap.flops())
            summ["rollout"] = s
        if slices.update is not None and slices.update.summary is not None:
            s = slices.update.summary
            mb = ppo_cfg.batch_size // ppo_cfg.num_minibatches
            s.update(minibatches=slices.update.count,
                     flops=slices.update.count * mb * 3 * fwd)
            summ["update"] = s
        ctx = dict(kind=traffic["entry"], timer_ms=timer_ms, units=units,
                   control_steps=control_steps, slices=summ)
        ops, idle = {}, {}
        for s in summ.values():
            for src, dst in ((s["device_ops"], ops), (s["idle_by_host"], idle)):
                for k, v in src.items():
                    dst[k] = dst.get(k, 0.0) + v
        breakdown = {"device_ops": trace.top(ops), "idle_gaps": trace.top(idle)}
        device_extra = dict(busy_s=sum(s["busy_s"] for s in summ.values()),
                            window_s=sum(s["window_s"] for s in summ.values()))
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e_values:
                metrics[m["name"]] = {"value": e2e_values[m["name"]],
                                      "unit": m["unit"]}

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"

    # ---- the reference's judgement, after the program's state is freed
    del ts, trainer
    su.trainer = entry.trainer = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = su.judge()
    print(f"check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = cell.limits
    correct = check.judge(numbers, limits)
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    lines = [f"check {k} {numbers.get(k)!r} limit {limits[k]!r}" for k in limits]

    result = {
        "correct": bool(correct),
        "attempted": units,
        "failed": failed,
        "metrics": metrics,
        "device": dict({"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": kind, "count": int(cell.workload["chips"]),
                        "memory_peak_bytes": int(peak)}, **device_extra),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines


def reference_env(cfg: dict, device):
    """The reference's env for a configuration: every contact candidate a
    solver slot (the configuration's pools or top-K budget dropped, which
    only ever leave contacts out), stepped in the state's dtype."""
    from ..reference.env.config import Go1Config
    from ..reference.env.go1 import Go1Env
    conf = dataclasses.replace(spec.env_config(Go1Config, cfg),
                               contact_pools=None, max_contacts=None)
    return Go1Env(conf, device=device)


def reference_of(ref_env, entry, steps, rows) -> dict:
    """The reference's side of the recorded rollout steps: the picks it
    re-steps (the sampled rows at the sampled steps, then every row that
    reset), its policy at the sampled picks and its outputs at all."""
    records = entry.rcap.records
    weights = entry.policy_weights()
    sampled, resets = check.picks_of(records, steps, rows)
    picks = sampled + resets
    print(f"check rows: {sum(r.numel() for _k, r in sampled)} sampled, "
          f"{sum(r.numel() for _k, r in resets)} reset, in {len(records)} "
          "recorded steps", file=sys.stderr)
    return dict(records=records, weights=weights, picks=picks,
                n=sum(r.numel() for _k, r in sampled),
                pol=check.reference_policy(records, sampled, weights),
                out=check.reference_rows(ref_env, records, picks, weights))


def step_numbers(ref_env, entry, steps, rows, control: bool = False,
                 fault: str | None = None, base: dict | None = None) -> dict:
    """policy_gap, step_gap_p50/p90, done_mismatch and reset_row_gap of
    the recorded rollout steps: the program's (or, with `control` or
    `fault`, the reference's in the program's place) against the
    reference's (`base`, from `reference_of`, where already computed)."""
    base = base or reference_of(ref_env, entry, steps, rows)
    records, picks, n = base["records"], base["picks"], base["n"]
    ref_pol, ref = base["pol"], base["out"]
    if control:
        pol_all = check.reference_policy(records, picks, base["weights"], control=True)
        cand = check.reference_rows(ref_env, records, picks, base["weights"],
                                    control=True, actions=pol_all["action"])
        cand_pol, trunc = {k: v[:n] for k, v in pol_all.items()}, 0
    elif fault is not None:
        cand, cand_pol, trunc = check.faulted_rows(ref, picks, records, fault), ref_pol, 0
    else:
        cand = check.program_rows(records, picks)
        cand_pol = {k: cand[k][:n] for k in check.POLICY_KEYS}
        trunc = check.truncation_mismatch(records, ref_env.cfg.max_episode_steps)
    return check.compare_rows(cand_pol, ref_pol, cand, ref, n, trunc)


def judge_run(cfg, start, entry, steps, rows, ppo_dict, B, seed_env, dev) -> dict:
    """Every number the reference compares for this run (a number whose
    answer never came is left out, which `check.judge` fails)."""
    ref_env = reference_env(cfg, dev)
    numbers = {"reset_gap": check.reset_gap(start, ref_env, B, seed_env, dev)}
    rcap = entry.rcap
    if rcap is not None and rcap.records and all(
            "bootstrap" in r and "next_qpos" in r for r in rcap.records):
        numbers.update(step_numbers(ref_env, entry, steps, rows))
    ucap = entry.ucap
    if ucap is not None and ucap.steps_taken is not None and ucap.w_first is not None:
        ref = check.reference_update(ucap.inputs, ppo_dict, ucap.first)
        numbers.update(check.compare_update(ucap.inputs["w0"],
                                            check.program_update(ucap), ref))
    return numbers
