"""The traced slice: torch.profiler over a few steady control steps of
a rollout and a few minibatch steps of an update, on the timed path's
own calls, and the reduction of its trace to device busy time, launches,
the Newton kernel's time and the longest idle gaps by what the host was
doing.

The slice starts and stops inside the program's calls: a wrapper on the
policy's `sample` counts control steps, one on the trainer's `_loss`
counts minibatch steps.  While the rollout slice runs, a wrapper on
`ops.newton.newton_solve` keeps each launch's active-slot mask, from
which `counts.newton_counts` gives the work the launch needed."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

from .counts import H100_FP32_FLOPS, H100_HBM_BYTES, newton_counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Slice:
    """One profiler window, opened at call `start` and closed at call
    `start + count` of whatever counts its calls.  The trace is reduced
    (`summary`) as soon as the window closes, before any later profiler
    window in the process opens."""

    def __init__(self, start: int, count: int, on_open=None, on_close=None):
        self.start, self.stop = start, start + count
        self.count = count
        self.prof = None
        self.summary = None
        self.on_open, self.on_close = on_open, on_close

    def tick(self, i: int):
        if i == self.start:
            _sync()
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            if self.on_open:
                self.on_open()
        elif i == self.stop and self.prof is not None:
            _sync()
            if self.on_close:
                self.on_close()
            self.prof.stop()
            self.summary = summarize(self.prof)
            self.prof = None


class NewtonTap:
    """Keeps each Newton launch's active-slot mask while installed."""

    def __init__(self):
        self.launches = []
        self._mod = None
        self._orig = None

    def install(self):
        from quadruped_tpu_torch.ops import newton as mod
        self._mod, self._orig = mod, mod.newton_solve
        orig = self._orig

        def tapped(*args, nf, nl, iterations, pool_dims=None, gram_mode=None):
            M, J = args[0], args[3]
            stand = torch.empty((), device=M.device)
            self.launches.append(dict(
                args=(stand.expand(M.shape), None, None, stand.expand(J.shape),
                      *([None] * 8), args[12].detach().clone()),
                kw=dict(nf=nf, nl=nl, pool_dims=pool_dims),
                iterations=iterations))
            return orig(*args, nf=nf, nl=nl, iterations=iterations,
                        pool_dims=pool_dims, gram_mode=gram_mode)

        # the program counts its launches on `newton_solve.launches`,
        # looked up by the module-level name that now names the wrapper
        tapped.launches = orig.launches
        mod.newton_solve = tapped

    def remove(self):
        if self._mod is not None:
            self._mod.newton_solve = self._orig
            self._mod = None

    def bound_s(self) -> float:
        """The least time the counted launches could take on the card:
        per launch the larger of FP32 operations / 67 TFLOP/s and bytes /
        3.35 TB/s."""
        total = 0.0
        for ln in self.launches:
            flops, _gram, nbytes = newton_counts(ln["args"], ln["kw"], ln["iterations"])
            total += max(flops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES)
        return total

    def flops(self) -> float:
        return sum(newton_counts(ln["args"], ln["kw"], ln["iterations"])[0]
                   for ln in self.launches)


class TraceSlices:
    """Wrappers that open the rollout slice at control step
    `rollout_start` for `rollout_steps` steps and, when given, the
    update slice at minibatch `update_start` for `update_minibatches`."""

    def __init__(self, trainer, policy, traffic_trace: dict):
        t = traffic_trace
        self.trainer, self.policy = trainer, policy
        self.tap = NewtonTap()
        self.rollout = _Slice(t["rollout_start"], t["rollout_steps"],
                              on_open=self.tap.install, on_close=self.tap.remove)
        self.update = (_Slice(t["update_start"], t["update_minibatches"])
                       if "update_start" in t else None)
        self._k, self._i = -1, -1
        self._sample = policy.sample
        policy.sample = self.sample
        if self.update is not None:
            self._loss = trainer._loss
            trainer._loss = self.loss

    def sample(self, obs, generator=None, noise=None):
        self._k += 1
        self.rollout.tick(self._k)
        return self._sample(obs, generator, noise)

    def loss(self, policy, batch):
        self._i += 1
        self.update.tick(self._i)
        return self._loss(policy, batch)

    def close(self):
        self.tap.remove()
        del self.policy.sample
        if self.update is not None:
            del self.trainer._loss


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and "ts" in e]


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def summarize(prof) -> dict:
    """Window, busy time, launches, Newton kernel time, time by device
    operation and idle time by the host operation that ran in each gap
    (the innermost CPU op over the gap's midpoint), from one slice."""
    ev = _events(prof)
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in ev if e.get("cat") in DEVICE_CATS))
    cpu = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in ev if e.get("cat") == "cpu_op"))
    spans = [(a, b) for a, b, _ in dev] + [(a, b) for a, b, _ in cpu]
    if not spans:
        return dict(window_s=0.0, busy_s=0.0, launches=0, newton_s=0.0,
                    newton_launches=0, device_ops={}, idle_by_host={})
    t0 = min(a for a, _ in spans)
    t1 = max(b for _, b in spans)
    by_op: dict[str, float] = {}
    merged = []
    newton_s, newton_n = 0.0, 0
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
        if "newton_kernel" in name:
            newton_s += (b - a) * 1e-6
            newton_n += 1
    launches = sum(1 for e in ev if e.get("cat") == "kernel")
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps, prev = [], t0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    starts = [a for a, _, _ in cpu]
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in reversed(cpu[max(0, j - 400):j]):
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        key = best[1] if best else "host:between_ops"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    return dict(window_s=(t1 - t0) * 1e-6, busy_s=busy, launches=launches,
                newton_s=newton_s, newton_launches=newton_n,
                device_ops={_clean(k): v for k, v in by_op.items()},
                idle_by_host={_clean(k): v for k, v in idle.items()})


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
