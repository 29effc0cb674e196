"""Arithmetic that the per-layer metrics' readers share.  Each reader
(port_bench/metrics/<name>.py) is one call of these on the run's
context; each returns None where the run has nothing to read, and the
harness then leaves the metric out of the line.

The context (`ctx`), filled by cell.run_cell in a traced run:
  kind            "train_iteration" or "rollout"
  timer_ms        the program's TIMER phases over the traced window, ms
  units           whole iterations (train) or rollouts in that window
  control_steps   env control steps in that window
  slices          per profiled slice ("rollout", "update") its summary
                  (trace.summarize) and its counted work
"""

from __future__ import annotations

from .counts import H100_FP32_FLOPS


def timer_per_step_ms(ctx, phase: str):
    t = ctx.get("timer_ms", {})
    if phase not in t or not ctx.get("control_steps"):
        return None
    return t[phase] / ctx["control_steps"]


def timer_per_unit_s(ctx, phase: str):
    t = ctx.get("timer_ms", {})
    if phase not in t or not ctx.get("units"):
        return None
    return t[phase] / ctx["units"] / 1e3


def newton_roofline_pct(ctx):
    """The counted launches' least time over their device time, in %."""
    s = ctx.get("slices", {}).get("rollout")
    if not s or not s["newton_s"] or not s["newton_bound_s"]:
        return None
    return 100.0 * s["newton_bound_s"] / s["newton_s"]


def step_mfu_pct(ctx):
    """Counted FP32 work of the profiled slices over their windows'
    time at 67 TFLOP/s, in %."""
    slices = [s for s in ctx.get("slices", {}).values() if s["busy_s"] > 0]
    if not slices:
        return None
    flops = sum(s["flops"] for s in slices)
    window = sum(s["window_s"] for s in slices)
    return 100.0 * flops / (window * H100_FP32_FLOPS)


def idle_pct(ctx):
    """The device's idle share, in %: the rollout slice's, and in a
    training cell the two slices' weighted by the TIMER's rollout and
    update time."""
    slices = ctx.get("slices", {})
    r = slices.get("rollout")
    if not r or r["busy_s"] <= 0:
        return None
    idle_r = 1.0 - r["busy_s"] / r["window_s"]
    u = slices.get("update")
    t = ctx.get("timer_ms", {})
    if u is None or u["busy_s"] <= 0 or "rollout" not in t or "update" not in t:
        return 100.0 * idle_r
    idle_u = 1.0 - u["busy_s"] / u["window_s"]
    wr, wu = t["rollout"], t["update"]
    return 100.0 * (idle_r * wr + idle_u * wu) / (wr + wu)


def launches_per_step(ctx):
    r = ctx.get("slices", {}).get("rollout")
    if not r or not r["launches"]:
        return None
    return r["launches"] / r["steps"]
