"""The Newton kernel's share of its roofline, in %: the least time of the
launches in the profiled rollout slice (operations and bytes of their
active slots by counts.newton_counts, at 67 TFLOP/s and 3.35 TB/s) over
their device time in the trace."""

from port_bench.harness import readers


def read(ctx):
    return readers.newton_roofline_pct(ctx)
