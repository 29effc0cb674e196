"""The share of the profiled slices in which no operation ran on the
device, in % (a training cell weighs its rollout and update slices by
the TIMER's rollout and update time)."""

from port_bench.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
