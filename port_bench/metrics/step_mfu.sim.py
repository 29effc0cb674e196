"""The whole step's share of the card's FP32 peak, in %: the actor-critic's
passes and the Newton solves the profiled slices needed, counted from
shapes, over the slices' time at 67 TFLOP/s."""

from port_bench.harness import readers


def read(ctx):
    return readers.step_mfu_pct(ctx)
