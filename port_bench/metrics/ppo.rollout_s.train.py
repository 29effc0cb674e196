"""s per iteration in PPO.rollout: the TIMER phase "rollout" over the
traced window's whole iterations."""

from port_bench.harness import readers


def read(ctx):
    return readers.timer_per_unit_s(ctx, "rollout")
