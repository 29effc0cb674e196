"""s per iteration in PPO's update (GAE and every minibatch step): the
TIMER phase "update" over the traced window's whole iterations."""

from port_bench.harness import readers


def read(ctx):
    return readers.timer_per_unit_s(ctx, "update")
