"""ms per control step in the env's own code (rewards, health, obs,
resets): the TIMER phase "env" over the traced window."""

from port_bench.harness import readers


def read(ctx):
    return readers.timer_per_step_ms(ctx, "env")
