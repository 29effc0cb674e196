"""ms per control step of narrowphase and constraint assembly
(physics/collision.py, physics/constraint.py): the TIMER phase
"assemble" over the traced window."""

from port_bench.harness import readers


def read(ctx):
    return readers.timer_per_step_ms(ctx, "assemble")
