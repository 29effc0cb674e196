"""ms per control step of forward kinematics (physics/kinematics.py): the
TIMER phase "fk" over the traced window."""

from port_bench.harness import readers


def read(ctx):
    return readers.timer_per_step_ms(ctx, "fk")
