"""Device kernels per control step in the profiled rollout slice."""

from port_bench.harness import readers


def read(ctx):
    return readers.launches_per_step(ctx)
