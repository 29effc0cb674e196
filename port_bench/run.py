#!/usr/bin/env python3
"""Run one cell of the benchmark of quadruped_tpu_torch once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port.  The cell (its
configuration, traffic, limits and per-layer metrics) is read from
BENCHMARK.json and the files under port_bench/.  Prints one JSON object
as the last line of standard output, and each number compared with its
limit as the last lines of standard error.  Exits with another code
than 0, printing no result, without a CUDA card (or with fewer than the
cell asks for), or when the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def pin_one_core() -> None:
    """Keeps the process, and every thread it starts, on one core (the
    last it may use), so the launch thread is never moved between cores
    or shares its core with the process's other threads' migrations."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[-1]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    from port_bench.harness import guard, spec

    cell = spec.load_cell(args.workload)
    chips = int(cell.workload["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    pin_one_core()
    torch.set_num_threads(1)

    from port_bench.harness.cell import run_cell

    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
