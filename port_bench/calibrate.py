#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, for one cell, in
one process on the card.

    python3 port_bench/calibrate.py --workload <name> --seeds 0 1 ... [--faults 3]

For each seed it sets the cell up as a run does and drives its window's
calls until the calls the check records have run (no measured window),
at the cell's own size, then prints one JSON line with three sets of
numbers: `sound` (the program against the reference), `control` (the
reference put in the program's place and computed in the precision
below the configuration's float32 with TF32 off: TF32 matmuls, and
bfloat16 for the physics' state, which no matmul reaches) and, on the
first `--faults` seeds, one set per planted fault (the reference put in
the program's place with the fault in it).  It needs a CUDA card;
port_bench/run.py never runs it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from port_bench.harness import check, spec
    from port_bench.harness.cell import (Setup, reference_env, reference_of,
                                         step_numbers)

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = spec.load_cell(args.workload)
    su = Setup(cell, "cuda")
    ref_env = reference_env(su.cfg, su.dev)
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ts = su.prepare(seed)
        calls = 0
        while su.records_due(calls):
            ts, _ = su.drive(ts, calls)
            calls += 1
        torch.cuda.synchronize()
        del ts
        out = {"workload": args.workload, "seed": seed, "calls": calls,
               "sound": su.judge()}
        entry, ucap = su.entry, su.entry.ucap
        base = reference_of(ref_env, entry, su.steps, su.rows)
        out["control"] = dict(step_numbers(ref_env, entry, su.steps, su.rows,
                                           control=True, base=base), reset_gap=0.0)
        upd = None
        if ucap is not None:
            upd = check.reference_update(ucap.inputs, su.ppo_dict, ucap.first)
            ctl_u = check.reference_update(ucap.inputs, su.ppo_dict, ucap.first,
                                           tf32_on=True)
            out["control"].update(check.compare_update(ucap.inputs["w0"], ctl_u, upd))
        if n < args.faults:
            for fault in check.STEP_FAULTS:
                out[f"fault_{fault}"] = step_numbers(ref_env, entry, su.steps,
                                                     su.rows, fault=fault, base=base)
            if upd is not None:
                for fault in check.UPDATE_FAULTS:
                    fu = check.faulted_update(ucap.inputs, su.ppo_dict, ucap.first,
                                              upd, fault)
                    out.setdefault(f"fault_{fault}", {}).update(
                        check.compare_update(ucap.inputs["w0"], fu, upd))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(su.dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
