"""Readings for the limits of a cell's comparison (compare.py), many seeds in
one process:

    python3 -m portbench.calibrate --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control <k>] [--fault <f>]

For every seed, one short run of the cell as the benchmark runs it (window
of --seconds, the comparison after it) and the program's readings; for the
first k seeds also the control's readings on the same pockets and steps
(the reference with the configuration's bfloat16 sites in fp8). One JSON
line per seed, then the largest program reading and the smallest control
reading of each number. --fault plants one of faults.py's faults in the
program for every seed (the readings are then the fault's). The
benchmark's own runs never run the control or plant a fault.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0, help="control readings for the first k seeds")
    ap.add_argument("--detail", action="store_true", help="train: the leaves that read worst, each step's loss")
    ap.add_argument("--fault", default=None, help="plant this fault of faults.py in the program (every seed)")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch

    from portbench import compare, faults

    if not torch.cuda.is_available():
        print("portbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    program, control = {}, {}
    for n, seed in enumerate(args.seeds):
        spec = harness.load_spec(args.workload, seed, args.seconds, False)
        spec.t_process = time.perf_counter()
        kind_name = spec.traffic["kind"]
        kind = harness.kind_module(kind_name)
        patch = faults.Patch()
        if args.fault:
            (faults.TRAIN if kind_name == "train" else faults.GENERATE)[args.fault](patch)
        try:
            outcome, recs, steps = kind.execute(spec)
        finally:
            patch.undo()
        row = dict(seed=seed, correct=outcome["correct"], attempted=outcome["attempted"],
                   failed=outcome["failed"], metrics=outcome["metrics"],
                   program={k: c["value"] for k, c in outcome["checks"].items()})
        if kind_name == "train" and args.detail:
            row["detail"] = {}
            compare.train_readings(spec, recs, detail=row["detail"])
        for k, v in row["program"].items():
            program[k] = max(program.get(k, v), v)
        if n < args.control:
            row["control"] = (compare.train_readings(spec, recs, control=True) if kind_name == "train"
                              else compare.generate_readings(spec, recs, steps, control=True))
            for k, v in row["control"].items():
                control[k] = min(control.get(k, v), v)
        print(json.dumps(row), flush=True)
        del recs
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": program, "control_min": control, "seeds": len(args.seeds)}), flush=True)
    found = harness.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
