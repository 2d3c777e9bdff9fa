"""Run one cell of BENCHMARK.json once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit, then as the last line of standard
output one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and the numbers compared under `checks`); the numbers
compared are also the last lines of standard error. Exits with a code other
than 0, and prints no result, without enough CUDA cards, or when JAX or the
JAX package was loaded in this process.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_env()
    spec = harness.load_spec(args.workload, args.seed, args.seconds, bool(args.trace))
    spec.t_process = T_PROCESS

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {spec.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    outcome = harness.kind_module(spec.traffic["kind"]).run(spec)

    found = harness.banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for line in harness.format_checks(outcome["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(**outcome), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
