"""Readings that the correctness limits of a cell are set from, in one
process on the card: for each seed, the program's checked numbers (the
lower readings: the largest over the seeds) and, for the control seeds, the
numbers of the control, the reference computed in fp8 in the program's
place (the upper readings: the smallest over those seeds).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --control-seeds 1 2 3

Each seed draws its weights and image pool, serves the cell's mix until its
sampled requests are done (a short window at the cell's own load), and
compares them as a run does. Prints one JSON line per seed, with the
numbers judged without the family's ``CONDITION_ON`` beside them
(``*_unconditioned``), which no run compares.

    python3 benchmark/calibrate.py --workload <cell> --control-runs 7 8 9 --seconds 5

runs, for each seed, a whole run of the cell (``session.run``) with the
control served in the program's place, and prints its ``correct`` and
``checks``: the control has to come out not correct. The benchmark's own
runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-runs", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=5.0, help="the control runs' window")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import check, session as session_mod

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.control_runs:
        t = time.perf_counter()
        result, lines = session_mod.run(ROOT, args.workload, seed, args.seconds, False, "cuda", t,
                                    fault=check.control(ROOT, args.workload, seed))
        print(json.dumps({"workload": args.workload, "seed": seed, "control_run": True, "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"],
                          "lines": lines, "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    session = session_mod.Session(ROOT, args.workload, "cuda") if args.seeds else None
    for seed in args.seeds:
        t = time.perf_counter()
        session.prepare(seed)
        served = session.window(0.0, False)
        depth = torch.cat([out["depth"].flatten() for _, out in served["sampled"]]).float()
        line = {"workload": args.workload, "seed": seed, "requests": len(served["sampled"]),
                "depth_min": float(depth.min()), "depth_median": float(depth.median()), "depth_max": float(depth.max()),
                "program": session.numbers(seed, served["sampled"]),
                "program_unconditioned": session.numbers(seed, served["sampled"], condition=False)}
        if seed in args.control_seeds:
            line["control"] = session.numbers(seed, served["sampled"], fp8=True)
            line["control_unconditioned"] = session.numbers(seed, served["sampled"], fp8=True, condition=False)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
