#!/usr/bin/env python3
"""Readings for the limits of a cell's check, on the chip.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control 1]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of `seconds`, the check), in one process; prints for each seed the
program's numbers and, with --control 1, the control's: the reference
computed in fp8 (the precision below the configuration's bf16) in the
program's place on the same sampled steps.  The control has to come out
above every limit it is held to; the program's readings over a dozen
seeds set the lower end.  Ends with one JSON line of every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch
    from harness import cells
    if not torch.cuda.is_available():
        run.say("no CUDA device")
        return 2
    run.steady_host_allocator()
    spec = cells.find(cells.load_benchmark(), args.workload)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(spec, seed, args.seconds, False,
                           control=bool(args.control))
        row = {"seed": seed, "program": {k: n["value"] for k, n in
                                         res["numbers"].items()},
               "control": res.get("control"),
               "attempted": res["attempted"], "failed": res["failed"],
               "metrics": {k: m["value"] for k, m in
                           res["metrics"].items()}}
        run.say("readings " + json.dumps(row))
        out.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
