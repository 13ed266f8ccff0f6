"""The readings that the output check's limits are set from, for one cell:
on each seed, a run of the cell with a short window, its numbers (the
program against the reference: the lower readings) and the control's (the
reference one precision step below the float32 the configuration states,
TF32 matmuls and a bfloat16 state, in the program's place: the upper
readings).  One process reads every seed, so the imports and the kernel
library load once.

    python3 -m dspbench.control --workload vkitti2.drive --seeds 101-112 --seconds 3

Prints one JSON line a seed, then one line with each number's largest
program reading and smallest control reading.  The card only; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,2147483900")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from dspbench.run import fix_allocator

    fix_allocator()
    import torch

    from dspbench import check, harness

    if not torch.cuda.is_available():
        print("dspbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    lower, upper = {}, {}
    for seed in seeds_of(args.seeds):
        out = harness.run_cell(cell, seed, args.seconds, False, control=True)
        prog = {k: v["value"] for k, v in out["checks"].items()}
        ctrl = out["control_checks"]
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "attempted": out["attempted"], "failed": out["failed"]}), flush=True)
        for k in check.NUMBERS:
            lower[k] = max(lower.get(k, 0.0), prog[k])
            upper[k] = min(upper.get(k, float("inf")), ctrl[k])
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
