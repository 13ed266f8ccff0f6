"""Weak-scaling report of the sharded step (counterpart of the JAX
package's ``tools/weakscaling_report.py``).

``parallel.distributed.weak_scaling_report`` on the ``medium`` workload,
6 frames, at ``--devices`` ranks and, when that is more than 2, at 2 ranks
as well (under ``d2``), as the JAX tool reports.  Ranks are processes
(``spawn_ranks``); on one host they share its cores, and on one card NCCL
takes one rank, so a report from one host says what the routes and halos
cost there, not how the step scales.  Each rank's working sets and route
buckets (``shard_caps``) stand in for the JAX report's compile-time FLOP
ratio, which has no PyTorch analog.  For another workload or frame count,
use ``python -m semantic_dsp_map_tpu_torch.parallel.distributed``.

    python -m semantic_dsp_map_tpu_torch.tools.weakscaling_report \\
        --devices 2 --device cpu [--out report.json]

Nothing is written unless ``--out`` names a file.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..parallel.distributed import weak_scaling_report
from ..state import resolve_device

#: The JAX tool's report: the medium workload, 6 frames a measurement.
PRESET = "medium"
FRAMES = 6


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="ranks of the grown workload")
    ap.add_argument("--device", default=None,
                    help="default: the card (NCCL); 'cpu' for the CPU (gloo)")
    ap.add_argument("--out", default=None, help="write the report JSON to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    report = weak_scaling_report(args.devices, FRAMES, PRESET, device)
    if args.devices > 2:
        report["d2"] = weak_scaling_report(2, FRAMES, PRESET, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
