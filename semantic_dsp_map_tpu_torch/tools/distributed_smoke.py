"""Multi-process smoke run of the sharded step (counterpart of the JAX
package's ``tools/distributed_smoke.py``).

D local ranks, each a process of its own in one process group
(``parallel.distributed.spawn_ranks``), step the sharded frame pipeline for
a few frames of a static wall at the tiny config.  Every route, halo send
and the counters' all_reduce then cross a process boundary.  The run is
good when every rank reports the same counters (they are summed over the
ranks) and the last frame gave births.

    python -m semantic_dsp_map_tpu_torch.tools.distributed_smoke \\
        --devices 2 --device cpu [--out report.json]
    python -m semantic_dsp_map_tpu_torch.tools.distributed_smoke --devices 1

(the second on the card: NCCL takes one rank per card).  Nothing is written
unless ``--out`` names a file; the exit code is 0 for a good run.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import FilterParams, tiny_test_config
from ..frontend import FrameInput, MaskKpts, build_frame_input
from ..labels import LabelRegistry
from ..parallel.distributed import backend_of, spawn_ranks
from ..parallel.shard_step import build_shard_step
from ..parallel.sharding import shard_state
from ..state import init_map_state, resolve_device

#: Frames each rank steps, and the seconds all ranks may take together.
FRAMES = 3
TIMEOUT_S = 600.0


def smoke_rank(device, frames: int) -> dict:
    """One rank's run: ``frames`` frames of a wall whose lower half comes
    closer frame by frame, with the camera moving forward."""
    cfg = tiny_test_config()
    params = FilterParams(nb_ptc_num_per_point=1, prediction_stddev=0.0)
    registry = LabelRegistry.default()
    rank, D = dist.get_rank(), dist.get_world_size()
    state = shard_state(cfg, init_map_state(cfg, seed=0, device=device), rank, D)
    step = build_shard_step(cfg, params, registry)
    H, W = cfg.height, cfg.width
    diags = []
    for t in range(frames):
        depth = np.full((H, W), 1.6, np.float32)
        depth[H // 2 :, :] = 1.1 + 0.01 * t
        masks = [MaskKpts(track_id=65535, label="static", mask=np.full((H, W), 6, np.uint8))]
        f = build_frame_input(cfg, registry, depth, masks, np.array([0, 0, 0.05 * t], np.float32),
                              np.array([1, 0, 0, 0], np.float32), 0.1 * t)
        f = FrameInput(*(torch.as_tensor(np.asarray(a)).to(device) for a in f))
        state, _result, diag = step(state, f)
        diags.append({k: int(v) for k, v in diag._asdict().items()})
    return {"rank": rank, "ranks": D, "device": str(device), "diags": diags}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=2, help="ranks (processes)")
    ap.add_argument("--device", default=None,
                    help="default: the card (NCCL); 'cpu' for the CPU (gloo)")
    ap.add_argument("--out", default=None, help="write the report JSON to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = spawn_ranks(smoke_rank, args.devices, device, TIMEOUT_S, (FRAMES,))
    same = all(r["diags"] == results[0]["diags"] for r in results)
    born = results[0]["diags"][-1]["born_count"]
    report = {"ok": bool(same and born > 0), "ranks": args.devices, "backend": backend_of(device),
              "identical_diags": same, "born_last_frame": born, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "results"}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
