"""Depth-table gather probe on one CUDA card (counterpart of
``benchmarks/prim_bench7.py``, at its sizes): 4,194,304 lookups into a
384 x 1248 f32 depth table, the per-particle depth lookup of the observe
stage's working set.

Decides whether that lookup should be the hand-written kernel
(``ops/probes_cuda.gather_cuda``, csrc/probes.cu) or PyTorch's own gather:
both are timed with CUDA events over ``--iters`` calls after a warm-up, on
the same table and indices, beside a dispatch-floor line.

    python -m semantic_dsp_map_tpu_torch.benchmarks.prim_bench7 [--iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from ..ops.probes_cuda import gather_cuda
from ..state import resolve_device
from ..timing import bench, card_line

H, W = 384, 1248   # tile-friendly VKITTI2-ish
N = 1 << 22        # 4.2M lookups (the [A, BV*K] working set)


def make_inputs(device, h: int = H, w: int = W, n: int = N, seed: int = 0):
    """(depth f32[h, w] in [1, 30), rc i32[n] = row * w + col), from a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    depth = torch.rand((h, w), generator=g, device=device) * 29.0 + 1.0
    rows = torch.randint(0, h, (n,), generator=g, device=device, dtype=torch.int32)
    cols = torch.randint(0, w, (n,), generator=g, device=device, dtype=torch.int32)
    return depth, rows * w + cols


def run(device, iters: int = 10, h: int = H, w: int = W, n: int = N) -> List[dict]:
    """Time the probes; returns [{name, device_ms, enqueue_ms}]."""
    device = resolve_device(device)
    depth, rc = make_inputs(device, h, w, n)
    flat = depth.reshape(-1)
    tile = torch.zeros((8, 128), device=device)
    probes = [
        ("baseline (x + 1 on [8,128])", lambda: tile + 1),
        (f"hand-written kernel gather {n} from [{h},{w}]", lambda: gather_cuda(depth, rc)),
        (f"torch indexing gather {n} from [{h},{w}]", lambda: flat[rc]),
        (f"torch.index_select gather {n} from [{h},{w}]",
         lambda: torch.index_select(flat, 0, rc)),
    ]
    return [dict(name=name, **bench(fn, device, iters)) for name, fn in probes]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """The CLI; prints one line per probe, each with the card, and returns
    the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    rows = run(device, args.iters)
    for r in rows:
        print(f"{r['name']:<52} device {r['device_ms']:9.4f} ms  enqueue {r['enqueue_ms']:9.4f} ms"
              f"  [{card}]", flush=True)
    return rows


if __name__ == "__main__":
    main()
