"""Primitive-op microbenchmarks on one CUDA card: gather, scatter, sort,
scans, nonzero, full passes — the card's own cost model for the frame step's
plain stages (counterpart of ``benchmarks/prim_bench1.py``, at its sizes).

Each line is one plain PyTorch call, timed with CUDA events over ``--iters``
calls after a warm-up (``device`` ms per call) beside the host's time to
enqueue it (``enqueue``).  The last lines hold the hand-written x2 kernel
(``ops/probes_cuda.scale2_cuda``, csrc/probes.cu) against ``x * 2.0`` and the
dispatch-floor line: its time is the card's launch floor for a kernel bound
with ctypes.

    python -m semantic_dsp_map_tpu_torch.benchmarks.prim_bench1 [--iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from ..ops.blocks import segment_start_index
from ..ops.probes_cuda import scale2_cuda
from ..state import resolve_device
from ..timing import bench, card_line

N_BIG = 58_720_256   # V*K at VKITTI2
N_TAB = 465_750      # H*W
P = 1 << 20


def run(device, iters: int = 10, n_big: int = N_BIG, n_tab: int = N_TAB, p: int = P) -> List[dict]:
    """Time every probe; returns [{name, device_ms, enqueue_ms}]."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    f32, i32 = torch.float32, torch.int32
    randn = lambda n: torch.randn(n, generator=g, device=device, dtype=f32)
    randint = lambda hi, n: torch.randint(0, hi, (n,), generator=g, device=device, dtype=i32)
    big, tab, vals = randn(n_big), randn(n_tab), randn(p)
    idx_big, idx_tab = randint(n_big, p), randint(n_tab, p)
    idx_wide = randint(n_tab, n_big // 7)
    keys = randint(1 << 30, p)
    pred = torch.rand(n_big, generator=g, device=device) < 0.02
    pred_i32 = pred.to(i32)
    starts = pred.clone()
    starts[0] = True
    big_scratch, tab_scratch = big.clone(), tab.clone()
    exp_n = min(5_600_000, n_big)
    small = torch.ones(8, device=device)
    tile = torch.ones((8, 128), dtype=f32, device=device)

    def sort_with_payload():
        k, order = torch.sort(keys)
        return k, vals[order], vals[order], vals[order]

    def exp_loop():
        a = big[:exp_n]
        s = torch.zeros_like(a)
        for i in range(121):
            s += torch.exp(a + i * 1e-3)
        return s

    probes = [
        ("noop (dispatch floor)", lambda: small + 1.0),
        (f"gather {p} from {n_big} f32", lambda: big[idx_big]),
        (f"gather {p} from {n_tab} f32 (depth)", lambda: tab[idx_tab]),
        (f"gather {n_big // 7} from {n_tab} f32", lambda: tab[idx_wide]),
        (f"scatter-set {p} into {n_big} f32 (in place)",
         lambda: big_scratch.index_put_((idx_big,), vals)),
        (f"scatter-add {p} into {n_tab} f32 (in place)",
         lambda: tab_scratch.index_add_(0, idx_tab, vals)),
        (f"sort {p} i32", lambda: torch.sort(keys)[0]),
        (f"argsort {p} i32", lambda: torch.argsort(keys)),
        (f"sort {p} key+3xf32 payload", sort_with_payload),
        (f"cumsum {n_big} i32", lambda: torch.cumsum(pred_i32, 0, dtype=i32)),
        (f"cummax {n_big} i32", lambda: torch.cummax(pred_i32, 0)[0]),
        (f"segment start index {n_big} (cumsum, scatter, gather)",
         lambda: segment_start_index(starts)),
        (f"nonzero on {n_big} bool", lambda: torch.nonzero(pred)),
        (f"full pass r+w {n_big} f32 (x*2)", lambda: big * 2.0),
        ("7-col slice pass [V,7]", lambda: big[: n_big // 7 * 7].view(-1, 7)[:, 3] * 2.0),
        (f"exp {n_big} f32", lambda: torch.exp(big)),
        (f"exp {exp_n} x121 loop", exp_loop),
        ("x*2 on [8,128] f32 (torch)", lambda: tile * 2.0),
        ("x*2 on [8,128] f32 (hand-written kernel)", lambda: scale2_cuda(tile)),
    ]
    rows = []
    for name, fn in probes:
        n = max(1, iters // 5) if fn is exp_loop else iters
        rows.append(dict(name=name, **bench(fn, device, n)))
    return rows


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
        print(f"{r['name']:<46} device {r['device_ms']:9.4f} ms  enqueue {r['enqueue_ms']:9.4f} ms"
              f"  [{card}]", flush=True)
    return rows


if __name__ == "__main__":
    main()
