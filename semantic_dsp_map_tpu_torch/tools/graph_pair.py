"""Replay device busy of ``chip_smoke.py``'s ``[graph]`` vkitti2 and zed2
paths, or with ``--wide`` the device time of the PHD passes on ``[wide]``'s
recorded real frames, from the ``chip_smoke.py`` and the package of a
checkout given by path: this one, or another version unpacked beside it
(``git archive REV | tar -x -C DIR``), so that two versions are timed in
turns in one call on one card.  Run it as a script, not as a module (a
module run would import this checkout's package first)::

    python3 semantic_dsp_map_tpu_torch/tools/graph_pair.py DIR
    python3 semantic_dsp_map_tpu_torch/tools/graph_pair.py DIR --wide

Prints one line ``PAIR {json}``: each path's device busy ms and kernels of
a profiled replay, the graph frames' median ms and the five frame kernels'
device ms in the replay; or with ``--wide`` each case's device-only and
host-included ms (medians of 10), terms and bound: pass A at R = 16 on a
real S = 12 frame and at S = 512, pass B at S = 512, and each pass's first
wide shape beside the main one just below it (pass A at S = 67 / 68 and
R = 12 / 13, pass B at S = 431 / 432); beside the card's name and power
limit.  Both modes use only functions that ``chip_smoke.py`` has had since
the passes' wide instances first ran (``recorded_passes``, ``cuda_ms``, the
passes' census and bounds), so an older checkout runs them too.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def wide_cases(cs, card) -> dict:
    """The ``--wide`` cases, timed with ``cs`` (a checkout's chip_smoke)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.ops import phd_cuda

    def cut(args, S, R=None):
        cfg = dataclasses.replace(args[0], phd_pixel_table_slots=S,
                                  **({} if R is None else {"phd_neighbor_half": R}))
        return (cfg, args[1], *(a[:S].contiguous() if isinstance(a, torch.Tensor) and a.dim() == 3
                                else a for a in args[2:]))

    def timed(key, args):
        if key == "pass_a":
            run = lambda: phd_cuda.pass_a_cuda(*args)
            census = cs.pass_a_census(args)
            b, _, _ = cs.pass_a_bound(args, run(), census)
            terms = census["terms"]
        else:
            run = lambda: phd_cuda.pass_b_cuda(*args)
            b, _, terms = cs.pass_b_bound(args, *run())
        dev = cs.cuda_ms(run, 10, queued=True)
        return {"S": args[2].shape[0], "R": args[0].neighbor_half, "device_only_ms": dev,
                "ms": cs.cuda_ms(run, 10), "terms": terms, "ns_per_term": dev * 1e6 / terms, **b}

    params = FilterParams(**cs.bench_scenes().VK_PARAMS)
    out = {}
    a12, _ = cs.recorded_passes(virtual_kitti2_config(), params)
    for name, args in (("a_r16", cut(a12, 12, 16)), ("a_r12", cut(a12, 12, 12)),
                       ("a_r13", cut(a12, 12, 13))):
        out[name] = timed("pass_a", args)
    del a12
    torch.cuda.empty_cache()
    a512, b512 = cs.recorded_passes(virtual_kitti2_config(phd_pixel_table_slots=512), params)
    for name, key, args in (("a_s512", "pass_a", a512), ("b_s512", "pass_b", b512),
                            ("a_s67", "pass_a", cut(a512, 67)), ("a_s68", "pass_a", cut(a512, 68)),
                            ("b_s431", "pass_b", cut(b512, 431)),
                            ("b_s432", "pass_b", cut(b512, 432))):
        out[name] = timed(key, args)
        o = out[name]
        print(f"[pair] {name}: {o['device_only_ms']:.4f} ms device-only ({o['ms']:.4f}), bound "
              f"{o['bound_ms']:.4f} by {o['bound_by']} ({card})", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", type=Path, help="the checkout whose package and chip_smoke.py run")
    ap.add_argument("--wide", action="store_true",
                    help="time the PHD passes' wide cases instead of the graph paths")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_checkout", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    from semantic_dsp_map_tpu_torch import (
        FilterParams, step_graph, virtual_kitti2_config, zed2_config,
    )
    from semantic_dsp_map_tpu_torch.ops import cuda_lib
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda
    from semantic_dsp_map_tpu_torch.timing import card_line

    if not Path(cuda_lib.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"the package came from {cuda_lib.__file__}, not from {root}")
    card = card_line(torch.device("cuda"))
    lib, seconds, _ = cuda_lib.build()
    print(f"[pair] {root.name}: library {lib} in {seconds:.1f} s ({card})", flush=True)
    if args.wide:
        result = {"who": str(root), "card": card, "wide": wide_cases(cs, card)}
        print("PAIR " + json.dumps(result), flush=True)
        return result
    scenes = cs.bench_scenes()
    fns = (*step_graph.FRAME_KERNELS, merge_blocks_cuda)
    out = {}
    for name, cfg, params, synth in (
            ("vkitti2", virtual_kitti2_config(), scenes.VK_PARAMS, scenes.synth_vkitti2_frame),
            ("zed2", zed2_config(), scenes.ZED2_PARAMS, scenes.synth_zed2_frame)):
        g = cs.drive_graph(name, cfg, FilterParams(**params), synth, fns, card)
        med = g["median_ms"]
        out[name] = {"busy_ms": g["device_busy_ms"]["graph"],
                     "kernels": g["device_kernels"]["graph"],
                     "graph_median_ms": med["graph"] if isinstance(med, dict) else med,
                     "kernel_ms_in_replay": g["kernel_ms_in_replay"]}
        torch.cuda.empty_cache()
    result = {"who": str(root), "card": card, **out}
    print("PAIR " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
