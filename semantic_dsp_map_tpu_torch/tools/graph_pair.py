"""Replay device busy of ``chip_smoke.py``'s ``[graph]`` vkitti2 and zed2
paths, from the ``chip_smoke.py`` and the package of a checkout given by
path: this one, or another version unpacked beside it (``git archive REV |
tar -x -C DIR``), so that two versions are timed in turns in one call on
one card.  Run it as a script, not as a module (a module run would import
this checkout's package first)::

    python3 semantic_dsp_map_tpu_torch/tools/graph_pair.py DIR

Prints one line ``PAIR {json}``: each path's device busy ms and kernels of
a profiled replay, the graph frames' median ms and the five frame kernels'
device ms in the replay, beside the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def main(argv=None) -> dict:
    root = Path((argv or sys.argv[1:])[0]).resolve()
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
