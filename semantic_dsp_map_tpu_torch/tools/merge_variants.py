"""Birth's merge built from several versions of the kernel sources, timed
in turns on one card: each version's ``merge_blocks_cuda`` on the same
working sets, device-only ms (medians of 4 rounds of 10), after a check
that each gives the plain version's bits and count.

    python3 semantic_dsp_map_tpu_torch/tools/merge_variants.py DIR [DIR ...]

Each DIR holds a version of ``csrc/`` (``birth.cu``, ``render.cu`` for the
error strings, ``launch.cuh``; the package's own is
``semantic_dsp_map_tpu_torch/csrc``); each is built with
``cuda_lib.build(DIR)`` and bound in turn (``chip_smoke.using_library``).
The working sets are those of ``graph_pair.py --generic``: the full
VKITTI2 grid at K = 63 after 6 frames of the vkitti2 scene, its next
frame's moving-object cleanup and birth (cut to their rows), and 400 real
rows of the reduced grid at K = 63 and 127 (``chip_smoke.merge_inputs``).
Prints each version's ptxas registers and spills, a line a working set,
and one line ``VARIANTS {json}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path, help="versions of csrc/ to build and time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch
    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
    from semantic_dsp_map_tpu_torch.ops import cuda_lib
    from semantic_dsp_map_tpu_torch.ops.birth import merge_blocks_plain
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda
    from semantic_dsp_map_tpu_torch.timing import card_line

    card = card_line(torch.device("cuda"))
    names = [str(d) for d in args.dirs]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda d: cuda_lib.build(d.resolve()), args.dirs))
    libs = {}
    for name, (path, _, log) in zip(names, built):
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "merge_generic_kernel" in line and "Compiling entry" in line:
                print(f"[variants] {name} {'ACC' if 'ILb1E' in line else 'count-only'}: "
                      f"{lines[i + 2].strip()} | {lines[i + 3].strip()}", flush=True)
        libs[name] = cuda_lib.load(path)

    scenes = cs.bench_scenes()
    params = FilterParams(**scenes.VK_PARAMS)
    cfg = virtual_kitti2_config(max_particle_num_per_voxel_n=6)
    synth = scenes.synth_vkitti2_frame
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    frames = 6
    for t in range(frames):
        dsp.update(*synth(cfg, t, MaskKpts))
    depth, masks, pos, quat = synth(cfg, frames, MaskKpts)
    step = build_frame_step(cfg, dsp.params, dsp.registry)
    buf = pack_frame(cfg, dsp.registry, depth, masks, pos, quat, 0.1 * frames - dsp._time_origin)
    f = unpack_frame(cfg, dsp._static_table, torch.from_numpy(buf).cuda())
    with cs.MergeRecorder() as rec:
        dsp.state, _, _ = step(dsp.state, f)
    torch.cuda.synchronize()
    sets = dict(zip(("k63_cleanup", "k63_birth"), rec.calls))
    del dsp, step, f, rec
    torch.cuda.empty_cache()
    for slots_n in (6, 7):
        c = virtual_kitti2_config(**scenes.REDUCED_VKITTI2, max_particle_num_per_voxel_n=slots_n)
        sets[f"k{(1 << slots_n) - 1}_reduced"] = (c, *cs.merge_inputs(c, c.max_birth_blocks, 400),
                                                  True)

    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    out = {}
    for sname, (cfg, flat, blocks, vax, staged, resample) in sets.items():
        fields = [fl.name for fl in dataclasses.fields(flat)]
        before = {k: getattr(flat, k).clone() for k in fields}
        want = type(flat)(**{k: v.clone() for k, v in before.items()})
        _, acc_p = merge_blocks_plain(cfg, want, blocks, vax, staged, resample)
        work = type(flat)(**{k: v.clone() for k, v in before.items()})

        def restore():
            for k in fields:
                getattr(work, k).copy_(before[k])

        run = lambda: merge_blocks_cuda(cfg, work, blocks, vax, staged, resample)
        for name, lib in libs.items():
            with cs.using_library(lib):
                restore()
                _, acc = run()
                torch.cuda.synchronize()
            if int(acc) != int(acc_p) or not all(
                    torch.equal(bits(getattr(work, k)), bits(getattr(want, k))) for k in fields):
                raise AssertionError(f"[variants] {sname}: {name} parts from the plain version")
        times = {name: [] for name in libs}
        for r in range(4):  # in turns, the order reversed every other round
            for name in (names if r % 2 == 0 else names[::-1]):
                with cs.using_library(libs[name]):
                    times[name].append(cs.cuda_ms(run, 10, queued=True, setup=restore))
        out[sname] = {name: float(np.median(v)) for name, v in times.items()}
        print(f"[variants] {sname}: " + ", ".join(
            f"{name} {np.median(v):.4f} ({min(v):.4f}-{max(v):.4f})" for name, v in times.items())
            + f" ms device-only, equal to the plain version ({card})", flush=True)
    result = {"card": card, "device_only_ms": out}
    print("VARIANTS " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
