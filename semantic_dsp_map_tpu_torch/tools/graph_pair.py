"""Replay device busy of ``chip_smoke.py``'s ``[graph]`` vkitti2 and zed2
paths, or with ``--wide`` the device time of the PHD passes on ``[wide]``'s
recorded real frames, from the ``chip_smoke.py`` and the package of a
checkout given by path: this one, or another version unpacked beside it
(``git archive REV | tar -x -C DIR``), so that two versions are timed in
turns in one call on one card.  Run it as a script, not as a module (a
module run would import this checkout's package first)::

    python3 semantic_dsp_map_tpu_torch/tools/graph_pair.py DIR
    python3 semantic_dsp_map_tpu_torch/tools/graph_pair.py DIR --wide
    python3 semantic_dsp_map_tpu_torch/tools/graph_pair.py DIR --generic

Prints one line ``PAIR {json}``: each path's device busy ms and kernels of
a profiled replay, the graph frames' median ms and the five frame kernels'
device ms in the replay; or with ``--wide`` each case's device-only and
host-included ms (medians of 10), terms and bound: pass A at R = 16 on a
real S = 12 frame and at S = 512, pass B at S = 512, and each pass's first
wide shape beside the main one just below it (pass A at S = 67 / 68 and
R = 12 / 13, pass B at S = 431 / 432); or with ``--generic`` the same for
the render's and birth's merge's generic instances (K past 31): the render
on the full VKITTI2 grid at K = 63 after 6 frames of the vkitti2 scene
(each launch on the store as it was before the render) and on the reduced
grid at K = 63 and 127 after 4 frames of the reduced hostile scene, both
merge instances on that map's next frame's birth and moving-object
cleanup working sets (cut to their rows) and on a working set of 400 real
rows of the reduced grid; beside the card's name and power limit.  The
modes use only functions that ``chip_smoke.py`` has had since the generic
and wide instances first ran (``recorded_passes``, ``cuda_ms``,
``render_runner``, ``MergeRecorder``, the censuses and bounds), so an
older checkout runs them too.
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


def generic_cases(cs, card) -> dict:
    """The ``--generic`` cases, timed with ``cs`` (a checkout's chip_smoke):
    each kernel's device-only and host-included ms (medians of 10), its
    bound, and the census its bound counts."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
    from semantic_dsp_map_tpu_torch.ops import codecs
    from semantic_dsp_map_tpu_torch.ops.birth import merge_blocks_plain
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import (
        merge_blocks_accepted_cuda, merge_blocks_cuda,
    )
    from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda

    scenes = cs.bench_scenes()
    params = FilterParams(**scenes.VK_PARAMS)

    def timed(run, restore):
        return {"device_only_ms": cs.cuda_ms(run, 10, queued=True, setup=restore),
                "ms": cs.cuda_ms(run, 10, setup=restore)}

    def render_case(name, dsp):
        cfg, st = dsp.cfg, dsp.state
        p, vst = st.particles, st.voxel_stamp
        vax = codecs.axis_stamps_per_voxel(cfg, st.scroll)
        thr = dsp.params.occupancy_threshold
        pk = dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())
        pk, r = render_core_cuda(cfg, pk, vst, vax, thr)
        c = cs.render_census(cfg, p, pk, vax, vst, r)
        del pk, r
        out = {**timed(*cs.render_runner(cfg, p, vst, vax, thr)), **c["bound"],
               "with_status": c["with_status"], "alive": c["alive"]}
        torch.cuda.empty_cache()
        return report(name, out)

    def merge_case(name, cfg, flat, blocks, vax, staged, resample, accepted):
        fields = [f.name for f in dataclasses.fields(flat)]
        before = {k: getattr(flat, k).clone() for k in fields}
        after = type(flat)(**{k: v.clone() for k, v in before.items()})
        _, acc = merge_blocks_plain(cfg, after, blocks, vax, staged, resample)[:2]
        b, n_real = cs.merge_bound(cfg, blocks, staged, before, after, resample, acc)
        if accepted:  # the mask's bytes
            b = cs.bound(b["bound_ms"] * 1e-3 * cs.HBM_BYTES_PER_S + staged.meta.numel())
        work = type(flat)(**{k: v.clone() for k, v in before.items()})

        def restore():
            for k in fields:
                getattr(work, k).copy_(before[k])

        kernel = merge_blocks_accepted_cuda if accepted else merge_blocks_cuda
        out = {**timed(lambda: kernel(cfg, work, blocks, vax, staged, resample), restore), **b,
               "rows": blocks.ids.shape[0], "real_rows": n_real, "accepted": int(acc)}
        del before, after, work
        return report(name, out)

    def report(name, o):
        o["share"] = o["bound_ms"] / o["device_only_ms"]
        print(f"[pair] {name}: {o['device_only_ms']:.4f} ms device-only ({o['ms']:.4f}), bound "
              f"{o['bound_ms']:.4f} by {o['bound_by']}, share {o['share']:.3f} ({card})", flush=True)
        return o

    out = {}
    # the full grid at K = 63: 6 frames, then one eager frame's two merges
    cfg = virtual_kitti2_config(max_particle_num_per_voxel_n=6)
    synth = scenes.synth_vkitti2_frame
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    frames = 6
    for t in range(frames):
        dsp.update(*synth(cfg, t, MaskKpts))
    out["render_k63_full"] = render_case("render_k63_full", dsp)
    depth, masks, pos, quat = synth(cfg, frames, MaskKpts)
    step = build_frame_step(cfg, dsp.params, dsp.registry)
    buf = pack_frame(cfg, dsp.registry, depth, masks, pos, quat, 0.1 * frames - dsp._time_origin)
    f = unpack_frame(cfg, dsp._static_table, torch.from_numpy(buf).cuda())
    with cs.MergeRecorder() as rec:
        dsp.state, _, _ = step(dsp.state, f)
    torch.cuda.synchronize()
    del step, f, dsp
    torch.cuda.empty_cache()
    for (label, args), accepted in ((pair, acc) for pair in zip(("cleanup", "birth"), rec.calls)
                                    for acc in (False, True)):
        key = f"merge{'_accepted' if accepted else ''}_k63_{label}"
        out[key] = merge_case(key, *args, accepted)
    del rec
    torch.cuda.empty_cache()
    # the reduced grid at K = 63 and 127: 4 frames of the reduced hostile scene
    for slots_n in (6, 7):
        K = (1 << slots_n) - 1
        cfg = virtual_kitti2_config(**scenes.REDUCED_VKITTI2, max_particle_num_per_voxel_n=slots_n)
        dsp = SemanticDSPMap(cfg, params, device="cuda")
        for t in range(4):
            dsp.update(*cs.reduced_hostile_scene(cfg, t, MaskKpts))
        out[f"render_k{K}_reduced"] = render_case(f"render_k{K}_reduced", dsp)
        del dsp
        args = cs.merge_inputs(cfg, cfg.max_birth_blocks, 400)
        for accepted in (False, True):
            key = f"merge{'_accepted' if accepted else ''}_k{K}_reduced"
            out[key] = merge_case(key, cfg, *args, True, accepted)
        del args
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", type=Path, help="the checkout whose package and chip_smoke.py run")
    ap.add_argument("--wide", action="store_true",
                    help="time the PHD passes' wide cases instead of the graph paths")
    ap.add_argument("--generic", action="store_true",
                    help="time the render's and the merge's generic instances (K past 31) "
                         "instead of the graph paths")
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
    if args.wide or args.generic:
        key, cases = ("wide", wide_cases) if args.wide else ("generic", generic_cases)
        result = {"who": str(root), "card": card, key: cases(cs, card)}
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
