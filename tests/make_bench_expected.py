"""Write the full-size expected files under data/bench_expected/.

Not a test (pytest does not collect it): full size takes minutes a scene.
A file holds, for frames 0..N-1 of one bench scene at ``virtual_kitti2_config()``
with ``VK_PARAMS`` and ``prediction_stddev=0.0``, the nine StepDiagnostics
counters and the counts of occupied, free and unknown voxels that the JAX
package gives on the CPU, jitted as ``SemanticDSPMap.update`` is; and, where
the port's CPU path gives another integer, that one beside it under
``port_cpu``.  ``chip_smoke.py`` holds the card to these files.

Two steps, each its own process (the second needs the first's file):

    JAX_PLATFORMS=cpu python tests/make_bench_expected.py jax vkitti2_hostile
    python tests/make_bench_expected.py port vkitti2_hostile

and the same for ``vkitti2``.  ``--frames`` (default 8).  A third
step enters what a card gave where that is neither of the two (from the
file that ``chip_smoke.py --record-expected`` leaves):

    python tests/make_bench_expected.py card vkitti2_hostile --from chiprun_out/EXPECTED_CARD.json

With ``--jitter`` the ``jax`` step keeps the bench's own parameters (the
default ``prediction_stddev`` 0.05, drawn by ``jax.random``) and writes
``jitter/SCENE.json``: the counters a bench cell of the JAX package gives on
the CPU, frame by frame (``--frames 28`` covers the bench's 3 warm-up and 25
timed frames), to hold a card's peak counters against:

    JAX_PLATFORMS=cpu python tests/make_bench_expected.py jax vkitti2 --jitter --frames 28

With ``--off-boundaries`` the ``jax`` and ``port`` steps run the hostile scene
with its cars 0.07 m off their exact depths (off the voxel boundaries of the
0.2 m grid) and write ``off_boundaries/vkitti2_hostile.json``: what still
parts there is decided by neither the voxel corner nor a moved particle on a
boundary.  ``chip_smoke.py`` holds the card to this file too (the ``card``
step takes the flag as well).
"""

import argparse
import datetime
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCENES = {"vkitti2_hostile": "synth_hostile_frame", "vkitti2": "synth_vkitti2_frame"}


def run(package, scene, frames, jitter=False, offset=0.0):
    """Per-frame counters and occupancy counts of ``scene`` through the JAX
    map (``package == "jax"``) or the port's CPU path; with ``jitter`` at the
    bench's own parameters (the rigid move's jitter on)."""
    from semantic_dsp_map_tpu_torch.benchmarks import scenes

    if package == "jax":
        import semantic_dsp_map_tpu as P

        kw = {}
    else:
        import semantic_dsp_map_tpu_torch as P

        kw = {"device": "cpu"}
    cfg = P.config.virtual_kitti2_config()
    params = dict(scenes.VK_PARAMS) if jitter else dict(scenes.VK_PARAMS, prediction_stddev=0.0)
    dsp = P.SemanticDSPMap(cfg, P.FilterParams(**params), **kw)
    synth = getattr(scenes, SCENES[scene])
    rows = []
    kwargs = {"car_depth_offset": offset} if offset else {}
    for t in range(frames):
        depth, masks, pos, quat = synth(cfg, t, P.MaskKpts, **kwargs)
        result, diag = dsp.update(depth, masks, pos, quat, time=t * 0.1)
        occ = np.asarray(result.occ)
        row = {k: int(v) for k, v in diag._asdict().items()}
        row.update(occupied=int((occ == 1).sum()), free=int((occ == 0).sum()),
                   unknown=int((occ == -1).sum()))
        rows.append(row)
        print(t, row, flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "port", "card"))
    ap.add_argument("scene", choices=sorted(SCENES))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--from", dest="card_file", help="card: the file chip_smoke.py left")
    ap.add_argument("--jitter", action="store_true",
                    help="jax: keep the default prediction_stddev; write jitter/SCENE.json")
    ap.add_argument("--off-boundaries", action="store_true",
                    help="vkitti2_hostile: the cars 0.07 m off their exact depths; write "
                         "off_boundaries/SCENE.json")
    args = ap.parse_args()
    out_dir = os.path.join(REPO, "data", "bench_expected")
    if args.off_boundaries:
        if args.scene != "vkitti2_hostile" or args.jitter:
            ap.error("--off-boundaries goes with vkitti2_hostile, without --jitter")
        out_dir = os.path.join(out_dir, "off_boundaries")
    if args.jitter:
        if args.package != "jax":
            ap.error("--jitter goes with the jax step")
        out_dir = os.path.join(out_dir, "jitter")
    path = os.path.join(out_dir, args.scene + ".json")
    stamp = {"command": "python tests/make_bench_expected.py " + " ".join(sys.argv[1:]),
             "date": datetime.date.today().isoformat()}

    if args.package == "card":
        with open(args.card_file) as f:
            seen = json.load(f)
        with open(path) as f:
            doc = json.load(f)
        doc["card"] = dict(stamp, card=seen["card"], source="chip_smoke.py --record-expected")
        n_parted = 0
        key = args.scene + ("_off_boundaries" if args.off_boundaries else "")
        for frame, row in zip(doc["frames"], seen["scenes"][key]):
            held = dict(frame["jax"], **frame.get("port_cpu", {}))
            parted = {k: v for k, v in row.items() if held[k] != v}
            frame.pop("card", None)
            if parted:
                frame["card"] = parted
                n_parted += len(parted)
        print(f"{n_parted} quantities of the card part from the port's CPU path")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {path}")
        return

    rows = run(args.package, args.scene, args.frames, args.jitter,
               0.07 if args.off_boundaries else 0.0)
    if args.package == "jax":
        import jax

        os.makedirs(out_dir, exist_ok=True)
        doc = {
            "scene": args.scene,
            "synth": "semantic_dsp_map_tpu_torch.benchmarks.scenes." + SCENES[args.scene],
            "synth_kwargs": {"car_depth_offset": 0.07} if args.off_boundaries else {},
            "config": "virtual_kitti2_config()",
            "params": "VK_PARAMS" + ("" if args.jitter else " with prediction_stddev=0.0"),
            "jax": dict(stamp, package="semantic_dsp_map_tpu", platform="cpu",
                        jax_version=jax.__version__, env="JAX_PLATFORMS=cpu"),
            "frames": [{"t": t, "jax": row} for t, row in enumerate(rows)],
        }
    else:
        import torch

        with open(path) as f:
            doc = json.load(f)
        if len(doc["frames"]) != len(rows):
            raise SystemExit(f"{path} holds {len(doc['frames'])} frames, this run {len(rows)}")
        doc["port_cpu"] = dict(stamp, package="semantic_dsp_map_tpu_torch", device="cpu",
                               torch_version=torch.__version__)
        n_parted = 0
        for frame, row in zip(doc["frames"], rows):
            parted = {k: v for k, v in row.items() if frame["jax"][k] != v}
            frame.pop("port_cpu", None)
            if parted:
                frame["port_cpu"] = parted
                n_parted += len(parted)
        print(f"{n_parted} quantities part from the JAX package's")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
