"""Sequence replay loop + CLI (counterpart of
``semantic_dsp_map_tpu/replay.py``).

The non-ROS equivalent of the reference's replay validation loop
(src/mapping.cpp:148-316 + rosbag): feed a recorded sequence through the map
and write colored occupancy point clouds.

Usage::

    python -m semantic_dsp_map_tpu_torch.replay --dataset npz --data DIR \
        --preset vkitti2 [--options cfg/options.yaml] [--csv object_info.csv] \
        --out out_dir [--ply-every 10] [--device cpu]

The map runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time as _time
from typing import Optional

from .config import (
    FilterParams,
    filter_params_from_yaml,
    kitti360_config,
    virtual_kitti2_config,
    zed2_config,
)
from .datasets import Frame, Kitti360Sequence, NpzSequence, VirtualKitti2Sequence
from .io import write_ply
from .labels import LabelRegistry
from .map import SemanticDSPMap
from .viz import colorize, in_fov_mask, voxel_positions


_PRESETS = {
    "kitti360": kitti360_config,
    "vkitti2": virtual_kitti2_config,
    "zed2": zed2_config,
}


def run_replay(
    dsp: SemanticDSPMap,
    sequence,
    out_dir: Optional[str] = None,
    ply_every: int = 0,
    drop_first: int = 2,
    verbose: bool = True,
):
    """Replay ``sequence`` through ``dsp``.

    Mirrors the node loop: the first ``drop_first`` frames are consumed for
    tracker warm-up without mapping (src/mapping.cpp:171-174), per-frame
    timing is logged (mapping.cpp:269-279), and occupied/freespace clouds are
    written as PLY when requested.  A frame's time ends when its ``occ`` has
    reached the host.

    Returns a summary dict (frames, fps) and the last result.
    """
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    n_mapped = 0
    total_dt = 0.0
    result = None
    for i, frame in enumerate(sequence):
        if i < drop_first:
            continue
        t0 = _time.perf_counter()
        result, diag = dsp.update(
            frame.depth, frame.masks, frame.cam_pos, frame.cam_quat, frame.time
        )
        occ = result.occ.cpu().numpy()  # the device-to-host copy is the sync
        dt = _time.perf_counter() - t0
        n_mapped += 1
        total_dt += dt

        if verbose:
            d = {k: int(v) for k, v in diag._asdict().items()}
            print(
                f"frame {frame.index}: {dt * 1e3:.1f} ms, "
                f"occupied={int((occ == 1).sum())} {d}",
                flush=True,
            )

        if out_dir and ply_every and n_mapped % ply_every == 0:
            _write_frame_ply(dsp, result, frame, os.path.join(out_dir, f"frame_{frame.index:06d}"))

    if out_dir and result is not None:
        _write_frame_ply(dsp, result, frame, os.path.join(out_dir, "final"))

    fps = n_mapped / total_dt if total_dt > 0 else 0.0
    summary = {"frames": n_mapped, "fps": round(fps, 3)}
    if verbose:
        print(json.dumps(summary), flush=True)
    return summary, result


def _write_frame_ply(dsp: SemanticDSPMap, result, frame: Frame, path_prefix: str):
    vpos = voxel_positions(dsp.cfg, dsp.state.scroll)
    fov = in_fov_mask(dsp.cfg, vpos, frame.cam_pos, frame.cam_quat)
    clouds = colorize(
        dsp.cfg, dsp.params, dsp.registry, result, frame.cam_pos, vpos, fov
    )
    write_ply(path_prefix + "_occupied.ply", clouds["occupied_xyz"], clouds["occupied_rgb"])
    if dsp.params.if_output_freespace:
        write_ply(
            path_prefix + "_freespace.ply",
            clouds["freespace_xyz"],
            clouds["freespace_rgb"],
        )


def main(argv=None):
    """The CLI; returns (summary, last result) of :func:`run_replay`."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", choices=["kitti360", "vkitti2", "npz"], required=True)
    ap.add_argument("--data", required=True, help="sequence directory")
    ap.add_argument("--depth-dir", help="kitti360: depth .npy dir")
    ap.add_argument("--semantic-dir", help="kitti360: semantic .png dir")
    ap.add_argument("--pose-txt", help="kitti360: pose txt")
    ap.add_argument("--preset", choices=sorted(_PRESETS), default=None)
    ap.add_argument("--options", help="reference-format options YAML")
    ap.add_argument("--csv", help="reference-format object-info CSV")
    ap.add_argument("--out", help="output dir for PLY clouds")
    ap.add_argument("--ply-every", type=int, default=0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--drop-first", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device of the map (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    preset = args.preset or {"kitti360": "kitti360", "vkitti2": "vkitti2", "npz": "vkitti2"}[args.dataset]
    cfg = _PRESETS[preset]()
    params = filter_params_from_yaml(args.options) if args.options else FilterParams()
    registry = LabelRegistry.from_csv(args.csv) if args.csv else LabelRegistry.default()

    if args.dataset == "kitti360":
        seq = Kitti360Sequence(
            args.depth_dir or os.path.join(args.data, "depth"),
            args.semantic_dir or os.path.join(args.data, "semantic"),
            args.pose_txt or os.path.join(args.data, "poses.txt"),
        )
    elif args.dataset == "vkitti2":
        seq = VirtualKitti2Sequence(args.data, registry=registry)
    else:
        seq = NpzSequence(args.data)

    if args.max_frames:
        seq = itertools.islice(iter(seq), args.max_frames)

    dsp = SemanticDSPMap(cfg, params, registry, device=args.device)
    return run_replay(dsp, seq, out_dir=args.out, ply_every=args.ply_every,
                      drop_first=args.drop_first)


if __name__ == "__main__":
    main()
