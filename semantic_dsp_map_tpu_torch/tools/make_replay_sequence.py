"""Generate the tiny replay sequence and its expected occupancy summary
(counterpart of ``tools/make_replay_sequence.py``).

The reference's validation loop is bag replay (README.md:49-70); this is its
committed equivalent: a 12-frame dynamic scene (static wall, far free-space
band, moving tracked car, ego motion) in NpzSequence format at the
tiny-config scale (about 10 KB a frame), plus EXPECTED.json holding the
per-frame occupied/free counts and diagnostics of a replay of it.  The
sequence this writes equals the committed ``data/replay_tiny`` array for
array, and so does the summary; the tool itself never writes into ``data/``:

    python -m semantic_dsp_map_tpu_torch.tools.make_replay_sequence --out DIR [--device cpu]

The map runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from ..config import FilterParams, tiny_test_config
from ..datasets import Frame, NpzSequence, save_npz_frame
from ..frontend import MaskKpts
from ..map import SemanticDSPMap

N_FRAMES = 12
DROP_FIRST = 2


def make_frame(cfg, t: int) -> Frame:
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:4, :] = 9.5111  # beyond depth_range_max -> free space
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[8:16, (4 + t) % W : (12 + t) % W] = 1
    depth[car > 0] = 1.2157
    dx, dy = 0.15131, 0.02071
    kpts = np.array(
        [
            [0.2071 + dx * t, dy * t, 1.2157],
            [0.6113 + dx * t, dy * t, 1.2157],
            [0.2071 + dx * t, -0.3041 + dy * t, 1.2157],
            [0.6113 + dx * t, -0.3041 + dy * t, 1.2157],
            [0.2071 + dx * t, dy * t, 1.5119],
        ],
        np.float32,
    )
    masks = [
        MaskKpts(track_id=65535, label="static", mask=static),
        MaskKpts(track_id=3, label="Car", mask=car, kpts_current=kpts,
                 kpts_previous=kpts - np.array([dx, dy, 0], np.float32)),
    ]
    return Frame(
        depth=depth,
        masks=masks,
        cam_pos=np.array([0.02133 * t, 0, 0.26177 * t], np.float32),
        cam_quat=np.array([1, 0, 0, 0], np.float32),
        time=0.15 * t,
        index=t,
    )


def replay_params() -> FilterParams:
    return FilterParams(
        if_consider_depth_noise=True,
        nb_ptc_num_per_point=1,
        depth_noise_model_zero_order=0.2,
        prediction_stddev=0.0,
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI; returns the expected summary it wrote."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the frames and EXPECTED.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the map (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, replay_params(), device=args.device)
    os.makedirs(args.out, exist_ok=True)
    for t in range(N_FRAMES):
        save_npz_frame(args.out, t, make_frame(cfg, t))

    # replay it and record the expected per-frame summary
    frames = []
    for i, frame in enumerate(NpzSequence(args.out)):
        if i < DROP_FIRST:
            continue
        result, diag = dsp.update(
            frame.depth, frame.masks, frame.cam_pos, frame.cam_quat, frame.time
        )
        occ = result.occ.cpu().numpy()
        frames.append(
            dict(
                index=frame.index,
                occupied=int((occ == 1).sum()),
                free=int((occ == 0).sum()),
                unknown=int((occ == -1).sum()),
                visible=int(diag.visible_count),
                born=int(diag.born_count),
                moved=int(diag.moved_count),
            )
        )
    expected = dict(n_frames=N_FRAMES, drop_first=DROP_FIRST, frames=frames)
    with open(os.path.join(args.out, "EXPECTED.json"), "w") as f:
        json.dump(expected, f, indent=1)
    print(json.dumps(expected["frames"][-1]))
    print(f"wrote {N_FRAMES} frames + EXPECTED.json to {args.out}")
    return expected


if __name__ == "__main__":
    main()
