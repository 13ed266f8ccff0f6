"""Cells of the benchmark cut to the port's reduced sizes, for tests on the
CPU: copies of ``REDUCED_VKITTI2`` and ``REDUCED_ZED2`` of the port's
``benchmarks/scenes.py`` (held equal to them by a test), kept here so that
a test of the reference can cut a configuration without loading the
port."""

from __future__ import annotations

import json

from dspbench import harness

REDUCED = {
    "vkitti2": dict(
        voxel_num_axis_x_n=6, voxel_num_axis_y_n=5, voxel_num_axis_z_n=6, voxel_size=0.5,
        camera_fx=725.0087 / 4, camera_fy=725.0087 / 4, camera_cx=620.5 / 4,
        camera_cy=187.0 / 4, image_width=310, image_height=94, max_moving_blocks=8,
        max_active_blocks=512, max_table_entries=1 << 16, max_birth_blocks=512,
        corner_gather_blocks=256,
    ),
    "zed2": dict(
        voxel_num_axis_x_n=6, voxel_num_axis_y_n=4, voxel_num_axis_z_n=6, voxel_size=0.3,
        camera_fx=527.8191528320312 / 4, camera_fy=527.8191528320312 / 4,
        camera_cx=633.9357299804688 / 4, camera_cy=366.3338623046875 / 4,
        image_width=320, image_height=180, max_table_entries=1 << 15, max_active_blocks=256,
        max_birth_blocks=256,
    ),
}


def reduced_map_config(config: dict, name: str) -> dict:
    cfg = dict(config["map_config"])
    cfg.update(REDUCED[name])
    return cfg


def load_cell(workload: str) -> harness.Cell:
    """``harness.load_cell``, also for a cell whose files lie under
    ``dspbench/`` (``configs/<config>.json``, ``traffic/<mix>.json``,
    ``limits/<cell>.json``) but which ``BENCHMARK.json`` does not list yet."""
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    if workload not in {w["name"] for w in bench["workloads"]}:
        config, mix = workload.split(".")
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": config, "file": f"dspbench/configs/{config}.json"})
        bench["workloads"].append({"name": workload, "config": config, "traffic": mix,
                                   "chips": 1})
    return harness.load_cell(workload, bench)


def small_cell(workload: str) -> harness.Cell:
    cell = load_cell(workload)
    cfg = reduced_map_config(cell.config, workload.split(".")[0])
    return cell._replace(config={**cell.config, "map_config": cfg})
