"""A configuration, a traffic mix, a metric and a cell added as new files
alone: the harness takes them without an edit."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from dspbench.tests.small import reduced_map_config

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def test_new_files_alone_make_a_new_cell(tmp_path):
    shutil.copytree(ROOT, tmp_path / "dspbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    d = tmp_path / "dspbench"

    config = json.loads((d / "configs" / "vkitti2.json").read_text())
    config["map_config"] = reduced_map_config(config, "vkitti2")
    (d / "configs" / "vkitti2_small.json").write_text(json.dumps(config))
    mix = json.loads((d / "traffic" / "drive.json").read_text())
    mix.update(ring=10, ego={"velocity": [0.0, 0.0, 0.1], "yaw": 0.01})
    (d / "traffic" / "creep.json").write_text(json.dumps(mix))
    (d / "metrics" / "frames_handed.py").write_text(
        '"""frames_handed: frames handed in during the window."""\n\n\n'
        "def read(run):\n    return float(len(run.frames))\n")
    limits = json.loads((d / "limits" / "vkitti2.drive.json").read_text())
    (d / "limits" / "vkitti2_small.creep.json").write_text(json.dumps(limits))

    bench["configs"].append({"name": "vkitti2_small", "source": "the vkitti2 preset cut",
                             "file": "dspbench/configs/vkitti2_small.json",
                             "reduced": ["voxel_num_axis_x_n"], "why": "a test"})
    bench["workloads"].append({"name": "vkitti2_small.creep", "config": "vkitti2_small",
                               "traffic": "creep", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_handed", "unit": "frames", "better": "higher",
                                "bound": 0.01, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, torch; torch.set_num_threads(2)\n"
            "from dspbench import harness\n"
            "cell = harness.load_cell('vkitti2_small.creep')\n"
            "out = harness.run_cell(cell, 4, 0.5, False, device='cpu')\n"
            "print(harness.__file__)\n"
            "print(json.dumps(out))\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=900, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    where, line = run.stdout.strip().splitlines()[-2:]
    assert where.startswith(str(tmp_path))
    out = json.loads(line)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s", "frames_handed"}
    assert out["metrics"]["frames_handed"]["value"] == out["attempted"]
