"""A configuration, a traffic mix, a metric and a cell added as new files
alone: the harness takes them without an edit.  The second case adds a
configuration in template mode that names its own reference module and
its template bank (``"reference"``, ``"setup"``)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dspbench.tests.small import reduced_map_config

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent

#: A reference module under ``dspbench.`` that wraps the frozen package
#: and records the keywords its constructor is given.
PROBE = '''"""The frozen reference, recording its constructor's keywords."""

from dspbench import reference as frozen

state_from_fields = frozen.state_from_fields
SEEN = []


class Reference(frozen.Reference):
    def __init__(self, cfg, params, device, **setup):
        SEEN.append(setup)
        super().__init__(cfg, params, device)
'''


@pytest.mark.parametrize("case", ["plain", "template"])
def test_new_files_alone_make_a_new_cell(tmp_path, case):
    shutil.copytree(ROOT, tmp_path / "dspbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    d = tmp_path / "dspbench"
    name = "vkitti2_small" if case == "plain" else "vkitti2_tpl"

    config = json.loads((d / "configs" / "vkitti2.json").read_text())
    config["map_config"] = reduced_map_config(config, "vkitti2")
    metric = ("frames_handed", "frames handed in during the window", "float(len(run.frames))",
              "frames")
    if case == "template":
        shutil.copytree(REPO / "data" / "templates", tmp_path / "data" / "templates")
        (d / "reference_probe").mkdir()
        (d / "reference_probe" / "__init__.py").write_text(PROBE)
        config["filter_params"]["if_use_template_matching"] = True
        config["reference"] = "dspbench.reference_probe"
        config["setup"] = {"templates": "data/templates"}
        metric = ("templates_loaded", "templates the map's bank loaded at set-up",
                  "float(run.templates)", "templates")
    (d / "configs" / f"{name}.json").write_text(json.dumps(config))
    mix = json.loads((d / "traffic" / "drive.json").read_text())
    mix.update(ring=10, ego={"velocity": [0.0, 0.0, 0.1], "yaw": 0.01})
    (d / "traffic" / "creep.json").write_text(json.dumps(mix))
    (d / "metrics" / f"{metric[0]}.py").write_text(
        f'"""{metric[0]}: {metric[1]}."""\n\n\ndef read(run):\n    return {metric[2]}\n')
    limits = json.loads((d / "limits" / "vkitti2.drive.json").read_text())
    (d / "limits" / f"{name}.creep.json").write_text(json.dumps(limits))

    bench["configs"].append({"name": name, "source": "the vkitti2 preset cut",
                             "file": f"dspbench/configs/{name}.json",
                             "reduced": ["voxel_num_axis_x_n"], "why": "a test"})
    bench["workloads"].append({"name": f"{name}.creep", "config": name,
                               "traffic": "creep", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": metric[0], "unit": metric[3], "better": "higher",
                                "bound": 0.01, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    seen = "__import__('dspbench.reference_probe').reference_probe.SEEN"
    code = ("import json, torch; torch.set_num_threads(2)\n"
            "from dspbench import harness\n"
            f"cell = harness.load_cell('{name}.creep')\n"
            "out = harness.run_cell(cell, 4, 0.5, False, device='cpu')\n"
            f"print(json.dumps({seen if case == 'template' else None}))\n"
            "print(harness.__file__)\n"
            "print(json.dumps(out))\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=900, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    seen, where, line = run.stdout.strip().splitlines()[-3:]
    assert where.startswith(str(tmp_path))
    out = json.loads(line)
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s", metric[0]}
    if case == "plain":
        assert out["correct"] is True
        assert out["metrics"]["frames_handed"]["value"] == out["attempted"]
    else:  # the probe was the check's reference, handed the bank's absolute folder
        assert json.loads(seen) == [{"templates": str(tmp_path / "data" / "templates")}]
        assert out["metrics"]["templates_loaded"]["value"] == 1
