"""The frozen reference against the port's CPU path, a whole run of a cell
on the CPU (its last line), and the faults the output check must see."""

import dataclasses
import json

import pytest
import torch

from dspbench import check, harness, traffic
from dspbench.reference import Reference
from dspbench.tests.small import load_cell, reduced_map_config, small_cell

torch.set_num_threads(2)


@pytest.mark.parametrize("workload,frames", [("vkitti2.drive", 3), ("zed2.walk", 5)])
def test_the_reference_steps_as_the_ports_cpu_path(workload, frames):
    from semantic_dsp_map_tpu_torch import FilterParams, MapConfig, SemanticDSPMap
    from semantic_dsp_map_tpu_torch import MaskKpts

    cell = small_cell(workload)
    m, fp = cell.config["map_config"], cell.config["filter_params"]
    dsp = SemanticDSPMap(MapConfig(**m), FilterParams(**fp), seed=77, device="cpu")
    ref = Reference(m, fp, "cpu")
    st = ref.init_state(77)
    ring = traffic.Ring(cell.mix, traffic.Camera.of(m), 5)
    for i in range(frames):
        f = ring.frame(i)
        res, _ = dsp.update(f.depth, [MaskKpts(**k) for k in f.masks], f.cam_pos, f.cam_quat,
                            f.time)
        st, r, _ = ref.frame(st, f.depth, f.masks, f.cam_pos, f.cam_quat, f.time)
        out = {"occ": res.occ, "label": res.label, "track": res.track,
               "weight_sum": res.weight_sum}
        numbers = check.compare(check.snapshot(dsp.state), out, st, r)
        assert numbers == dict.fromkeys(check.NUMBERS, 0.0), (i, numbers)
    assert int((r.occ == 1).sum()) > 0 and int(st.global_time) == frames


def run_small(workload="zed2.walk", seed=2**31 + 5, seconds=0.5, traced=False):
    return harness.run_cell(small_cell(workload), seed, seconds, traced, device="cpu")


def test_a_run_on_the_cpu_is_correct_and_its_line_has_the_contracts_shape():
    out = run_small()
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(check.NUMBERS)
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(out))
    assert harness.limits_lines(out)[0].startswith("check objects_gap: ")


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(monkeypatch):
    monkeypatch.setattr(harness, "TRACE_FIRST", 1)
    monkeypatch.setattr(harness, "TRACE_FRAMES", 1)
    monkeypatch.setattr(harness, "PACK_SECONDS", 0.05)
    out = run_small(seconds=2.5, traced=True)
    assert out["correct"] is True
    assert {"update_host_ms", "pack_ms"} <= set(out["metrics"])
    assert "frames_per_s" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _restore(static, saved):
    for f in dataclasses.fields(static):
        s, v = getattr(static, f.name), saved[f.name]
        if isinstance(s, torch.Generator):
            s.set_state(v)
        elif isinstance(s, torch.Tensor):
            s.copy_(v)
        else:
            _restore(s, v)


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from semantic_dsp_map_tpu_torch import step_graph

    step = step_graph.StaticStep.__call__

    def unchanged(self, kind, frame, state):
        saved = check.snapshot(state)
        out = step(self, kind, frame, state)
        _restore(self.state, saved)
        return out

    monkeypatch.setattr(step_graph.StaticStep, "__call__", unchanged)
    out = run_small()
    assert out["correct"] is False
    assert out["checks"]["store_parted"]["value"] > out["checks"]["store_parted"]["limit"]


def test_an_answer_altered_where_it_is_made_is_not_correct(monkeypatch):
    from semantic_dsp_map_tpu_torch import map as dsp_map

    render = dsp_map.render_occupancy

    def altered(cfg, state, threshold):
        particles, result = render(cfg, state, threshold)
        occ = result.occ.clone()
        occ[:1000] = torch.where(occ[:1000] == 1, 0, 1)  # a thousand voxels' answers changed
        return particles, result._replace(occ=occ)

    monkeypatch.setattr(dsp_map, "render_occupancy", altered)
    out = run_small()
    assert out["correct"] is False
    assert out["checks"]["render_parted"]["value"] > out["checks"]["render_parted"]["limit"]


def test_the_config_files_are_the_ports_presets():
    from semantic_dsp_map_tpu_torch import FilterParams, config
    from semantic_dsp_map_tpu_torch.benchmarks import scenes

    for name, params in (("vkitti2", scenes.VK_PARAMS), ("zed2", scenes.ZED2_PARAMS)):
        cell = load_cell(f"{name}.{'drive' if name == 'vkitti2' else 'walk'}")
        preset = getattr(config, cell.config["preset"])()
        assert cell.config["map_config"] == dataclasses.asdict(preset)
        assert cell.config["filter_params"] == dataclasses.asdict(FilterParams(**params))
        assert reduced_map_config(cell.config, name) != cell.config["map_config"]
