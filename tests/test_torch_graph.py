"""The map's static-state step (``step_graph.StaticStep``) against the eager
step ``map.build_frame_step``, its oracle.

On the CPU the static step runs without capture: it must give the eager
step's bits frame for frame, keep the state's tensors at their addresses,
take over a state put in place from outside (``clear()``, a restored
checkpoint), and make no host read inside the part that the card captures
(a dispatch-mode audit stands in for the capture, which only the card can
make).  The tests marked ``gpu`` capture the step on the card and skip here;
they import no JAX, so on the card they run with

    python3 -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_graph.py
"""

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, tiny_test_config
from semantic_dsp_map_tpu_torch import step_graph
from semantic_dsp_map_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from semantic_dsp_map_tpu_torch.config import (
    KEYPOINTS_BBOX3D, MOVEMENT_ALWAYS, MOVEMENT_NEVER, coda_config, kitti360_config,
    virtual_kitti2_config, zed2_config,
)
from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input, pack_frame
from semantic_dsp_map_tpu_torch.labels import LabelRegistry
from semantic_dsp_map_tpu_torch.objects import refit_svd
from semantic_dsp_map_tpu_torch.map import (
    build_frame_stages, build_frame_step, unpack_frame, unpack_objects,
)
from semantic_dsp_map_tpu_torch.ops.templates import MatchGridConfig
from semantic_dsp_map_tpu_torch.state import (
    clear_map_state, constant, init_map_state, map_state_to_numpy,
)
from semantic_dsp_map_tpu_torch.template_engine import TemplateEngine

from host_sync_audit import HostSyncAudit
from torch_parity import (
    TEMPLATE_SCENE_CFG, TEMPLATE_SCENE_GRID, dynamic_scene, template_scene, zed2_scene,
)

torch.set_num_threads(2)

#: Rigid-move jitter on, so that the step draws from the generator in every
#: stage that can (RANSAC triples, depth noise, move jitter).
NOISY = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
             depth_noise_model_zero_order=0.2, prediction_stddev=0.01)
ZED2_MOVE = dict(bayesian_movement_distance_threshold=0.2, bayesian_movement_increment=0.4,
                 bayesian_movement_decrement=0.05, bayesian_movement_probability_threshold=0.3)

TEMPLATES = "data/templates"

#: The frame on which the template scene's car first shows.  On the card
#: frame 0 runs eagerly and frame 1 is captured: the car's template birth
#: then runs in a replay, and frames 0-1 and those after the birth run no
#: template branch.
LATE_CAR = 2


def late_car_template_scene(cfg, t, masks_cls):
    """``torch_parity.template_scene`` with nothing but the wall before frame
    ``LATE_CAR``."""
    depth, masks, pos, quat, time = template_scene(cfg, t, masks_cls)
    if t < LATE_CAR:
        depth = np.full_like(depth, depth[0, 0])
        masks = masks[:1]
    return depth, masks, pos, quat, time


class Case(NamedTuple):
    cfg: object
    params: dict
    scene: object
    entry: str             # the entry point of the map
    templates: bool = False  # the bank data/templates on TEMPLATE_SCENE_GRID


CASES = {
    "superpoint": Case(tiny_test_config(), NOISY, dynamic_scene, "update"),
    "superpoint_frames": Case(tiny_test_config(), NOISY, dynamic_scene, "update_from_frame"),
    "zed2": Case(tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D), dict(NOISY, **ZED2_MOVE),
                 zed2_scene, "update"),
    "zed2_independent": Case(tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D),
                             dict(NOISY, **ZED2_MOVE, if_use_independent_filter=True),
                             zed2_scene, "update"),
    "smoothed_render": Case(tiny_test_config(),
                            dict(NOISY, if_use_neighbor_smoothed_occupancy=True), dynamic_scene,
                            "update"),
    "movement_never": Case(tiny_test_config(movement_mode=MOVEMENT_NEVER), NOISY, dynamic_scene,
                           "update"),
    "movement_always": Case(tiny_test_config(movement_mode=MOVEMENT_ALWAYS), NOISY,
                            dynamic_scene, "update_from_frame"),
    # Template mode, noise on (the guessed birth's jitter too): the birth
    # branch runs on frame LATE_CAR.  The car stands still, so nothing moves.
    "templates": Case(tiny_test_config(**TEMPLATE_SCENE_CFG),
                      dict(NOISY, if_use_template_matching=True, match_score_threshold=0.2),
                      late_car_template_scene, "update", templates=True),
}


def _new_map(case: Case, device) -> SemanticDSPMap:
    """The case's map, with the template bank loaded in template mode."""
    dsp = SemanticDSPMap(case.cfg, FilterParams(**case.params), device=device)
    if case.templates:
        dsp._templates.grid = MatchGridConfig(**TEMPLATE_SCENE_GRID)
        assert dsp.set_template_path(TEMPLATES) == 1
    return dsp


def _eager_step(case: Case, registry, device):
    """``build_frame_step`` for the case, with template stages of its own
    (their own sweep records) in template mode; returns (step, records)."""
    params = FilterParams(**case.params)
    if not case.templates:
        return build_frame_step(case.cfg, params, registry), None
    engine = TemplateEngine(case.cfg, params, registry, grid=MatchGridConfig(**TEMPLATE_SCENE_GRID))
    engine.set_template_path(TEMPLATES)
    stages = engine.stages(device)
    return build_frame_step(case.cfg, params, registry, stages), stages.records


def _assert_same_records(a, b, msg):
    for stage in a:
        for name, x, y in zip(a[stage]._fields, a[stage], b[stage]):
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y), (
                f"{stage} {name} {msg}")


def _feed(dsp, entry, raw):
    if entry == "update":
        return dsp.update(*raw)
    return dsp.update_from_frame(build_frame_input(dsp.cfg, dsp.registry, *raw))


def _eager_frame(dsp, entry, raw, device):
    """The frame as the eager step's input: the same packed or host frame
    the map gets, on ``device``."""
    if entry == "update":
        *frame, time = raw  # the map counts time from its first frame
        buf = pack_frame(dsp.cfg, dsp.registry, *frame, time - dsp._time_origin)
        return unpack_frame(dsp.cfg, dsp._static_table, torch.from_numpy(buf).to(device))
    host = build_frame_input(dsp.cfg, dsp.registry, *raw)
    return type(host)(*(torch.as_tensor(np.asarray(a)).to(device) for a in host))


def _assert_same(state_a, state_b, res_a, res_b, diag_a, diag_b, msg):
    a, b = map_state_to_numpy(state_a), map_state_to_numpy(state_b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {msg}")
    for name in res_a._fields:
        assert torch.equal(getattr(res_a, name), getattr(res_b, name)), f"{name} {msg}"
    assert {k: int(v) for k, v in diag_a._asdict().items()} == {
        k: int(v) for k, v in diag_b._asdict().items()}, msg


def _hold_against_eager(name, device, frames=10, on_frame=None):
    """The map's static step against ``build_frame_step`` on a state of its
    own, bit for bit every frame (in template mode the sweep records too);
    returns the map."""
    case = CASES[name]
    cfg, entry = case.cfg, case.entry
    dsp = _new_map(case, device)
    step, records = _eager_step(case, dsp.registry, device)
    state = init_map_state(cfg, 0, device)
    moved = 0
    births = []
    for t in range(frames):
        raw = case.scene(cfg, t, MaskKpts)
        res, diag = _feed(dsp, entry, raw)
        state, res_e, diag_e = step(state, _eager_frame(dsp, entry, raw, device))
        _assert_same(dsp.state, state, res, res_e, diag, diag_e, f"{name} frame {t}")
        moved += int(diag.moved_count)
        if case.templates:
            _assert_same_records(dsp._templates.records, records, f"{name} frame {t}")
            births.append(int(records["birth"].count))
        if on_frame is not None:
            on_frame(t, dsp)
    if case.templates:
        # One birth sweep, on frame LATE_CAR; no branch on any other frame.
        assert births == [0] * LATE_CAR + [1] * (frames - LATE_CAR), births
        assert int(records["rematch"].count) == 0
        assert not bool(state.objects.to_match_templates.any())
    elif cfg.movement_mode != MOVEMENT_NEVER:
        assert moved > 0, "the rigid moves never ran"
    return dsp


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_step_equals_eager_step(case):
    """State, RenderResult and every StepDiagnostics counter equal to the
    eager step's, frame for frame, over both entry points, both keypoint
    modes, the three movement modes, the independent filter and the smoothed
    render."""
    dsp = _hold_against_eager(case, "cpu")
    assert not dsp._static.graphs  # nothing is captured on the CPU


def _tensors(state):
    out = {}
    for field in dataclasses.fields(state):
        v = getattr(state, field.name)
        if isinstance(v, torch.Tensor):
            out[field.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{field.name}.{k}": t for k, t in _tensors(v).items()})
    return out


def test_state_keeps_its_addresses(tmp_path):
    """Every state tensor keeps its address over frames of both entry points,
    over ``clear()`` and over a restored checkpoint; the generator object
    stays the map's."""
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**NOISY), device="cpu")
    ptrs = {k: t.data_ptr() for k, t in _tensors(dsp.state).items()}
    rng = dsp.state.rng
    for t in range(6):
        raw = dynamic_scene(cfg, t, MaskKpts)
        _feed(dsp, "update" if t % 2 else "update_from_frame", raw)
        if t == 2:
            save_checkpoint(str(tmp_path / "ck"), dsp.state)
            dsp.clear()
        if t == 4:
            dsp.state = load_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")
    assert {k: t.data_ptr() for k, t in _tensors(dsp.state).items()} == ptrs
    assert dsp.state.rng is rng


def test_result_survives_the_next_frame():
    """A result the caller keeps is not overwritten by the next frame."""
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**NOISY), device="cpu")
    res, diag = dsp.update(*dynamic_scene(cfg, 0, MaskKpts))
    kept = [t.clone() for t in res] + [t.clone() for t in diag]
    dsp.update(*dynamic_scene(cfg, 1, MaskKpts))
    for a, b in zip(kept, list(res) + list(diag)):
        assert torch.equal(a, b)


def test_clear_and_restore_give_the_eager_map(tmp_path):
    """``clear()`` after frame 3, and the frame-5 checkpoint loaded again
    after frame 7: the map continues as the eager step does from the same
    states, generator included."""
    cfg, params = tiny_test_config(), FilterParams(**NOISY)
    dsp = SemanticDSPMap(cfg, params, device="cpu")
    step = build_frame_step(cfg, params, dsp.registry)
    state = init_map_state(cfg, 0, "cpu")
    for t in range(10):
        raw = dynamic_scene(cfg, t, MaskKpts)
        res, diag = dsp.update(*raw)
        state, res_e, diag_e = step(state, _eager_frame(dsp, "update", raw, "cpu"))
        _assert_same(dsp.state, state, res, res_e, diag, diag_e, f"frame {t}")
        if t == 3:
            dsp.clear()
            state = clear_map_state(state, cfg)
        if t == 5:
            save_checkpoint(str(tmp_path / "ck"), state)
            saved_rng = state.rng.get_state()
        if t == 7:
            dsp.state = load_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")
            state = load_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")
            assert torch.equal(state.rng.get_state(), saved_rng)


def test_copy_into_moves_values_and_generator():
    cfg = tiny_test_config()
    static, other = init_map_state(cfg, 0, "cpu"), init_map_state(cfg, 7, "cpu")
    other.particles.px.fill_(1.5)
    other.rng.manual_seed(11)
    torch.rand(5, generator=other.rng)
    px = static.particles.px
    step_graph.copy_into(static, other)
    assert static.particles.px is px and bool((px == 1.5).all())
    assert torch.equal(static.rng.get_state(), other.rng.get_state())


def test_a_frame_of_another_shape_raises():
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**NOISY), device="cpu")
    raw = dynamic_scene(cfg, 0, MaskKpts)
    frame = build_frame_input(cfg, dsp.registry, *raw)
    dsp.update_from_frame(frame)
    bad = frame._replace(depth=np.zeros((cfg.height + 1, cfg.width), np.float32))
    with pytest.raises(ValueError, match="depth"):
        dsp.update_from_frame(bad)


@pytest.mark.parametrize("values, dtype", [
    (0.2, torch.float32), (1.0 / 0.15, torch.float32), (0.05, torch.float32),
    ((1.0 / 3.0, 1.0 / 3.0, 0.0), torch.float32), ((128, 64, 32), torch.int32),
    ((20.0, 6.4, 25.6), torch.float32),
])
def test_constant_has_the_bits_of_torch_tensor(values, dtype):
    got = constant(values, dtype, "cpu")
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_split_at_refit_by_preset():
    """The step is split at the refit's SVD only where the superpoint refit
    runs, and the map's stages carry the two object parts exactly there."""
    for cfg, split in ((virtual_kitti2_config(), True), (coda_config(), True),
                       (zed2_config(), False), (kitti360_config(), False)):
        assert step_graph.split_at_refit(cfg) == split, cfg
        stages = build_frame_stages(cfg, FilterParams(), LabelRegistry.default())
        assert (stages.objects_fit is not None) == split
        assert (stages.objects_finish is not None) == split


# ---------------------------------------------------------------------------
# What the card's capture refuses, found on the CPU
# ---------------------------------------------------------------------------

_A = torch.ops.aten


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_part_makes_no_host_read(case):
    """The parts of the step that the card captures run no op that
    synchronizes with the host: the whole step where it is one graph; where
    it is split at the refit, the part before the SVD and the part after
    it, while the bridge between them makes the SVD's host reads and no
    other."""
    cfg, scene, entry = CASES[case].cfg, CASES[case].scene, CASES[case].entry
    dsp = _new_map(CASES[case], "cpu")
    for t in range(2):
        _feed(dsp, entry, scene(cfg, t, MaskKpts))
    static = dsp._static
    parts = ("_fit", "_bridge", "_body") if static.split else ("_body",)
    audits = {name: HostSyncAudit() for name in parts}

    def audited(name, fn):
        def run(*args):
            with audits[name]:
                return fn(*args)
        return run

    for name in parts:
        setattr(static, name, audited(name, getattr(static, name)))
    _feed(dsp, entry, scene(cfg, 2, MaskKpts))
    assert static.split == (cfg.keypoint_mode != KEYPOINTS_BBOX3D)
    for name in parts:
        if name != "_bridge":
            assert set(audits[name].hits) == set(), (name, audits[name].hits)
    if static.split:
        ops = {op for op, _ in audits["_bridge"].hits}
        svd = {str(_A._linalg_svd.default), str(_A._linalg_check_errors.default)}
        assert str(_A._linalg_svd.default) in ops and ops <= svd, audits["_bridge"].hits


@pytest.mark.parametrize("case", ["superpoint", "zed2"])
def test_unpack_objects_is_the_object_part_of_unpack_frame(case):
    """``unpack_objects`` gives ``unpack_frame``'s camera, time and instance
    fields bit for bit and None for the image and the dense tables, and the
    object layer makes the same table from it as from the whole frame."""
    cfg, scene = CASES[case].cfg, CASES[case].scene
    params = FilterParams(**CASES[case].params)
    dsp = SemanticDSPMap(cfg, params, device="cpu")
    objects = build_frame_stages(cfg, params, dsp.registry).objects
    image = {"depth", "track_raster", "track_label_table", "inst_bbox_min", "inst_bbox_max"}
    for t in (0, 5):
        buf = torch.from_numpy(pack_frame(cfg, dsp.registry, *scene(cfg, t, MaskKpts)))
        whole, part = unpack_frame(cfg, dsp._static_table, buf), unpack_objects(cfg, buf)
        assert int(part.inst_valid.sum()) > 0
        for name in FrameInput._fields:
            if name in image:
                assert getattr(part, name) is None, name
            else:
                assert torch.equal(getattr(part, name), getattr(whole, name)), name
        a = objects(init_map_state(cfg, t, "cpu"), whole)
        b = objects(init_map_state(cfg, t, "cpu"), part)
        for field in dataclasses.fields(a):
            assert torch.equal(getattr(a, field.name), getattr(b, field.name)), field.name


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c].entry == "update"))
def test_packed_frame_is_unpacked_whole_once_a_frame(case):
    """``update()`` unpacks the whole packed frame once a frame, inside the
    step; where the step is split at the refit, the part before the SVD
    unpacks only the object layer's fields."""
    cfg, scene, entry = CASES[case].cfg, CASES[case].scene, CASES[case].entry
    dsp = _new_map(CASES[case], "cpu")
    _feed(dsp, entry, scene(cfg, 0, MaskKpts))
    static, calls = dsp._static, collections.Counter()

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    static.unpack = counted("whole", static.unpack)
    static.unpack_objects = counted("objects", static.unpack_objects)
    for t in (1, 2):
        _feed(dsp, entry, scene(cfg, t, MaskKpts))
    assert calls == {"whole": 2, **({"objects": 2} if static.split else {})}, calls


def test_map_packed_path_matches_jax():
    """``update()`` (the packed buffer, unpacked inside the static step) on
    the tiny dynamic scene against the JAX map's ``update()``: counters and
    integer state equal, floats within the existing tolerances."""
    import semantic_dsp_map_tpu as J

    from torch_parity import assert_states_match, jax_state_to_numpy

    params = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                  depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    jm = J.SemanticDSPMap(J.config.tiny_test_config(), J.FilterParams(**params))
    tm = SemanticDSPMap(tiny_test_config(), FilterParams(**params), device="cpu")
    for t in range(10):
        jr, jd = jm.update(*dynamic_scene(jm.cfg, t, J.MaskKpts))
        tr, td = tm.update(*dynamic_scene(tm.cfg, t, MaskKpts))
        assert {k: int(v) for k, v in td._asdict().items()} == {
            k: int(v) for k, v in jd._asdict().items()}, f"frame {t}"
        for name in ("occ", "label", "track"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)))
        assert_states_match(jax_state_to_numpy(jm.state), map_state_to_numpy(tm.state),
                            f"frame {t}")


# ---------------------------------------------------------------------------
# On the card: the captured graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs are captured only on the card)")
    return torch.device("cuda")


def _kernel_runs():
    return [step_graph.kernel_runs(fn) for fn in step_graph.FRAME_KERNELS]


def _graph_keys(cfg, kind):
    """The graphs of a map fed ``kind`` after its second frame."""
    if step_graph.split_at_refit(cfg):
        return {(kind, "fit"), (kind, "finish")}
    return {(kind, "step")}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_equals_eager_on_the_card(cuda, case):
    """The map on the card (eager frame 0, captured frame 1, replays after)
    bit for bit the eager step on the card, every frame; both graphs of the
    superpoint cases (and the one of the bbox3d cases) are in place from
    frame 1 on; each frame runs each of the five frame kernels once, all of
    them in the finishing graph where the step is split."""
    runs = []
    kind = "packed" if CASES[case].entry == "update" else "frame"

    def on_frame(t, dsp):
        runs.append(_kernel_runs())
        if t >= 1:
            assert set(dsp._static.graphs) == _graph_keys(dsp.cfg, kind)
            if dsp._static.split:
                assert not any(dsp._static.graphs[kind, "fit"].launches.values())

    before = _kernel_runs()
    _hold_against_eager(case, cuda, on_frame=on_frame)
    # The eager step of the test launches each kernel once a frame too; the
    # smoothed render is plain PyTorch and launches no render kernel.
    render = 0 if CASES[case].params.get("if_use_neighbor_smoothed_occupancy") else 2
    per_frame = [[(b - a) for a, b in zip(x, y)] for x, y in zip([before] + runs, runs)]
    assert all(r == [2, 2, render, 2, 2] for r in per_frame), per_frame


@pytest.mark.gpu
def test_graph_results_addresses_clear_and_restore(cuda, tmp_path):
    """On the card, after the capture: a kept result survives the next
    frame, the state keeps its addresses, and ``clear()`` and a restored
    checkpoint continue as the eager step does."""
    cfg, params = tiny_test_config(), FilterParams(**NOISY)
    dsp = SemanticDSPMap(cfg, params, device=cuda)
    step = build_frame_step(cfg, params, dsp.registry)
    state = init_map_state(cfg, 0, cuda)
    ptrs = {k: t.data_ptr() for k, t in _tensors(dsp.state).items()}
    kept = None
    for t in range(10):
        raw = dynamic_scene(cfg, t, MaskKpts)
        res, diag = dsp.update(*raw)
        state, res_e, diag_e = step(state, _eager_frame(dsp, "update", raw, cuda))
        _assert_same(dsp.state, state, res, res_e, diag, diag_e, f"frame {t}")
        if kept is not None:
            for a, b in zip(kept[0], kept[1]):
                assert torch.equal(a, b), f"a result of frame {t - 1} changed"
        kept = ([x.clone() for x in res], list(res))
        if t == 3:
            dsp.clear()
            state = clear_map_state(state, cfg)
        if t == 5:
            save_checkpoint(str(tmp_path / "ck"), state)
        if t == 7:
            dsp.state = load_checkpoint(str(tmp_path / "ck"), cfg, device=cuda)
            state = load_checkpoint(str(tmp_path / "ck"), cfg, device=cuda)
    assert {k: t.data_ptr() for k, t in _tensors(dsp.state).items()} == ptrs
    assert set(dsp._static.graphs) == _graph_keys(cfg, "packed")


@pytest.mark.gpu
def test_bridge_keeps_its_addresses(cuda):
    """The bridge's static U and Vt keep their addresses from frame to
    frame (the finishing graph reads them there), and hold the SVD of the
    fit graph's covariance of the frame."""
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**NOISY), device=cuda)
    ptrs = None
    for t in range(5):
        dsp.update(*dynamic_scene(cfg, t, MaskKpts))
        U, Vt = dsp._static.uv
        if ptrs is None:
            ptrs = (U.data_ptr(), Vt.data_ptr())
        assert (U.data_ptr(), Vt.data_ptr()) == ptrs, f"frame {t}"
        if t >= 1:
            fit = dsp._static.graphs["packed", "fit"].outputs
            U_now, Vt_now = refit_svd(fit)
            assert torch.equal(U, U_now) and torch.equal(Vt, Vt_now), f"frame {t}"


@pytest.mark.gpu
@pytest.mark.parametrize("part, stage", [("fit", "object_fit"), ("finish", "observe_and_update")])
def test_a_capture_that_fails_raises(cuda, monkeypatch, part, stage):
    """A step that reads the device inside a captured part (the graph before
    the refit's SVD, or the one after it) makes that capture fail, and the
    map raises: there is no step back to eager."""
    from semantic_dsp_map_tpu_torch import map as map_module

    inner = getattr(map_module, stage)

    def reads_the_device(cfg, *args):
        int(args[0].valid.sum() if part == "fit" else args[1].weight.sum())  # a host read
        return inner(cfg, *args)

    monkeypatch.setattr(map_module, stage, reads_the_device)
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**NOISY), device=cuda)
    dsp.update(*dynamic_scene(cfg, 0, MaskKpts))  # eager: the read is allowed
    with pytest.raises(RuntimeError, match=f"capturing the frame step \\({part}\\)"):
        dsp.update(*dynamic_scene(cfg, 1, MaskKpts))


@pytest.mark.gpu
def test_if_nodes_in_many_captures_in_a_row(cuda):
    """Forty captures, each with two conditional nodes, one after another in
    one process, as a long run makes them: PyTorch's pool hands out its 32
    streams a device in turn, and every capture's side stream must stay
    apart from the stream the graph is captured on (a side stream taken
    alone was, every 32nd time, that stream, and ending the first body's
    capture ended the graph's: the second node found no capture)."""
    x = torch.arange(5, dtype=torch.float32, device=cuda)
    pred = torch.ones((), dtype=torch.bool, device=cuda)

    def body():
        y = step_graph.slot_cond(pred, lambda: (x + 1.0,), lambda: (x,))[0]
        return step_graph.slot_cond(pred, lambda: (y * 2.0,), lambda: (y,))[0]

    body()
    torch.cuda.synchronize()
    for i in range(40):
        graph = torch.cuda.CUDAGraph()
        capture = step_graph.Capture(graph)
        assert capture.stream.cuda_stream != capture.main.cuda_stream
        with step_graph.capturing(capture):
            y = body()
        for p in (True, False):
            pred.fill_(p)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, (x + 1.0) * 2.0 if p else x), (i, p)
        pred.fill_(True)


@pytest.mark.gpu
def test_if_node_runs_only_the_taken_branch(cuda):
    """``step_graph.slot_cond`` under capture: one capture, replayed with
    ``pred`` true and false.  The outputs are ``do()``'s, then ``no()``'s;
    a tensor that only ``do()``'s body touches changes only on the replays
    that take the branch; the body allocates (a sort's scratch, the
    products) from the graph's pool."""
    x = torch.tensor([3.0, -1.0, 7.5, 0.25, 2.0], device=cuda)
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    touched = torch.zeros((), dtype=torch.int64, device=cuda)

    def do():
        touched.add_(1)  # a side effect, to see whether the body ran
        return torch.sort(x).values * 2.0 + 1.0, count + 1

    def body():
        y, c = step_graph.slot_cond(pred, do, lambda: (x, count))
        count.copy_(c)
        return y

    body()  # eager: both branches run once (the warm-up)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    capture = step_graph.Capture(graph)
    with step_graph.capturing(capture):
        y = body()
    count.zero_()
    touched.zero_()
    taken = 0
    for p in (True, False, True, False, False):
        pred.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        taken += p
        want = torch.sort(x).values * 2.0 + 1.0 if p else x
        assert torch.equal(y, want), (p, y, want)
        assert int(count) == taken and int(touched) == taken, (p, int(count), int(touched))
