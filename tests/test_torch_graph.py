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
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, tiny_test_config
from semantic_dsp_map_tpu_torch import step_graph
from semantic_dsp_map_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from semantic_dsp_map_tpu_torch.config import (
    KEYPOINTS_BBOX3D, MOVEMENT_ALWAYS, MOVEMENT_NEVER, coda_config, kitti360_config,
    virtual_kitti2_config, zed2_config,
)
from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input, pack_frame
from semantic_dsp_map_tpu_torch.map import (
    build_frame_stages, build_frame_step, unpack_frame, unpack_objects,
)
from semantic_dsp_map_tpu_torch.state import (
    clear_map_state, constant, init_map_state, map_state_to_numpy,
)

from torch_parity import dynamic_scene, zed2_scene

torch.set_num_threads(2)

#: Rigid-move jitter on, so that the step draws from the generator in every
#: stage that can (RANSAC triples, depth noise, move jitter).
NOISY = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
             depth_noise_model_zero_order=0.2, prediction_stddev=0.01)
ZED2_MOVE = dict(bayesian_movement_distance_threshold=0.2, bayesian_movement_increment=0.4,
                 bayesian_movement_decrement=0.05, bayesian_movement_probability_threshold=0.3)

#: name -> (config, parameters, scene, entry point of the map)
CASES = {
    "superpoint": (tiny_test_config(), NOISY, dynamic_scene, "update"),
    "superpoint_frames": (tiny_test_config(), NOISY, dynamic_scene, "update_from_frame"),
    "zed2": (tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D), dict(NOISY, **ZED2_MOVE),
             zed2_scene, "update"),
    "zed2_independent": (tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D),
                         dict(NOISY, **ZED2_MOVE, if_use_independent_filter=True), zed2_scene,
                         "update"),
    "smoothed_render": (tiny_test_config(), dict(NOISY, if_use_neighbor_smoothed_occupancy=True),
                        dynamic_scene, "update"),
    "movement_never": (tiny_test_config(movement_mode=MOVEMENT_NEVER), NOISY, dynamic_scene,
                       "update"),
    "movement_always": (tiny_test_config(movement_mode=MOVEMENT_ALWAYS), NOISY, dynamic_scene,
                        "update_from_frame"),
}


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


def _hold_against_eager(case, device, frames=10, on_frame=None):
    """The map's static step against ``build_frame_step`` on a state of its
    own, bit for bit every frame; returns the map."""
    cfg, params, scene, entry = CASES[case]
    params = FilterParams(**params)
    dsp = SemanticDSPMap(cfg, params, device=device)
    step = build_frame_step(cfg, params, dsp.registry)
    state = init_map_state(cfg, 0, device)
    moved = 0
    for t in range(frames):
        raw = scene(cfg, t, MaskKpts)
        res, diag = _feed(dsp, entry, raw)
        state, res_e, diag_e = step(state, _eager_frame(dsp, entry, raw, device))
        _assert_same(dsp.state, state, res, res_e, diag, diag_e, f"{case} frame {t}")
        moved += int(diag.moved_count)
        if on_frame is not None:
            on_frame(t, dsp)
    if cfg.movement_mode != MOVEMENT_NEVER:
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


def test_objects_outside_graph_by_preset():
    """The object layer runs ahead of the graph only where the superpoint
    refit (and its SVD) runs."""
    assert step_graph.objects_outside_graph(virtual_kitti2_config())
    assert step_graph.objects_outside_graph(coda_config())
    assert not step_graph.objects_outside_graph(zed2_config())
    assert not step_graph.objects_outside_graph(kitti360_config())


# ---------------------------------------------------------------------------
# What the card's capture refuses, found on the CPU
# ---------------------------------------------------------------------------

_A = torch.ops.aten
#: Ops that, on a CUDA tensor, read the device to the host, size an output by
#: the data, or copy from host memory (``torch.tensor`` of Python values is
#: ``lift_fresh``): each synchronizes, and a capture refuses it.
_HOST_SYNC = {
    _A.lift_fresh.default, _A._local_scalar_dense.default, _A.nonzero.default,
    _A.masked_select.default, _A.bincount.default, _A.repeat_interleave.Tensor,
    _A.is_nonzero.default, _A.equal.default, _A._unique2.default,
    _A.unique_consecutive.default, _A.unique_dim.default, _A._linalg_svd.default,
    _A._linalg_check_errors.default,
}
_INDEXING = {_A.index.Tensor, _A.index_put_.default, _A.index_put.default,
             _A._index_put_impl_.default}


class HostSyncAudit(TorchDispatchMode):
    """Counts, by op and the port's source line, the ops of ``_HOST_SYNC``
    and indexing by a boolean mask (a ``nonzero`` on the card)."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        hit = func in _HOST_SYNC or (func in _INDEXING and any(
            i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1]))
        if hit:
            frames = [f for f in traceback.extract_stack()
                      if "semantic_dsp_map_tpu_torch" in f.filename]
            where = f"{frames[-1].filename.rsplit('/', 1)[-1]}:{frames[-1].lineno}"
            self.hits[(str(func), where)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_part_makes_no_host_read(case):
    """The part of the step that the card captures (the object layer too,
    where it is captured) runs no op that synchronizes with the host; the
    superpoint object layer, which runs ahead of the graph, does (its SVD)."""
    cfg, params, scene, entry = CASES[case]
    dsp = SemanticDSPMap(cfg, FilterParams(**params), device="cpu")
    for t in range(2):
        _feed(dsp, entry, scene(cfg, t, MaskKpts))
    static = dsp._static
    body, objects = static._body, static.stages.objects
    audits = {"body": HostSyncAudit(), "objects": HostSyncAudit()}

    def audited(name, fn):
        def run(*args):
            with audits[name]:
                return fn(*args)
        return run

    static._body = audited("body", body)
    static.stages = static.stages._replace(objects=audited("objects", objects))
    _feed(dsp, entry, scene(cfg, 2, MaskKpts))
    if static.objects_eager:
        assert set(audits["body"].hits) == set(), audits["body"].hits
        assert any("svd" in op for op, _ in audits["objects"].hits), audits["objects"].hits
    else:
        assert set(audits["body"].hits) == set(), audits["body"].hits


@pytest.mark.parametrize("case", ["superpoint", "zed2"])
def test_unpack_objects_is_the_object_part_of_unpack_frame(case):
    """``unpack_objects`` gives ``unpack_frame``'s camera, time and instance
    fields bit for bit and None for the image and the dense tables, and the
    object layer makes the same table from it as from the whole frame."""
    cfg, params, scene, _ = CASES[case]
    params = FilterParams(**params)
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


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][3] == "update"))
def test_packed_frame_is_unpacked_whole_once_a_frame(case):
    """``update()`` unpacks the whole packed frame once a frame, inside the
    step; where the object layer runs ahead of it, that layer unpacks only
    its own fields."""
    cfg, params, scene, entry = CASES[case]
    dsp = SemanticDSPMap(cfg, FilterParams(**params), device="cpu")
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
    assert calls == {"whole": 2, **({"objects": 2} if static.objects_eager else {})}, calls


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_equals_eager_on_the_card(cuda, case):
    """The map on the card (eager frame 0, captured frame 1, replays after)
    bit for bit the eager step on the card, every frame; each frame runs
    each of the five frame kernels once."""
    runs = []

    def on_frame(t, dsp):
        runs.append(_kernel_runs())
        if t >= 1:
            assert set(dsp._static.graphs) == {
                "packed" if CASES[case][3] == "update" else "frame"}

    before = _kernel_runs()
    _hold_against_eager(case, cuda, on_frame=on_frame)
    # The eager step of the test launches each kernel once a frame too; the
    # smoothed render is plain PyTorch and launches no render kernel.
    render = 0 if CASES[case][1].get("if_use_neighbor_smoothed_occupancy") else 2
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
    assert set(dsp._static.graphs) == {"packed"}


@pytest.mark.gpu
def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A step that reads the device inside the captured part makes the
    capture fail, and the map raises: there is no step back to eager."""
    from semantic_dsp_map_tpu_torch import map as map_module

    observe = map_module.observe_and_update

    def reads_the_device(cfg, params, particles, *args):
        int(particles.weight.sum())  # a host read
        return observe(cfg, params, particles, *args)

    monkeypatch.setattr(map_module, "observe_and_update", reads_the_device)
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**NOISY), device=cuda)
    dsp.update(*dynamic_scene(cfg, 0, MaskKpts))  # eager: the read is allowed
    with pytest.raises(RuntimeError, match="capturing the frame step"):
        dsp.update(*dynamic_scene(cfg, 1, MaskKpts))
