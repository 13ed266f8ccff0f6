"""The map's frame tracer (``timing.Tracer``): host spans, device stamps and
counters of each frame, in memory until ``collect()``.

On the CPU: a map with a tracer gives the bits of one without, every frame
has one ``dsp.update`` root and its children, the stamps and the counter
ring follow the step, a map without a tracer never reaches one, and the
rings wrap.  The tests marked ``gpu`` run the traced step on the card
(eager, capturing and replayed frames) and skip here; they import no JAX,
so on the card they run with

    python3 -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_trace.py
"""

import warnings

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, tiny_test_config
from semantic_dsp_map_tpu_torch import step_graph, timing
from semantic_dsp_map_tpu_torch.config import KEYPOINTS_BBOX3D
from semantic_dsp_map_tpu_torch.frontend import build_frame_input
from semantic_dsp_map_tpu_torch.map import StepDiagnostics
from semantic_dsp_map_tpu_torch.state import map_state_to_numpy
from semantic_dsp_map_tpu_torch.timing import STAGES, STAMPS, Trace, Tracer

from torch_parity import dynamic_scene, zed2_scene

torch.set_num_threads(2)

NOISY = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
             depth_noise_model_zero_order=0.2, prediction_stddev=0.01)
ZED2_MOVE = dict(bayesian_movement_distance_threshold=0.2, bayesian_movement_increment=0.4,
                 bayesian_movement_decrement=0.05, bayesian_movement_probability_threshold=0.3)

#: (config, filter parameters, scene, entry point): superpoint mode splits
#: the step at the refit's SVD, bbox3d mode runs it as one graph.
CASES = {
    "superpoint": (tiny_test_config(), NOISY, dynamic_scene, "update"),
    "superpoint_frames": (tiny_test_config(), NOISY, dynamic_scene, "update_from_frame"),
    "bbox3d": (tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D), dict(NOISY, **ZED2_MOVE),
               zed2_scene, "update"),
}

#: The children of a frame's root, by step kind and entry point.
CHILDREN = {
    (True, "update"): ["dsp.pack", "dsp.input_copy", "dsp.replay.fit", "dsp.bridge",
                       "dsp.replay.finish"],
    (True, "update_from_frame"): ["dsp.input_copy", "dsp.replay.fit", "dsp.bridge",
                                  "dsp.replay.finish"],
    (False, "update"): ["dsp.pack", "dsp.input_copy", "dsp.replay.step"],
}


def _map(case, device, tracer=None):
    cfg, params, _scene, _entry = CASES[case]
    return SemanticDSPMap(cfg, FilterParams(**params), device=device, tracer=tracer)


def _feed(dsp, case, t):
    cfg, _params, scene, entry = CASES[case]
    raw = scene(cfg, t, MaskKpts)
    if entry == "update":
        return dsp.update(*raw)
    return dsp.update_from_frame(build_frame_input(cfg, dsp.registry, *raw))


def _assert_same(a, b, res_a, res_b, diag_a, diag_b, msg):
    sa, sb = map_state_to_numpy(a.state), map_state_to_numpy(b.state)
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=f"{key} {msg}")
    assert torch.equal(a.state.rng.get_state(), b.state.rng.get_state()), msg
    for name in res_a._fields:
        assert torch.equal(getattr(res_a, name), getattr(res_b, name)), f"{name} {msg}"
    for name in diag_a._fields:
        assert torch.equal(getattr(diag_a, name), getattr(diag_b, name)), f"{name} {msg}"


def _traced(case, frames, capacity=4096):
    """A traced map of ``case`` after ``frames`` frames, its tracer and each
    frame's diagnostics."""
    tracer = Tracer(capacity)
    dsp = _map(case, "cpu", tracer)
    diags = [_feed(dsp, case, t)[1] for t in range(frames)]
    return dsp, tracer, diags


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_traced_map_gives_the_bits_of_an_untraced_one(case):
    """State, generator, RenderResult and every counter equal, frame for
    frame, with the tracer on and off."""
    on, off = _map(case, "cpu", Tracer()), _map(case, "cpu")
    for t in range(4):
        res_on, diag_on = _feed(on, case, t)
        res_off, diag_off = _feed(off, case, t)
        _assert_same(on, off, res_on, res_off, diag_on, diag_off, f"{case} frame {t}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_frame_has_one_root_and_its_children(case):
    """One ``dsp.update`` root a frame, numbered from the map's first
    ``update()``, with the input copy, the parts and (split) the bridge as
    its children in order, each inside it."""
    dsp, tracer, _ = _traced(case, 3)
    trace = tracer.collect()
    assert list(trace.frames) == [0, 1, 2] and trace.lost == 0
    cfg, _params, _scene, entry = CASES[case]
    want = CHILDREN[step_graph.split_at_refit(cfg), entry]
    for frame in range(3):
        spans = [(i, s) for i, s in enumerate(trace.spans) if s.frame == frame]
        roots = [(i, s) for i, s in spans if s.parent == -1]
        assert [s.name for _, s in roots] == ["dsp.update"], spans
        (root_index, root), = roots
        children = [s for _, s in spans if s.parent == root_index]
        assert [s.name for s in children] == want
        assert len(spans) == 1 + len(want)
        for s in children:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s
        assert trace.span_ms("dsp.update")[frame] == pytest.approx(root.ms)
    replays = trace.span_ms("dsp.replay")
    parts = [s.ms for s in trace.spans if s.name.startswith("dsp.replay.") and s.frame == 1]
    assert replays[1] == pytest.approx(sum(parts))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stamps_a_frame_in_order(case):
    """Nine stamps a frame where the step is split at the refit, eight
    where it is one graph (its finishing graph's start is its fit end), in
    the order of ``STAMPS``; every stage's time is there and not negative,
    the bridge only where the step is split."""
    dsp, tracer, _ = _traced(case, 3)
    trace = tracer.collect()
    split = dsp._static.split
    for row in trace.stamps:
        set_ = row >= 0
        assert set_.sum() == (9 if split else 8), row
        assert set_[STAMPS.index("finish_start")] == split
        stamped = row[set_]
        assert (np.diff(stamped) >= 0).all(), row
    for stage in STAGES:
        ms = trace.stage_ms(stage)
        if stage == "bridge" and not split:
            assert np.isnan(ms).all()
        else:
            assert (ms >= 0).all() and np.isfinite(ms).all(), (stage, ms)
    # The stages cover the frame's first stamp to its last.
    total = sum(np.nan_to_num(trace.stage_ms(s)) for s in STAGES)
    np.testing.assert_allclose(total, (trace.stamps[:, -1] - trace.stamps[:, 0]) / 1e6,
                               rtol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_counter_ring_holds_each_frames_diagnostics(case):
    dsp, tracer, diags = _traced(case, 4)
    trace = tracer.collect()
    assert trace.counters.shape == (4, len(StepDiagnostics._fields))
    for row, diag in zip(trace.counters, diags):
        assert list(row) == [int(v) for v in diag]
    assert list(trace.counter("visible_count")) == [int(d.visible_count) for d in diags]
    assert int(trace.counter("visible_count").sum()) > 0


def test_the_stages_from_the_stamps():
    """``Trace.stage_ms`` on stamps written by hand: a split frame and a
    frame of one graph (``finish_start`` unset)."""
    ms = 1_000_000
    split = [0, 2, 5, 6, 10, 13, 20, 22, 25]
    step = [0, 0, -1, 3, 4, 6, 9, 10, 12]
    trace = Trace(np.array([7, 8]), [], np.array([split, step], np.int64) * ms,
                  np.zeros((2, 9), np.int64), 7)
    want = {"objects": [2 + 1, 3], "bridge": [3, np.nan], "cloud": [4, 1], "predict": [3, 2],
            "observe": [7, 3], "birth": [2, 1], "render": [3, 2]}
    for stage, values in want.items():
        np.testing.assert_array_equal(trace.stage_ms(stage), values, err_msg=stage)
    with pytest.raises(ValueError, match="no stage"):
        trace.stage_ms("nope")


def test_the_rings_wrap_and_collect_says_what_was_lost():
    dsp, tracer, diags = _traced("superpoint", 5, capacity=3)
    trace = tracer.collect()
    assert list(trace.frames) == [2, 3, 4] and trace.lost == 2
    assert sorted({s.frame for s in trace.spans}) == [2, 3, 4]
    for i, (row, diag) in enumerate(zip(trace.counters, diags[2:])):
        assert list(row) == [int(v) for v in diag], i
    starts = trace.stamps[:, 0]
    assert (np.diff(starts) > 0).all()  # oldest first
    for s in trace.spans:  # each parent index points into the collected spans
        assert s.parent == -1 or (trace.spans[s.parent].name == "dsp.update"
                                  and trace.spans[s.parent].frame == s.frame)


def test_a_map_without_a_tracer_never_reaches_one(monkeypatch):
    """With ``tracer=None`` no Tracer method runs: each would raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a map without a tracer reached one")

    for name in ("span", "stamp", "bind", "collect"):
        monkeypatch.setattr(Tracer, name, refuse)
    monkeypatch.setattr(timing._Span, "__enter__", refuse)
    monkeypatch.setattr(timing, "stamp_cuda", refuse)
    for case in ("superpoint", "bbox3d", "superpoint_frames"):
        dsp = _map(case, "cpu")
        for t in range(2):
            _feed(dsp, case, t)


def test_the_spans_are_profiler_ranges():
    """Each span is also a ``torch.profiler`` range of its name."""
    from torch.profiler import ProfilerActivity, profile

    dsp = _map("superpoint", "cpu", Tracer())
    _feed(dsp, "superpoint", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _feed(dsp, "superpoint", 1)
    names = {e.key for e in prof.key_averages()}
    assert set(CHILDREN[True, "update"]) | {"dsp.update"} <= names


def test_a_tracer_records_one_map_and_refuses_what_it_cannot_take():
    tracer = Tracer(4)
    _map("superpoint", "cpu", tracer)
    with pytest.raises(ValueError, match="one map"):
        _map("superpoint", "cpu", tracer)
    with pytest.raises(ValueError, match="capacity"):
        Tracer(0)
    with pytest.raises(ValueError, match="card tensors"):
        timing.stamp_cuda(torch.zeros(2, dtype=torch.int64), torch.zeros(4, 9, dtype=torch.int64),
                          torch.zeros(4, 9, dtype=torch.int64), 0, True)
    with pytest.raises(ValueError, match="0-d int64"):
        tracer.stamp("render", counts=[torch.zeros((), dtype=torch.int32)] * 9)


# ---------------------------------------------------------------------------
# On the card: the traced graphs
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamps are captured only on the card)")
    return torch.device("cuda")


def _syncs(fn):
    """``fn()``'s result and the synchronizing CUDA calls it made (the sync
    debug mode's warnings)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in seen)


def _stamp_tally():
    return (timing.stamp_cuda.launches, step_graph.captured["stamp_cuda"],
            step_graph.replayed["stamp_cuda"])


@pytest.mark.gpu
def test_graphs_captured_without_a_tracer_hold_no_stamp(cuda):
    """No stamp launches, is captured or replays over an untraced map's
    eager, capturing and replayed frames, on both kinds of step."""
    before = _stamp_tally()
    for case in ("superpoint", "bbox3d"):
        dsp = _map(case, cuda)
        for t in range(4):
            _feed(dsp, case, t)
        assert all(g.launches.get("stamp_cuda", 0) == 0 for g in dsp._static.graphs.values())
    torch.cuda.synchronize()
    assert _stamp_tally() == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["superpoint", "bbox3d"])
def test_the_traced_step_on_the_card(cuda, case):
    """Two maps, the tracer on and off, fed the same frames with two frames
    in flight (frame t + 1 handed in before frame t's outputs are read)
    over the eager, capturing and replayed frames: outputs and state bit
    for bit, the same synchronizing calls a frame (the tracer adds none:
    ``collect()`` is its only read); the stamps of each frame in order, the
    graphs holding them, and the counter ring equal to the cloned
    diagnostics."""
    frames = 8
    tracer = Tracer()
    on, off = _map(case, cuda, tracer), _map(case, cuda)
    kept_on, kept_off, syncs = [], [], []
    for t in range(frames):
        (res_on, diag_on), n_on = _syncs(lambda: _feed(on, case, t))
        (res_off, diag_off), n_off = _syncs(lambda: _feed(off, case, t))
        syncs.append((n_on, n_off))
        kept_on.append((res_on, [d.clone() for d in diag_on]))
        kept_off.append((res_off, [d.clone() for d in diag_off]))
        if t >= 1:  # frame t - 1, read after frame t was handed in
            for a, b in zip(kept_on[t - 1][0] + tuple(kept_on[t - 1][1]),
                            kept_off[t - 1][0] + tuple(kept_off[t - 1][1])):
                assert torch.equal(a, b), f"frame {t - 1}"
    assert all(a == b for a, b in syncs) and syncs[-1][1] > 0, syncs  # the mode sees the step's
    sa, sb = map_state_to_numpy(on.state), map_state_to_numpy(off.state)
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)

    split = on._static.split
    stamps_in = {part: g.launches.get("stamp_cuda", 0) for (_k, part), g in
                 on._static.graphs.items()}
    assert stamps_in == ({"fit": 2, "finish": 7} if split else {"step": 8}), stamps_in
    trace = tracer.collect()
    assert list(trace.frames) == list(range(frames)) and trace.lost == 0
    for t, row in enumerate(trace.stamps):
        stamped = row[row >= 0]
        assert len(stamped) == (9 if split else 8), (t, row)
        assert (np.diff(stamped) >= 0).all() and stamped[-1] > stamped[0], (t, row)
        assert list(trace.counters[t]) == [int(d) for d in kept_on[t][1]], t
    for stage in STAGES:
        ms = trace.stage_ms(stage)
        assert np.isnan(ms).all() if stage == "bridge" and not split else (ms >= 0).all()
    assert sorted({s.frame for s in trace.spans}) == list(range(frames))
