"""The map's frame tracer (``timing.Tracer``): host spans, device stamps and
counters of each frame, in memory until ``collect()``.

On the CPU: a map with a tracer gives the bits of one without, every frame
has one ``dsp.update`` root and its children, the stamps, the counter ring
and the host counts of the packed buffer follow the step (in template mode
the template stages' stamps and counters too, and none of them without
it), a map without a tracer never reaches one, and the rings wrap.  The tests marked ``gpu`` run the traced step on the card
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
from semantic_dsp_map_tpu_torch.ops.templates import MatchGridConfig
from semantic_dsp_map_tpu_torch.state import map_state_to_numpy
from semantic_dsp_map_tpu_torch.timing import (COUNTERS, NESTED_STAGES, STAGES, STAMPS,
                                               TEMPLATE_COUNTERS, Trace, Tracer)

from torch_parity import (TEMPLATE_SCENE_CFG, TEMPLATE_SCENE_GRID, dynamic_scene,
                          template_scene, zed2_scene)

torch.set_num_threads(2)

NOISY = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
             depth_noise_model_zero_order=0.2, prediction_stddev=0.01)
ZED2_MOVE = dict(bayesian_movement_distance_threshold=0.2, bayesian_movement_increment=0.4,
                 bayesian_movement_decrement=0.05, bayesian_movement_probability_threshold=0.3)

#: (config, filter parameters, scene, entry point): superpoint mode splits
#: the step at the refit's SVD, bbox3d mode runs it as one graph.  Template
#: mode: the small template scene's car is matched on frame 0 and its
#: guessed particles born; no other frame sweeps.
CASES = {
    "superpoint": (tiny_test_config(), NOISY, dynamic_scene, "update"),
    "superpoint_frames": (tiny_test_config(), NOISY, dynamic_scene, "update_from_frame"),
    "bbox3d": (tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D), dict(NOISY, **ZED2_MOVE),
               zed2_scene, "update"),
    "templates": (tiny_test_config(**TEMPLATE_SCENE_CFG),
                  dict(NOISY, if_use_template_matching=True, match_score_threshold=0.2),
                  template_scene, "update"),
}
TEMPLATES = "data/templates"

#: The stamps a frame sets without template matching: nine where the step
#: is split at the refit, eight where it is one graph.  Template matching
#: adds the template stages' start and end.
TEMPLATE_STAMPS = ("rematch_start", "rematch_end", "template_birth_start", "template_birth_end")

#: The children of a frame's root, by step kind and entry point.
CHILDREN = {
    (True, "update"): ["dsp.pack", "dsp.input_copy", "dsp.replay.fit", "dsp.bridge",
                       "dsp.replay.finish"],
    (True, "update_from_frame"): ["dsp.input_copy", "dsp.replay.fit", "dsp.bridge",
                                  "dsp.replay.finish"],
    (False, "update"): ["dsp.pack", "dsp.input_copy", "dsp.replay.step"],
}


def _templating(case) -> bool:
    return CASES[case][1].get("if_use_template_matching", False)


def _map(case, device, tracer=None):
    cfg, params, _scene, _entry = CASES[case]
    dsp = SemanticDSPMap(cfg, FilterParams(**params), device=device, tracer=tracer)
    if _templating(case):
        dsp._templates.grid = MatchGridConfig(**TEMPLATE_SCENE_GRID)
        assert dsp.set_template_path(TEMPLATES) == 1
    return dsp


def _stamps_a_frame(split: bool, templating: bool) -> int:
    return (9 if split else 8) + (len(TEMPLATE_STAMPS) if templating else 0)


def _stamp_order(split: bool, templating: bool):
    """The stamps a frame sets, in the order the device reaches them."""
    order = ["fit_start", "fit_end"] + ["finish_start"] * split + ["objects", "cloud"]
    order += ["rematch_start", "rematch_end"] * templating + ["predict", "observe"]
    order += ["template_birth_start", "template_birth_end"] * templating + ["birth", "render"]
    return order


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
    the order the device reaches them; four more in template mode, the
    template stages' start and end, each inside its stage (rematch in the
    prediction, template birth in birth), and none without it.  Every
    stage's time is there and not negative, the bridge only where the step
    is split, the template stages only in template mode."""
    dsp, tracer, _ = _traced(case, 3)
    trace = tracer.collect()
    split, templating = dsp._static.split, _templating(case)
    col = {name: trace.stamps[:, i] for i, name in enumerate(STAMPS)}
    order = _stamp_order(split, templating)
    for i, row in enumerate(trace.stamps):
        set_ = row >= 0
        assert set_.sum() == _stamps_a_frame(split, templating), row
        assert set_[STAMPS.index("finish_start")] == split
        assert all(set_[STAMPS.index(n)] == templating for n in TEMPLATE_STAMPS), row
        stamped = [col[n][i] for n in order]
        assert (np.diff(stamped) >= 0).all(), row
    for stage in STAGES:
        ms = trace.stage_ms(stage)
        if (stage == "bridge" and not split) or (stage in NESTED_STAGES and not templating):
            assert np.isnan(ms).all(), (stage, ms)
        else:
            assert (ms >= 0).all() and np.isfinite(ms).all(), (stage, ms)
    # The stages but the nested two cover the frame's first stamp to its last.
    total = sum(np.nan_to_num(trace.stage_ms(s)) for s in STAGES if s not in NESTED_STAGES)
    np.testing.assert_allclose(total, (col["render"] - col["fit_start"]) / 1e6, rtol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_counter_ring_holds_each_frames_diagnostics(case):
    """The StepDiagnostics in the ring's first columns, in field order, and
    the template counters unset (NaN a frame) without template mode."""
    dsp, tracer, diags = _traced(case, 4)
    trace = tracer.collect()
    assert trace.counters.shape == (4, len(COUNTERS))
    nine = len(StepDiagnostics._fields)
    for row, diag in zip(trace.counters, diags):
        assert list(row[:nine]) == [int(v) for v in diag]
    assert list(trace.counter("visible_count")) == [int(d.visible_count) for d in diags]
    assert int(trace.counter("visible_count").sum()) > 0
    if not _templating(case):
        assert (trace.counters[:, nine:] == -1).all()
        for name in TEMPLATE_COUNTERS:
            assert np.isnan(trace.counter(name)).all(), name
        return
    # The 13-counter ring's template columns, by name: the car matches its
    # template on frame 0; no rematch sweeps, so none matches.
    assert len(COUNTERS) == 13
    for name, want in (("rematch_sweeps", [0] * 4), ("template_birth_sweeps", [1, 0, 0, 0]),
                       ("rematch_matched", [0] * 4)):
        np.testing.assert_array_equal(trace.counter(name), want, err_msg=name)
        assert list(trace.counters[:, COUNTERS.index(name)]) == list(np.cumsum(want)), name
    assert trace.counter("guessed_born_count")[0] > 0
    assert list(trace.counter("guessed_born_count")[1:]) == [0] * 3


def test_the_counter_ring_is_sized_by_its_counters(monkeypatch):
    """The counter ring holds a column a counter, the stamp ring a column a
    stamp, and neither width is read from the other: both are 13 wide, and
    one counter more widens the counter ring alone."""
    tracer = Tracer(5)
    _map("superpoint", "cpu", tracer)
    assert COUNTERS[:len(StepDiagnostics._fields)] == StepDiagnostics._fields
    assert COUNTERS[len(StepDiagnostics._fields):] == TEMPLATE_COUNTERS
    assert len(COUNTERS) == len(STAMPS) == 13
    assert tracer._stamps.shape == (5, len(STAMPS))
    assert tracer._counters.shape == (5, len(COUNTERS))
    monkeypatch.setattr(timing, "COUNTERS", COUNTERS + ("one_more",))
    wider = Tracer(5)
    wider.bind("cpu")
    assert wider._stamps.shape == (5, len(STAMPS))
    assert wider._counters.shape == (5, len(COUNTERS) + 1)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no counter"):
        tracer.stamp("render", counts={"nope": torch.zeros((), dtype=torch.int64)})
    with pytest.raises(ValueError, match="not a run"):
        tracer.stamp("render", counts={"born_count": torch.zeros((), dtype=torch.int64),
                                       "visible_count": torch.zeros((), dtype=torch.int64)})
    with pytest.raises(ValueError, match="no counter"):
        tracer.collect().counter("nope")


def test_the_template_stages_stamp_and_count_a_frame():
    """Template mode: the frame tracer's template counters read each frame's
    share of the sweep records and the guessed particles born, and the
    template stages' times are their own stamps' spans: frame 0 matches the
    car (one birth sweep, guessed particles born, the car's flag cleared),
    later frames sweep nothing and birth none."""
    frames = 4
    tracer = Tracer()
    dsp = _map("templates", "cpu", tracer)
    sweeps, born = [], []
    for t in range(frames):
        before = int(dsp._templates.records["birth"].count) if t else 0
        _feed(dsp, "templates", t)
        sweeps.append(int(dsp._templates.records["birth"].count) - before)
        born.append(int(dsp._templates.counts()["guessed_born_count"]))
    trace = tracer.collect()
    assert sweeps == [1, 0, 0, 0], sweeps
    assert born[0] > 0 and born[1:] == [0] * (frames - 1), born
    np.testing.assert_array_equal(trace.counter("template_birth_sweeps"), sweeps)
    np.testing.assert_array_equal(trace.counter("guessed_born_count"), born)
    np.testing.assert_array_equal(trace.counter("rematch_sweeps"), [0] * frames)
    col = {name: trace.stamps[:, i] for i, name in enumerate(STAMPS)}
    for stage in NESTED_STAGES:
        np.testing.assert_array_equal(
            trace.stage_ms(stage), (col[f"{stage}_end"] - col[f"{stage}_start"]) / 1e6)
    assert not bool(dsp.state.objects.to_match_templates.any())


def test_the_running_totals_read_a_frames_share():
    """A running total of sweeps reads a frame's share: against 0 on the
    map's first frame, NaN on the first frame held after frames were lost,
    from 0 again where the total starts anew; NaN where a frame set none."""
    stamps = np.full((4, len(STAMPS)), -1, np.int64)
    counters = np.full((4, len(COUNTERS)), -1, np.int64)
    counters[:, COUNTERS.index("template_birth_sweeps")] = [1, 3, 1, -1]
    counters[:, COUNTERS.index("guessed_born_count")] = [5, 0, 2, -1]
    counters[:, COUNTERS.index("rematch_matched")] = [2, 2, 3, -1]
    for lost, first in ((0, 1.0), (6, np.nan)):
        trace = Trace(np.arange(lost, lost + 4), [], stamps, counters, lost)
        np.testing.assert_array_equal(trace.counter("template_birth_sweeps"),
                                      [first, 2, 1, np.nan])
        np.testing.assert_array_equal(trace.counter("guessed_born_count"), [5, 0, 2, np.nan])
        np.testing.assert_array_equal(trace.counter("rematch_matched"),
                                      [2 * first, 0, 1, np.nan])


def test_the_rematch_matched_metric_reads_the_counter_or_none(monkeypatch):
    """The benchmark's ``rematch_matched_per_frame`` reads the mean of the
    frames' shares of ``rematch_matched`` over the window's frames outside
    the profiled slice; None without the program's records, on frames that
    set no template counter, or where the program has no such counter."""
    from dspbench import harness

    read = harness.reader("rematch_matched_per_frame")
    run = harness.Run()
    assert read(run) is None
    counters = np.full((4, len(COUNTERS)), -1, np.int64)
    counters[:, COUNTERS.index("rematch_matched")] = [0, 1, 1, 3]
    run.program = Trace(np.arange(4), [], np.full((4, len(STAMPS)), -1, np.int64), counters, 0)
    run.frames = [harness.Frame(i, 0.0, 0.0, 0.0, False) for i in range(4)]
    assert read(run) == pytest.approx(0.75)  # shares 0, 1, 0, 2
    run.traced = range(3, 4)
    assert read(run) == pytest.approx(1 / 3)
    monkeypatch.setattr(timing, "COUNTERS", tuple(c for c in COUNTERS if c != "rematch_matched"))
    assert read(run) is None
    monkeypatch.undo()
    counters[:, COUNTERS.index("rematch_matched")] = -1  # no template matching
    assert read(run) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_map_packs_each_frame_into_the_buffer_it_holds(case):
    """Through ``update()`` the first frame makes the packed buffer and each
    later one is packed into it: the map counts N - 1 packs in place and 1
    allocation, and its tracer reads the same a frame; ``update_from_frame``
    packs nothing."""
    n = 4
    dsp, tracer, _ = _traced(case, n)
    trace = tracer.collect()
    packed = CASES[case][3] == "update"
    assert (dsp.packs_in_place, dsp.pack_allocations) == ((n - 1, 1) if packed else (0, 0))
    assert list(trace.host_count("pack_allocated")) == [int(packed)] + [0] * (n - 1)
    assert list(trace.host_count("pack_in_place")) == [0] + [int(packed)] * (n - 1)
    with pytest.raises(ValueError, match="no frame is under way"):
        tracer.count("pack_in_place")


def test_the_stages_from_the_stamps():
    """``Trace.stage_ms`` on stamps written by hand: a split frame and a
    frame of one graph (``finish_start`` unset), in rings of the first nine
    columns (no template stages) and of every column (template stages on
    the second frame): the nested stages read their own start to end and
    leave the others as they were."""
    ms = 1_000_000
    split = [0, 2, 5, 6, 10, 13, 20, 22, 25]
    step = [0, 0, -1, 3, 4, 6, 9, 10, 12]
    want = {"objects": [2 + 1, 3], "bridge": [3, np.nan], "cloud": [4, 1], "predict": [3, 2],
            "observe": [7, 3], "birth": [2, 1], "render": [3, 2]}
    nine = np.array([split, step], np.int64) * ms
    full = np.full((2, len(STAMPS)), -1, np.int64)
    full[:, :9] = nine
    full[1, 9:] = np.array([4, 5, 9, 9], np.int64) * ms  # inside predict and birth
    for stamps, nested in ((nine, [[np.nan] * 2] * 2), (full, [[np.nan, 1], [np.nan, 0]])):
        trace = Trace(np.array([7, 8]), [], stamps, np.zeros((2, 9), np.int64), 7)
        for stage, values in {**want, **dict(zip(NESTED_STAGES, nested))}.items():
            np.testing.assert_array_equal(trace.stage_ms(stage), values, err_msg=stage)
    with pytest.raises(ValueError, match="no stage"):
        trace.stage_ms("nope")


def test_the_rings_wrap_and_collect_says_what_was_lost():
    dsp, tracer, diags = _traced("superpoint", 5, capacity=3)
    trace = tracer.collect()
    assert list(trace.frames) == [2, 3, 4] and trace.lost == 2
    assert sorted({s.frame for s in trace.spans}) == [2, 3, 4]
    assert list(trace.host_count("pack_in_place")) == [1, 1, 1]
    for i, (row, diag) in enumerate(zip(trace.counters, diags[2:])):
        assert list(row[:len(diag)]) == [int(v) for v in diag], i
    starts = trace.stamps[:, 0]
    assert (np.diff(starts) > 0).all()  # oldest first
    for s in trace.spans:  # each parent index points into the collected spans
        assert s.parent == -1 or (trace.spans[s.parent].name == "dsp.update"
                                  and trace.spans[s.parent].frame == s.frame)


def test_a_map_without_a_tracer_never_reaches_one(monkeypatch):
    """With ``tracer=None`` no Tracer method runs: each would raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a map without a tracer reached one")

    for name in ("span", "stamp", "count", "bind", "collect"):
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
        timing.stamp_cuda(torch.zeros(2, dtype=torch.int64),
                          torch.zeros(4, len(STAMPS), dtype=torch.int64),
                          torch.zeros(4, len(COUNTERS), dtype=torch.int64), 0, True)
    with pytest.raises(ValueError, match="0-d int64"):
        tracer.stamp("render", counts=dict.fromkeys(StepDiagnostics._fields,
                                                    torch.zeros((), dtype=torch.int32)))


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
@pytest.mark.parametrize("case", ["superpoint", "bbox3d", "templates"])
def test_the_traced_step_on_the_card(cuda, case):
    """Two maps, the tracer on and off, fed the same frames with two frames
    in flight (frame t + 1 handed in before frame t's outputs are read)
    over the eager, capturing and replayed frames: outputs and state bit
    for bit, the same synchronizing calls a frame (the tracer adds none:
    ``collect()`` is its only read); the stamps of each frame in the order
    the device reaches them (the template stages' inside their stages), the
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

    split, templating = on._static.split, _templating(case)
    stamps_in = {part: g.launches.get("stamp_cuda", 0) for (_k, part), g in
                 on._static.graphs.items()}
    extra = len(TEMPLATE_STAMPS) if templating else 0
    assert stamps_in == ({"fit": 2, "finish": 7 + extra} if split else {"step": 8 + extra}), (
        stamps_in)
    trace = tracer.collect()
    assert list(trace.frames) == list(range(frames)) and trace.lost == 0
    order = [STAMPS.index(n) for n in _stamp_order(split, templating)]
    for t, row in enumerate(trace.stamps):
        stamped = row[row >= 0]
        assert len(stamped) == _stamps_a_frame(split, templating), (t, row)
        assert (np.diff(row[order]) >= 0).all() and row[order[-1]] > row[order[0]], (t, row)
        diag = kept_on[t][1]
        assert list(trace.counters[t][:len(diag)]) == [int(d) for d in diag], t
    for stage in STAGES:
        ms = trace.stage_ms(stage)
        unset = (stage == "bridge" and not split) or (stage in NESTED_STAGES and not templating)
        assert np.isnan(ms).all() if unset else (ms >= 0).all(), (stage, ms)
    if templating:  # the car matched on frame 0, the sweep inside the graph-free eager frame
        np.testing.assert_array_equal(trace.counter("template_birth_sweeps"),
                                      [1] + [0] * (frames - 1))
        assert trace.counter("guessed_born_count")[0] > 0
    assert sorted({s.frame for s in trace.spans}) == list(range(frames))
