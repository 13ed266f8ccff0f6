"""The port's stage profiler: every cumulative prefix runs at the tiny
config, and the prefix that stops after the last stage is the frame step
itself (same state and result; integers equal, floats at rtol 2e-5 / atol
1e-6).  The JAX package's prefixes set the stage list."""

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.profiling import STAGES as J_STAGES

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import profiling
from semantic_dsp_map_tpu_torch.frontend import build_frame_input
from semantic_dsp_map_tpu_torch.map import STAGES, build_frame_step
from semantic_dsp_map_tpu_torch.state import init_map_state, map_state_to_numpy

from torch_parity import dynamic_scene

torch.set_num_threads(2)

PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
              depth_noise_model_zero_order=0.2, prediction_stddev=0.0)


def _frames(cfg, n):
    reg = T.LabelRegistry.default()
    out = []
    for t in range(n):
        d, m, p, q, tt = dynamic_scene(cfg, t, T.MaskKpts)
        f = build_frame_input(cfg, reg, d, m, p, q, tt)
        out.append(T.FrameInput(*(torch.as_tensor(np.asarray(a)) for a in f)))
    return reg, out


def _run(cfg, reg, frames, stop_after):
    step = build_frame_step(cfg, T.FilterParams(**PARAMS), reg, stop_after=stop_after)
    state = init_map_state(cfg, seed=0, device="cpu")
    out = None
    for f in frames:
        state, result, diag = out = step(state, f)
    return out


def _assert_close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def test_stage_list_is_the_jax_package_s():
    assert list(STAGES) == list(J_STAGES) == list(profiling.STAGES)


def test_last_prefix_is_the_frame_step():
    cfg = T.tiny_test_config()
    reg, frames = _frames(cfg, 5)
    state, result, diag = _run(cfg, reg, frames, None)
    p_state, p_result, p_diag = _run(cfg, reg, frames, len(STAGES) - 1)
    want, got = map_state_to_numpy(state), map_state_to_numpy(p_state)
    assert want.keys() == got.keys()
    for k in want:
        _assert_close(got[k], want[k], k)
    for name in result._fields if hasattr(result, "_fields") else ("occ", "label", "track", "weight_sum"):
        _assert_close(getattr(p_result, name), getattr(result, name), name)
    assert {k: int(v) for k, v in p_diag._asdict().items()} == {
        k: int(v) for k, v in diag._asdict().items()}
    assert int((result.occ == 1).sum()) > 0 and int(diag.moved_count) >= 0


@pytest.mark.parametrize("k", range(len(STAGES)))
def test_prefix_runs_and_stops_where_it_says(k):
    """Prefix k leaves untouched what later stages write: the particle store
    before the prediction stage, the voxel stamps before observe, the frame
    time before birth; only the whole step returns a result."""
    cfg = T.tiny_test_config()
    reg, frames = _frames(cfg, 3)
    state, result, diag = _run(cfg, reg, frames, k)
    last = len(STAGES) - 1
    assert (result is None) == (k < last) and (diag is None) == (k < last)
    assert int(state.global_time) == (3 if k >= 2 else 0)
    assert bool((state.particles.status != 0).any()) == (k >= 4)
    assert bool((state.voxel_stamp != 0).any()) == (k >= 3)
    assert (float(state.prev_frame_time) > 0) == (k >= 4)
    assert bool(state.objects.valid.any())  # the object layer is stage 0


def test_stop_after_out_of_range_raises():
    with pytest.raises(ValueError, match="stop_after"):
        build_frame_step(T.tiny_test_config(), T.FilterParams(), T.LabelRegistry.default(),
                         stop_after=len(STAGES))


def test_profiling_main_on_the_cpu(capsys):
    rows = profiling.main(["--config", "tiny", "--iters", "2", "--device", "cpu"])
    assert [r["stage"] for r in rows] == list(STAGES) + ["ingest", "stage_bookkeeping"]
    for r in rows[:-2]:
        assert r["device_ms"] > 0 and r["wall_ms"] >= r["enqueue_ms"] > 0
    assert rows[-2]["pack_ms"] > 0 and rows[-2]["copy_ms"] > 0 and rows[-2]["bytes"] > 0
    assert 0 < rows[-1]["host_us"] < 1000
    out = capsys.readouterr().out
    assert all(f"prefix<={s}" in out for s in STAGES) and "pack_frame" in out
    assert "stage boundaries" in out
    rows = profiling.main(["--config", "tiny", "--iters", "1", "--device", "cpu", "--stages", "0,5"])
    assert [r["stage"] for r in rows] == ["objects", "render", "ingest", "stage_bookkeeping"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            profiling.main(["--config", "tiny", "--iters", "1"])


def test_clone_state_is_independent():
    """A prefix timed on a copy leaves the map untouched: tensors and the
    generator are copied, and the copy continues the same draws."""
    cfg = T.tiny_test_config()
    reg, frames = _frames(cfg, 3)
    step = build_frame_step(cfg, T.FilterParams(nb_ptc_num_per_point=3), reg)
    state = init_map_state(cfg, seed=3, device="cpu")
    state, _, _ = step(state, frames[0])
    before = map_state_to_numpy(state)
    rng_before = state.rng.get_state().clone()
    copy = profiling.clone_state(state)
    copy, _, _ = step(copy, frames[1])
    after = map_state_to_numpy(state)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert torch.equal(state.rng.get_state(), rng_before)
    assert not torch.equal(copy.rng.get_state(), rng_before)  # jittered births drew
    # stepping the original now gives what the copy gave
    state, _, _ = step(state, frames[1])
    a, b = map_state_to_numpy(state), map_state_to_numpy(copy)
    assert all(np.array_equal(a[k], b[k]) for k in a)
