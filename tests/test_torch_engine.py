"""End-to-end behaviour of the port's map engine on the CPU: the mirrors of
tests/test_smoke.py, tests/test_diagnostics.py and tests/test_metamorphic.py
(the same scenes and assertions, driven through the port's
``SemanticDSPMap.update``)."""

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, tiny_test_config
from semantic_dsp_map_tpu_torch.ops import codecs

torch.set_num_threads(2)

QUAT = np.array([1.0, 0, 0, 0], np.float32)  # identity: camera looks +z


def _wall(cfg, z):
    return np.full((cfg.height, cfg.width), z, np.float32)


def _static_mask(cfg, label_value=6):
    """One static MaskKpts whose pixels hold label_id - 1."""
    return MaskKpts(track_id=65535, label="static",
                    mask=np.full((cfg.height, cfg.width), label_value - 1, np.uint8))


def _voxel_positions(dsp):
    v = torch.arange(dsp.cfg.num_voxels, dtype=torch.int32)
    return codecs.voxel_to_global_pos(dsp.cfg, dsp.state.scroll, v).numpy()


def test_smoke_static_wall():
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu")
    pos = np.zeros(3, np.float32)
    for t in range(5):
        result, _ = dsp.update(_wall(cfg, 1.5), [_static_mask(cfg)], pos, QUAT, t * 0.1)
    occ = result.occ.numpy()
    assert (occ == 1).sum() > 0, "wall voxels should become occupied"
    occ_z = _voxel_positions(dsp)[occ == 1][:, 2]
    assert np.all(occ_z > 1.0) and np.all(occ_z < 2.0)
    assert (result.label.numpy()[occ == 1] == 6).mean() > 0.9


def test_smoke_freespace_unknown_and_clear():
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu")
    pos = np.zeros(3, np.float32)
    for t in range(3):
        result, _ = dsp.update(_wall(cfg, 1.5), [_static_mask(cfg)], pos, QUAT, t * 0.1)
    occ = result.occ.numpy()
    behind = _voxel_positions(dsp)[:, 2] < -0.5
    assert (occ[behind] == -1).all(), "voxels behind the camera stay unknown"
    assert (occ == 0).sum() > 0, "free voxels in front of the wall"

    dsp.clear()
    assert int(dsp.state.global_time) == 0 and int(dsp.state.voxel_stamp.sum()) == 0
    result, diag = dsp.update(_wall(cfg, 1.5), [_static_mask(cfg)], pos, QUAT, 0.5)
    assert int(diag.visible_count) == 0 and int(diag.born_count) > 0


def _run_slanted_wall(cfg, n_frames=3):
    """Slanted wall (depth 1.0..2.0 across rows); returns the last frame's
    diagnostics and the per-counter peak over the frames."""
    dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu")
    H, W = cfg.height, cfg.width
    depth = (1.0 + np.arange(H, dtype=np.float32)[:, None] / H) * np.ones((1, W), np.float32)
    mask = MaskKpts(track_id=65535, label="static", mask=np.full((H, W), 5, np.uint8))
    peak = None
    for t in range(n_frames):
        _, diag = dsp.update(depth, [mask], np.zeros(3, np.float32), QUAT, t * 0.1)
        d = {k: int(v) for k, v in diag._asdict().items()}
        peak = d if peak is None else {k: max(peak[k], d[k]) for k in d}
    return d, peak


def test_no_overflow_at_default_capacity():
    last, _ = _run_slanted_wall(tiny_test_config())
    for name in ("block_overflow", "entry_overflow", "corner_overflow", "birth_overflow"):
        assert last[name] == 0, name
    assert last["visible_count"] > 0


@pytest.mark.parametrize(
    "override,counter,frames",
    [
        (dict(max_active_blocks=1), "block_overflow", 3),
        (dict(max_table_entries=64), "entry_overflow", 3),
        (dict(phd_pixel_table_slots=1), "table_dropped", 4),
        (dict(corner_gather_blocks=1), "corner_overflow", 3),
        (dict(max_birth_blocks=1), "birth_overflow", 3),
        (dict(max_moving_blocks=1), "move_overflow", 6),
    ],
)
def test_overflow_counter_fires(override, counter, frames):
    """Every capacity cap fires its counter when exceeded (the corner pass
    drains its backlog over frames, so the peak is checked).  The slanted
    wall has no mover: the move cap is driven by the dynamic scene, whose car
    spreads over several blocks, and its counter is held to the JAX map's."""
    if counter == "move_overflow":
        peak = _run_dynamic_scene_with_the_jax_map(override, frames)
    else:
        _, peak = _run_slanted_wall(tiny_test_config(**override), frames)
    assert peak[counter] > 0


def _run_dynamic_scene_with_the_jax_map(override, n_frames):
    """The dynamic scene through the port and the JAX map with the same cap:
    all counters equal on every frame; returns their peak."""
    import semantic_dsp_map_tpu as J

    from torch_parity import dynamic_scene

    params = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                  depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    tm = SemanticDSPMap(tiny_test_config(**override), FilterParams(**params), device="cpu")
    jm = J.SemanticDSPMap(J.config.tiny_test_config(**override), J.FilterParams(**params))
    peak = None
    for t in range(n_frames):
        _, td = tm.update(*dynamic_scene(tm.cfg, t, MaskKpts))
        _, jd = jm.update(*dynamic_scene(jm.cfg, t, J.MaskKpts))
        d = {k: int(v) for k, v in td._asdict().items()}
        assert d == {k: int(v) for k, v in jd._asdict().items()}, f"frame {t}"
        peak = d if peak is None else {k: max(peak[k], d[k]) for k in d}
    assert peak["moved_count"] > 0  # the cap binds on a move that still happens
    return peak


def test_static_scene_occupancy_fixed_point():
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu")
    renders = []
    for t in range(18):
        result, _ = dsp.update(_wall(cfg, 1.37), [_static_mask(cfg)], np.zeros(3, np.float32),
                               QUAT, t * 0.1)
        if t >= 6:
            renders.append((result.occ.numpy().copy(), result.label.numpy().copy()))
    occ0, lab0 = renders[0]
    assert (occ0 == 1).sum() > 0
    for i, (occ, lab) in enumerate(renders[1:], start=1):
        np.testing.assert_array_equal(occ, occ0, err_msg=f"occupancy changed at frame {i}")
        np.testing.assert_array_equal(lab[occ == 1], lab0[occ0 == 1])


def test_ego_translation_index_shift_equivalence():
    """The scene translated by an exact voxel multiple renders the same
    content at shifted global keys: the scroll re-labels indices only."""
    cfg = tiny_test_config()
    shift_vox = 2
    delta = np.array([shift_vox * cfg.voxel_size, 0.0, 0.0], np.float32)
    runs = []
    for cam in (np.zeros(3, np.float32), delta):
        dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu")
        for t in range(6):
            result, _ = dsp.update(_wall(cfg, 1.37), [_static_mask(cfg)], cam, QUAT, t * 0.1)
        keys = np.round(_voxel_positions(dsp) / cfg.voxel_size).astype(np.int64)
        runs.append({tuple(k): v for k, v in zip(keys, result.occ.numpy())})
    key_a, key_b = runs
    mismatches = [k for k, v in key_b.items() if key_a[(k[0] - shift_vox, k[1], k[2])] != v]
    assert len(key_b) == cfg.num_voxels
    assert not mismatches, mismatches[:5]
    assert {0, 1, -1} <= set(key_a.values())


def test_log_diagnostics_prints_each_frame(capsys):
    """log_diagnostics=True prints one ``[dsp] t=<frame> {counters}`` line
    per frame, the JAX engine's format; off by default."""
    cfg = tiny_test_config()
    quiet = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu")
    loud = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1), device="cpu",
                          log_diagnostics=True)
    pos = np.zeros(3, np.float32)
    for t in range(2):
        quiet.update(_wall(cfg, 1.5), [_static_mask(cfg)], pos, QUAT, t * 0.1)
    assert capsys.readouterr().out == ""
    diags = [loud.update(_wall(cfg, 1.5), [_static_mask(cfg)], pos, QUAT, t * 0.1)[1] for t in range(2)]
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"[dsp] t={t + 1} {({k: int(v) for k, v in d._asdict().items()})}"
                     for t, d in enumerate(diags)]
    assert int(diags[0].born_count) > 0


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """``device=None`` means the card everywhere: without a CUDA device the
    map, the state builders and the checkpoint loader raise and name
    ``device="cpu"``; with one they resolve to ``cuda``.  No step down."""
    from semantic_dsp_map_tpu_torch import state as tstate
    from semantic_dsp_map_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    cfg = tiny_test_config()
    save_checkpoint(str(tmp_path / "ck"), tstate.init_map_state(cfg, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: SemanticDSPMap(cfg),
        lambda: tstate.init_map_state(cfg),
        lambda: tstate.make_generator(0),
        lambda: tstate.map_state_from_numpy({}),
        lambda: load_checkpoint(str(tmp_path / "ck"), cfg),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert tstate.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tstate.resolve_device(None) == torch.device("cuda")
