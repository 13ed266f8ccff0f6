"""The port's template stages against the benchmark's plain reference with
template stages (``dspbench.reference_template``), on the CPU at the small
template scene's size, at the match grid both hold fixed.

Three cases, each from the same seeded state on both sides: template birth
that matches (guessed particles born, the flag cleared), a score under the
threshold (no birth, the flag kept, the car swept again the next frame),
and a rematch whose branch is taken (the car's row of a state given a
moving, moved object without a velocity, on a frame whose four keypoints
cannot be fitted: the object layer flags it ``to_match_previous``).  Each
frame, the object table's flags, the particle store and the render equal
the reference's (every number of the benchmark's output check 0), and the
map's static step equals the eager step ``map.build_frame_step`` bit for
bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dspbench import check
from dspbench.reference_template import Reference
from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, tiny_test_config
from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
from semantic_dsp_map_tpu_torch.frontend import pack_frame
from semantic_dsp_map_tpu_torch.state import init_map_state, map_state_to_numpy
from semantic_dsp_map_tpu_torch.template_engine import TemplateEngine

from torch_parity import TEMPLATE_SCENE_CFG, template_scene

torch.set_num_threads(2)

TEMPLATES = "data/templates"
SEED = 2**31 + 26
CFG = tiny_test_config(**TEMPLATE_SCENE_CFG)
NOISY = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
             depth_noise_model_zero_order=0.2, prediction_stddev=0.01,
             if_use_template_matching=True)
#: The box template scores 0.540 on the scene's car at the default grid.
MATCHES, RETRIES = 0.2, 0.6
#: The frame whose car keeps four keypoints only, on a state that holds the
#: car as a moving, moved object without a velocity (the rematch case).
REMATCH_FRAME = 2

#: case -> (match_score_threshold, frames, expected (rematch sweeps, birth
#: sweeps) a frame)
CASES = {
    "birth_matches": (MATCHES, 2, [(0, 1), (0, 0)]),
    "birth_retries": (RETRIES, 2, [(0, 1), (0, 1)]),
    "rematch_taken": (MATCHES, 3, [(0, 1), (0, 0), (1, 0)]),
}


def _frame(case, t):
    """(depth, MaskKpts list, position, quaternion, time) of frame ``t``."""
    depth, masks, pos, quat, time = template_scene(CFG, t, MaskKpts)
    if case == "rematch_taken" and t == REMATCH_FRAME:
        car = masks[1]
        masks[1] = MaskKpts(track_id=car.track_id, label=car.label, mask=car.mask,
                            kpts_current=car.kpts_current[:4], kpts_previous=car.kpts_previous[:4])
    return depth, masks, pos, quat, time


def _as_dicts(masks):
    return [dict(track_id=m.track_id, label=m.label, mask=m.mask, kpts_current=m.kpts_current,
                 kpts_previous=m.kpts_previous) for m in masks]


def _moving_without_velocity(objects):
    """The car's row as a moving object with a moved record and no
    velocity, in place."""
    row = int(torch.nonzero(objects.valid)[0])
    objects.moving[row] = True
    objects.has_moved_record[row] = True
    objects.vel_valid[row] = False


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_template_stages_against_the_plain_reference(case):
    threshold, frames, want = CASES[case]
    params = dict(NOISY, match_score_threshold=threshold)
    dsp = SemanticDSPMap(CFG, FilterParams(**params), seed=SEED, device="cpu")
    assert dsp.set_template_path(TEMPLATES) == 1
    engine = TemplateEngine(CFG, dsp.params, dsp.registry)
    engine.set_template_path(TEMPLATES)
    eager = build_frame_step(CFG, dsp.params, dsp.registry, engine.stages("cpu"))
    eager_state = init_map_state(CFG, SEED, "cpu")
    ref = Reference(dataclasses.asdict(CFG), params, "cpu", templates=TEMPLATES)
    ref_state = ref.init_state(SEED)

    seen = []
    for t in range(frames):
        if case == "rematch_taken" and t == REMATCH_FRAME:
            for objects in (dsp.state.objects, eager_state.objects, ref_state.objects):
                _moving_without_velocity(objects)
        depth, masks, pos, quat, time = _frame(case, t)
        rematch_before = int(dsp._templates.records["rematch"].count) if t else 0
        birth_before = int(dsp._templates.records["birth"].count) if t else 0
        res, diag = dsp.update(depth, masks, pos, quat, time)
        buf = pack_frame(CFG, dsp.registry, depth, masks, pos, quat, time - dsp._time_origin)
        eager_state, res_e, diag_e = eager(
            eager_state, unpack_frame(CFG, dsp._static_table, torch.from_numpy(buf)))
        ref_state, res_r, _ = ref.frame(ref_state, depth, _as_dicts(masks), pos, quat, time)
        msg = f"{case} frame {t}"

        # The static step against the eager step, bit for bit.
        a, b = map_state_to_numpy(dsp.state), map_state_to_numpy(eager_state)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {msg}")
        assert torch.equal(dsp.state.rng.get_state(), eager_state.rng.get_state()), msg
        for name in res._fields:
            assert torch.equal(getattr(res, name), getattr(res_e, name)), f"{name} {msg}"

        # The port against the plain reference: flags, store and render.
        for flag in ("to_match_templates", "to_match_previous", "valid"):
            assert torch.equal(getattr(dsp.state.objects, flag),
                               getattr(ref_state.objects, flag)), f"{flag} {msg}"
        out = {"occ": res.occ, "label": res.label, "track": res.track,
               "weight_sum": res.weight_sum}
        numbers = check.compare(check.snapshot(dsp.state), out, ref_state, res_r)
        assert numbers == dict.fromkeys(check.NUMBERS, 0.0), (msg, numbers)
        assert torch.equal(dsp.state.rng.get_state(), ref_state.rng.get_state()), msg

        sweeps = (int(dsp._templates.records["rematch"].count) - rematch_before,
                  int(dsp._templates.records["birth"].count) - birth_before)
        counts = ref.last_counts
        assert sweeps == (counts.rematch_sweeps, counts.template_birth_sweeps), msg
        guessed = int(dsp._templates.counts()["guessed_born_count"])
        assert guessed == counts.guessed_born_count, msg
        seen.append((sweeps, guessed, bool(dsp.state.objects.to_match_templates.any())))

    assert [s for s, _, _ in seen] == want, seen
    if case == "birth_matches":
        assert seen[0][1] > 0 and not seen[-1][2]  # guessed particles; the flag cleared
    if case == "birth_retries":
        assert all(g == 0 and flagged for _, g, flagged in seen)  # none born; the flag kept
    if case == "rematch_taken":  # the taken branch matched: delete and re-insert ran
        assert float(dsp._templates.records["rematch"].score) > MATCHES
