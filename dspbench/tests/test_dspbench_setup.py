"""A configuration's ``reference`` and ``setup``: each that the harness
refuses raises before the first frame is handed in, and a configuration
without them runs with the frozen reference, called as before."""

import pytest

from dspbench import harness
from dspbench.tests.small import small_cell


@pytest.fixture
def no_frame(monkeypatch):
    """Fails a test in which the harness hands a frame to the map."""

    def hand(self, i):
        raise AssertionError(f"frame {i} was handed in")

    monkeypatch.setattr(harness.Pipe, "hand", hand)


def configured(matching: bool = False, **keys) -> harness.Cell:
    """The reduced vkitti2.drive cell, its configuration given ``keys``
    and template matching on where ``matching``."""
    cell = small_cell("vkitti2.drive")
    params = {**cell.config["filter_params"], "if_use_template_matching": matching}
    return cell._replace(config={**cell.config, "filter_params": params, **keys})


def refused(cell, match):
    with pytest.raises(ValueError, match=match):
        harness.run_cell(cell, 2**31 + 21, 0.5, False, device="cpu")


def test_an_unknown_setup_key_is_refused(no_frame):
    refused(configured(True, setup={"templates": "data/templates", "weights": "data"}),
            "unknown key")


def test_a_template_folder_that_does_not_exist_is_refused(no_frame):
    refused(configured(True, setup={"templates": "data/no_such_bank"}), "no such folder")


def test_a_template_folder_outside_the_repository_is_refused(no_frame):
    refused(configured(True, setup={"templates": "../templates"}), "relative to the repository")
    refused(configured(True, setup={"templates": str(harness.ROOT.parent / "data/templates")}),
            "relative to the repository")


def test_template_matching_without_a_bank_is_refused(no_frame):
    refused(configured(True), "empty bank")
    refused(configured(True, setup={}), "empty bank")


def test_a_bank_without_template_matching_is_refused(no_frame):
    refused(configured(False, setup={"templates": "data/templates"}), "is false")


def test_an_empty_bank_is_refused(no_frame, tmp_path, monkeypatch):
    (tmp_path / "dspbench").mkdir()
    (tmp_path / "bank" / "14").mkdir(parents=True)
    cell = configured(True, setup={"templates": "bank"})
    monkeypatch.setattr(harness, "ROOT", tmp_path / "dspbench")
    refused(cell, "no template")
    (tmp_path / "bank" / "14" / "car.txt").write_text("not a template")
    refused(cell, "no template")


@pytest.mark.parametrize("name", ["semantic_dsp_map_tpu_torch", "semantic_dsp_map_tpu_torch.map",
                                  "dspbench", ".reference", "dspbench..reference", "jax"])
def test_a_reference_outside_dspbench_is_refused(no_frame, name):
    refused(configured(reference=name), "module under")


def test_a_reference_without_the_frozen_names_is_refused(no_frame):
    refused(configured(reference="dspbench.stats"), "provides no Reference, state_from_fields")


def test_without_reference_or_setup_the_frozen_reference_is_called_as_before():
    cell = small_cell("vkitti2.drive")
    config = {k: v for k, v in cell.config.items() if k != "reference"}
    from dspbench import reference

    assert harness.reference_module(config) is reference
    assert harness.reference_module(cell.config) is reference
    assert harness.cell_setup(config) == {}
