"""The plain reference of a configuration with template matching on
(``if_use_template_matching``): the frozen reference (``dspbench.reference``,
imported and not edited) plus the two template stages, template rematch
and template birth of GUESSED_BORN particles, written plainly
(``templates``) at the reference's positions in the frame (``step``).

It imports nothing of the port, of JAX or of the JAX package.  It reads
its template bank from the ``.pcd`` files of the folder it is given
(``Reference(..., templates=<folder>)``, the configuration's ``setup``).
It runs with TF32 off; ``Reference.frame(..., lower=True)`` is the control
of the output check, as in the frozen package.

One departure from the C++, kept so that the generator's state follows
the program's: template birth draws its jitter normals from the state's
generator on every frame (``TB_MAX * 4096 * 3`` by 3 of them, whether a row
is swept or not, after regular birth's draws), where the C++ draws three
per point of a matched template only.
"""

from __future__ import annotations

from ..reference import Reference as FrozenReference
from ..reference import state_from_fields
from .step import build_frame_step
from .templates import load_bank

__all__ = ["Reference", "state_from_fields"]


class Reference(FrozenReference):
    """The step with the template stages for one configuration: ``cfg`` and
    ``params`` are the field dictionaries of ``MapConfig`` and
    ``FilterParams``, ``templates`` the template bank's folder.  ``frame``
    is the frozen package's."""

    def __init__(self, cfg: dict, params: dict, device, templates: str):
        super().__init__(cfg, params, device)
        self.bank = load_bank(templates, self.registry.label_to_id.get("Car", -1), self.device)
        self.step = build_frame_step(self.cfg, self.params, self.registry, self.bank)

    @property
    def last_counts(self):
        """The template stages' counts of the last frame
        (``step.TemplateCounts``), None before the first."""
        return self.step.counts
