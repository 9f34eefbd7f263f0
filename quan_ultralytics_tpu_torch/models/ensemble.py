"""Model ensembling (counterpart of the JAX ``models/ensemble.py``; reference
nn/tasks.py:697-710 Ensemble).

Several models of one task and class count run on the same input, and their
decoded predictions are concatenated along the anchor axis, to go through
non-maximum suppression as one model's would. The members hold their own
weights (the JAX class takes a variable tree for each).
"""

from __future__ import annotations

from typing import Sequence

import torch

from quan_ultralytics_tpu_torch.models.tasks import DetectionModel


class Ensemble:
    """Members must share ``task`` and ``nc``; otherwise, or with no member,
    `ValueError` (the JAX class asserts)."""

    def __init__(self, models: Sequence[DetectionModel]):
        if not models:
            raise ValueError("an ensemble needs at least one model")
        tasks, ncs = {m.task for m in models}, {m.nc for m in models}
        if len(tasks) != 1 or len(ncs) != 1:
            raise ValueError(f"ensemble members must share task and nc, got tasks {sorted(tasks)}, "
                             f"nc {sorted(ncs)}")
        self.models = list(models)
        self.task, self.nc = models[0].task, models[0].nc

    @torch.no_grad()
    def decode(self, img: torch.Tensor) -> torch.Tensor:
        """``[B, n_models * A, ...]``: each member's forward on ``img`` (as it
        stands, eval or train), decoded, concatenated along the anchors."""
        return torch.cat([m.decode(m(img)) for m in self.models], dim=1)
