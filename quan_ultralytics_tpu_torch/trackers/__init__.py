"""Multi-object trackers on the host (counterpart of the JAX package's ``trackers/``)."""

from quan_ultralytics_tpu_torch.trackers.bot_sort import BOTSORT
from quan_ultralytics_tpu_torch.trackers.byte_tracker import BYTETracker

__all__ = ["BYTETracker", "BOTSORT"]
