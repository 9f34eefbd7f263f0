"""The port's logger (counterpart of the JAX package's ``utils/logging.py``;
reference utils/__init__.py LOGGER :411).

Messages go to standard error, at INFO unless ``QUAN_VERBOSE`` is not ``1``.
The JAX module also carries a second settings dict with a file of its own,
which nothing in the JAX package reads; the port has one settings file, and
``SETTINGS`` here is `utils.settings.SETTINGS`.
"""

from __future__ import annotations

import logging
import os

from quan_ultralytics_tpu_torch.utils.settings import SETTINGS  # noqa: F401

LOGGER = logging.getLogger("quan_tpu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO if os.environ.get("QUAN_VERBOSE", "1") == "1" else logging.WARNING)
