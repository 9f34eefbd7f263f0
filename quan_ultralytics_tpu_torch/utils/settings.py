"""Persistent user settings (counterpart of the JAX package's
``utils/settings.py``; reference utils/__init__.py SettingsManager :842-1324).

A JSON-backed dict at ``$QUAN_TORCH_SETTINGS`` (default
``~/.config/quan_ultralytics_tpu_torch/settings.json``: the port's own file,
beside and apart from the JAX package's) holding the
per-integration enable flags. `utils/integrations.py` gates each logger on
``SETTINGS[name] is True`` as the reference does (e.g. mlflow.py:30). Unknown
keys are rejected; a file of another version or key set is not loaded, and
the next explicit save replaces it (the reference's ``correct_keys`` reset).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict

_VERSION = "1.0"

_DEFAULTS: Dict[str, Any] = {
    "settings_version": _VERSION,
    # integration toggles (reference SETTINGS defaults :897-915)
    "tensorboard": True,
    "wandb": True,
    "mlflow": True,
    "comet": True,
    "clearml": True,
    "dvc": True,
    "neptune": True,
    "raytune": True,
}


def _path() -> Path:
    env = os.environ.get("QUAN_TORCH_SETTINGS")
    if env:
        return Path(env)
    return Path.home() / ".config" / "quan_ultralytics_tpu_torch" / "settings.json"


class SettingsManager(dict):
    """Dict with JSON persistence and typed, known-key updates."""

    def __init__(self):
        super().__init__(_DEFAULTS)
        self.file = _path()
        # read only: the file changes only on an explicit update() or reset()
        try:
            loaded = json.loads(self.file.read_text())
        except (OSError, ValueError):
            return
        if (isinstance(loaded, dict) and set(loaded) == set(_DEFAULTS)
                and loaded.get("settings_version") == _VERSION):
            dict.update(self, loaded)

    def save(self) -> None:
        self.file.parent.mkdir(parents=True, exist_ok=True)
        # atomic replace: a concurrent reader never sees a half-written file
        tmp = self.file.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(dict(self), indent=2))
        os.replace(tmp, self.file)

    def update(self, *args, **kwargs) -> None:  # type: ignore[override]
        new = dict(*args, **kwargs)
        for k, v in new.items():
            if k not in _DEFAULTS:
                raise KeyError(f"unknown setting {k!r} (valid: {sorted(_DEFAULTS)})")
            want = type(_DEFAULTS[k])
            if not isinstance(v, want):
                raise TypeError(f"setting {k!r} must be {want.__name__}, got {type(v).__name__}")
        super().update(new)
        if new:
            self.save()

    def reset(self) -> None:
        self.clear()
        super().update(_DEFAULTS)
        self.save()


SETTINGS = SettingsManager()
