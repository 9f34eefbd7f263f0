"""Layered config: default.yaml + overrides with type and range checks
(counterpart of the JAX package's ``cfg/__init__.py``; reference
ultralytics/cfg/__init__.py get_cfg).

``default.yaml`` and ``recipes/*.yaml`` are the port's own copies of the JAX
package's files, byte for byte (a test holds them equal). They are read with
`cfg.datasets.parse_data_yaml`, the port's reader of flat YAML, which gives
what ``yaml.safe_load`` gives for them: the machine that runs the port has no
YAML parser. The CLI lives in `quan_ultralytics_tpu_torch.cli`.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional, Union

from quan_ultralytics_tpu_torch.cfg.datasets import load_data_cfg

CFG_PATH = Path(__file__).resolve().parent / "default.yaml"

# keys validated as fractions in [0, 1]
CFG_FRACTION_KEYS = {
    "lrf", "momentum", "weight_decay", "warmup_momentum", "hsv_h", "hsv_s",
    "hsv_v", "translate", "scale", "flipud", "fliplr", "mosaic", "mixup",
    "copy_paste", "conf", "iou", "fraction", "dropout",
}
CFG_INT_KEYS = {"epochs", "patience", "batch", "imgsz", "workers", "seed",
                "close_mosaic", "max_det", "nbs", "save_period", "vid_stride",
                "mask_ratio", "line_width"}
CFG_BOOL_KEYS = {"save", "exist_ok", "pretrained", "deterministic", "resume",
                 "amp", "profile", "multi_scale", "val", "save_json", "half",
                 "plots", "augment", "agnostic_nms", "dynamic", "nms",
                 "verbose", "single_cls", "rect", "cos_lr", "overlap_mask",
                 "save_hybrid", "show", "save_frames", "save_txt", "save_conf",
                 "save_crop", "show_labels", "show_conf", "show_boxes", "dnn"}
# enum-valued keys (reference get_cfg does str checks; rejected early here)
CFG_ENUM_KEYS = {
    "copy_paste_mode": {"flip", "mixup"},
    "auto_augment": {"randaugment", "autoaugment", "augmix"},
}
# facade/CLI keys that are valid overrides but not in default.yaml
EXTRA_OVERRIDE_KEYS = {"save_dir", "max_labels", "nc", "mapping_type",
                       "path", "persist", "iterations", "save_submission"}


def load_default() -> Dict[str, Any]:
    return load_data_cfg(CFG_PATH)


def get_cfg(overrides: Optional[Dict[str, Any]] = None,
            cfg: Union[str, Path, Dict, None] = None) -> SimpleNamespace:
    """Merge default.yaml (or a user cfg yaml) with overrides, type-checked."""
    base = load_default()
    if isinstance(cfg, (str, Path)):
        base.update(load_data_cfg(cfg))
    elif isinstance(cfg, dict):
        base.update(cfg)
    for k, v in (overrides or {}).items():
        if k not in base:
            raise KeyError(f"invalid config key {k!r}; valid keys are in {CFG_PATH}")
        base[k] = v
    for k, v in base.items():
        base[k] = _coerce(k, v)
    return SimpleNamespace(**base)


def _coerce(k: str, v: Any) -> Any:
    """Type/range-check one key (reference cfg/__init__.py get_cfg checks)."""
    if v is None:
        return v
    if k in CFG_INT_KEYS and not isinstance(v, bool):
        return int(v)
    if k in CFG_BOOL_KEYS:
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes")
        return bool(v)
    if k in CFG_FRACTION_KEYS and isinstance(v, (int, float)):
        if not 0.0 <= float(v) <= 1.0:
            raise ValueError(f"config key {k}={v} must be in [0, 1]")
        return float(v)
    if k in CFG_ENUM_KEYS and v is not False:
        if str(v) not in CFG_ENUM_KEYS[k]:
            raise ValueError(f"config key {k}={v!r} must be one of {sorted(CFG_ENUM_KEYS[k])}")
    if k == "cache":
        if v not in (False, True, "ram", "disk"):
            raise ValueError(f"config key cache={v!r} must be false|true|ram|disk")
        return {False: None, True: "ram"}.get(v, v)  # reference: True == RAM cache
    return v


def validate_overrides(overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Validate a sparse override dict against the full reference key surface
    (default.yaml's keys and the facade's extras) without materializing
    defaults. Unknown keys are rejected with the valid-key location; known
    keys are type/range-coerced in place."""
    valid = set(load_default()) | EXTRA_OVERRIDE_KEYS
    for k in overrides:
        if k not in valid:
            raise KeyError(f"invalid config key {k!r}; valid keys are in {CFG_PATH}")
        overrides[k] = _coerce(k, overrides[k])
    return overrides
