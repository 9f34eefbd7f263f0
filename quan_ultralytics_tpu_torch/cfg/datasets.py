"""Dataset configurations as Python literals, and a reader for the small part
of YAML that data configs use.

``DATASETS`` holds the JAX package's ``cfg/datasets/*.yaml`` as the dicts
``yaml.safe_load`` gives (a test holds each equal to its file): the machine
that runs the port has no YAML parser. `load_data_cfg` reads a data config
file without one. It takes flat ``key: value`` lines, ``#`` comments, and
``names`` as a map (``  0: plane``) or a list (``- plane``), which covers
those files and what ``yaml.dump`` writes for a data dict; anything else
raises `ValueError`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union


# the JAX package"s cfg/datasets/DOTAv1.yaml
DOTA_V1 = {
    "path": "../datasets/DOTAv1",
    "train": "images/train",
    "val": "images/val",
    "test": "images/test",
    "names": {
        0: "plane",
        1: "ship",
        2: "storage-tank",
        3: "baseball-diamond",
        4: "tennis-court",
        5: "basketball-court",
        6: "ground-track-field",
        7: "harbor",
        8: "bridge",
        9: "large-vehicle",
        10: "small-vehicle",
        11: "helicopter",
        12: "roundabout",
        13: "soccer-ball-field",
        14: "swimming-pool",
    },
}

# the JAX package"s cfg/datasets/coco.yaml
COCO = {
    "path": "../datasets/coco",
    "train": "images/train2017",
    "val": "images/val2017",
    "names": {
        0: "person",
        1: "bicycle",
        2: "car",
        3: "motorcycle",
        4: "airplane",
        5: "bus",
        6: "train",
        7: "truck",
        8: "boat",
        9: "traffic light",
        10: "fire hydrant",
        11: "stop sign",
        12: "parking meter",
        13: "bench",
        14: "bird",
        15: "cat",
        16: "dog",
        17: "horse",
        18: "sheep",
        19: "cow",
        20: "elephant",
        21: "bear",
        22: "zebra",
        23: "giraffe",
        24: "backpack",
        25: "umbrella",
        26: "handbag",
        27: "tie",
        28: "suitcase",
        29: "frisbee",
        30: "skis",
        31: "snowboard",
        32: "sports ball",
        33: "kite",
        34: "baseball bat",
        35: "baseball glove",
        36: "skateboard",
        37: "surfboard",
        38: "tennis racket",
        39: "bottle",
        40: "wine glass",
        41: "cup",
        42: "fork",
        43: "knife",
        44: "spoon",
        45: "bowl",
        46: "banana",
        47: "apple",
        48: "sandwich",
        49: "orange",
        50: "broccoli",
        51: "carrot",
        52: "hot dog",
        53: "pizza",
        54: "donut",
        55: "cake",
        56: "chair",
        57: "couch",
        58: "potted plant",
        59: "bed",
        60: "dining table",
        61: "toilet",
        62: "tv",
        63: "laptop",
        64: "mouse",
        65: "remote",
        66: "keyboard",
        67: "cell phone",
        68: "microwave",
        69: "oven",
        70: "toaster",
        71: "sink",
        72: "refrigerator",
        73: "book",
        74: "clock",
        75: "vase",
        76: "scissors",
        77: "teddy bear",
        78: "hair drier",
        79: "toothbrush",
    },
}

# the JAX package"s cfg/datasets/coco8.yaml
COCO8 = {
    "path": "../datasets/coco8",
    "train": "images/train",
    "val": "images/val",
    "names": {
        0: "person",
        1: "bicycle",
        2: "car",
        3: "motorcycle",
        4: "airplane",
        5: "bus",
        6: "train",
        7: "truck",
        8: "boat",
        9: "traffic light",
        10: "fire hydrant",
        11: "stop sign",
        12: "parking meter",
        13: "bench",
        14: "bird",
        15: "cat",
        16: "dog",
        17: "horse",
        18: "sheep",
        19: "cow",
        20: "elephant",
        21: "bear",
        22: "zebra",
        23: "giraffe",
        24: "backpack",
        25: "umbrella",
        26: "handbag",
        27: "tie",
        28: "suitcase",
        29: "frisbee",
        30: "skis",
        31: "snowboard",
        32: "sports ball",
        33: "kite",
        34: "baseball bat",
        35: "baseball glove",
        36: "skateboard",
        37: "surfboard",
        38: "tennis racket",
        39: "bottle",
        40: "wine glass",
        41: "cup",
        42: "fork",
        43: "knife",
        44: "spoon",
        45: "bowl",
        46: "banana",
        47: "apple",
        48: "sandwich",
        49: "orange",
        50: "broccoli",
        51: "carrot",
        52: "hot dog",
        53: "pizza",
        54: "donut",
        55: "cake",
        56: "chair",
        57: "couch",
        58: "potted plant",
        59: "bed",
        60: "dining table",
        61: "toilet",
        62: "tv",
        63: "laptop",
        64: "mouse",
        65: "remote",
        66: "keyboard",
        67: "cell phone",
        68: "microwave",
        69: "oven",
        70: "toaster",
        71: "sink",
        72: "refrigerator",
        73: "book",
        74: "clock",
        75: "vase",
        76: "scissors",
        77: "teddy bear",
        78: "hair drier",
        79: "toothbrush",
    },
}

# the JAX package"s cfg/datasets/dota8.yaml
DOTA8 = {
    "path": "../datasets/dota8",
    "train": "images/train",
    "val": "images/train",
    "names": {
        0: "plane",
        1: "ship",
        2: "storage-tank",
        3: "baseball-diamond",
        4: "tennis-court",
        5: "basketball-court",
        6: "ground-track-field",
        7: "harbor",
        8: "bridge",
        9: "large-vehicle",
        10: "small-vehicle",
        11: "helicopter",
        12: "roundabout",
        13: "soccer-ball-field",
        14: "swimming-pool",
    },
}

DATASETS = {"DOTAv1.yaml": DOTA_V1, "coco.yaml": COCO, "coco8.yaml": COCO8, "dota8.yaml": DOTA8}

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")
_BOOL = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}
_SPECIAL = set("[]{}&*!|>%@`")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one outside quotes, at the start or after a space)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str) -> Any:
    """A plain, single- or double-quoted scalar as ``yaml.safe_load`` reads it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        body = s[1:-1]
        if "\\" in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not supported")
        return body
    if not s or s in ("~", "null", "Null", "NULL"):
        return None
    if s[0] in _SPECIAL or s[0] in "'\"" or s.startswith(("- ", "? ")) or ": " in s:
        raise ValueError(f"{where}: {s!r} is not a plain scalar")
    if s.lower() in _BOOL and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and any(c.isdigit() for c in s):
        return float(s.replace("_", ""))
    return s


def _key_value(line: str, where: str) -> Tuple[Any, str]:
    key, sep, value = line.partition(":")
    if not sep or (value and value[0] not in " \t"):
        raise ValueError(f"{where}: expected 'key: value', got {line.strip()!r}")
    return _scalar(key, where), value


def parse_data_yaml(text: str, source: str = "<data config>") -> Dict[str, Any]:
    """A data config's text -> dict, for the subset of YAML described above."""
    cfg: Dict[str, Any] = {}
    block: Union[None, Dict[Any, Any], List[Any]] = None  # the open ``names`` block
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tabs in indentation")
        indented = line[0] == " "
        item = line.lstrip()
        if item.startswith("- ") or item == "-":
            if block is None or isinstance(block, dict):
                raise ValueError(f"{where}: a list item outside a 'names:' list")
            block.append(_scalar(item[1:], where))
            continue
        if indented:
            if block is None or isinstance(block, list):
                raise ValueError(f"{where}: nested mappings other than 'names' are not supported")
            key, value = _key_value(item, where)
            block[key] = _scalar(value, where)
            continue
        key, value = _key_value(line, where)
        if key in cfg:
            raise ValueError(f"{where}: duplicate key {key!r}")
        block = None
        if value.strip():
            cfg[key] = _scalar(value, where)
        elif key == "names":
            nxt = next((ln.strip() for ln in text.splitlines()[n:] if _strip_comment(ln).strip()), "")
            block = cfg[key] = [] if nxt.startswith("-") else {}
        else:
            cfg[key] = None
    return cfg


def load_data_cfg(path: Union[str, Path]) -> Dict[str, Any]:
    """Read a data config file (see `parse_data_yaml`)."""
    return parse_data_yaml(Path(path).read_text(), str(path))
