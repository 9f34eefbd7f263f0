"""A reader for model YAML files (``yolo11-quan.yaml`` and the like), without a
YAML library: the machine that runs the port has none.

It reads the part of YAML that model files use and gives what
``yaml.safe_load`` gives for them (a test holds it to that on every model file
of the JAX package): top-level ``key: value`` lines whose value is a scalar or
a flow sequence (``kpt_shape: [17, 3]``); a top-level key with an indented
block under it, either a mapping of scalars or flow sequences (``scales:``
with ``n: [0.50, 0.25, 1024]``) or a sequence of them (``backbone:`` with
``- [[-1, 6], 1, Concat, [1]]``); flow sequences nested to any depth; plain
and quoted scalars (``True``, ``0.50``, ``nearest``, ``nc``); ``#`` comments
and blank lines. Anything else (flow mappings, deeper blocks, anchors,
multi-line scalars) raises `ValueError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

from quan_ultralytics_tpu_torch.cfg.datasets import _key_value, _scalar, _strip_comment


def _flow(text: str, where: str) -> Any:
    """A scalar, or a flow sequence ``[a, [b, c], d]`` nested to any depth."""
    text = text.strip()
    if not text.startswith("["):
        if text.startswith("{"):
            raise ValueError(f"{where}: flow mappings are not supported")
        return _scalar(text, where)
    value, end = _sequence(text, 0, where)
    if text[end:].strip():
        raise ValueError(f"{where}: {text[end:].strip()!r} after the closing ']'")
    return value


def _sequence(text: str, i: int, where: str) -> Tuple[List[Any], int]:
    """The flow sequence that opens at ``text[i] == '['``, and the index after its ']'."""
    items: List[Any] = []
    i += 1
    token = ""
    after_item = False  # a nested sequence just closed: the next character is ',' or ']'
    quote = None
    while i < len(text):
        ch = text[i]
        if quote:
            token += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            token += ch
        elif ch == "[":
            if token.strip() or after_item:
                raise ValueError(f"{where}: '[' inside a scalar")
            value, i = _sequence(text, i, where)
            items.append(value)
            after_item = True
            continue
        elif ch in ",]":
            if after_item:
                if token.strip():
                    raise ValueError(f"{where}: {token.strip()!r} after a nested sequence")
            elif token.strip():
                items.append(_scalar(token, where))
            elif ch == ",":  # (a ']' right after a ',' is YAML's trailing comma)
                raise ValueError(f"{where}: an empty item in a flow sequence")
            token, after_item = "", False
            if ch == "]":
                return items, i + 1
        elif ch == "{":
            raise ValueError(f"{where}: flow mappings are not supported")
        else:
            token += ch
        i += 1
    raise ValueError(f"{where}: a flow sequence without its closing ']'")


def parse_model_yaml(text: str, source: str = "<model config>") -> Dict[str, Any]:
    """A model config's text -> dict, for the subset of YAML described above."""
    cfg: Dict[str, Any] = {}
    block: Union[None, Dict[Any, Any], List[Any]] = None  # the open block under a top-level key
    block_key = None
    lines = text.splitlines()
    for n, raw in enumerate(lines, 1):
        where = f"{source}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        indent = line[:len(line) - len(line.lstrip())]
        if "\t" in indent:
            raise ValueError(f"{where}: tabs in indentation")
        item = line.lstrip()
        if item.startswith("- ") or item == "-":
            if block_key is None:
                raise ValueError(f"{where}: a sequence item outside a block")
            if block is None:
                block = cfg[block_key] = []
            if not isinstance(block, list):
                raise ValueError(f"{where}: a sequence item inside a mapping")
            block.append(_flow(item[1:], where))
            continue
        if indent:
            if block_key is None:
                raise ValueError(f"{where}: an indented line outside a block")
            if block is None:
                block = cfg[block_key] = {}
            if not isinstance(block, dict):
                raise ValueError(f"{where}: a mapping entry inside a sequence")
            key, value = _key_value(item, where)
            if not value.strip():
                raise ValueError(f"{where}: nested blocks deeper than one level are not supported")
            block[key] = _flow(value, where)
            continue
        key, value = _key_value(line, where)
        if key in cfg:
            raise ValueError(f"{where}: duplicate key {key!r}")
        block, block_key = None, None
        if value.strip():
            cfg[key] = _flow(value, where)
        else:
            cfg[key] = None  # `key:` with nothing under it is null, as in YAML
            block_key = key
    return cfg


def load_model_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    """Read a model config file (see `parse_model_yaml`)."""
    return parse_model_yaml(Path(path).read_text(), str(path))
