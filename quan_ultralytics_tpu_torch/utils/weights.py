"""Carry the JAX package's variables into a port module.

The JAX package keeps a flax tree ``{"params": ..., "batch_stats": ...}``; the
port's state names follow its paths, with ``model_N`` read as ``model.N``:
``params/model_10/m0/attn/qkv/w`` becomes ``model.10.m0.attn.qkv.w``. Leaf
by leaf:

============================  ==============================  ========================================
flax leaf                     port state                      layout transform
============================  ==============================  ========================================
``.../w``  (QConv2D)          ``.../w``                       ``[4, kH, kW, Cin/g, Cout]`` -> ``[4, Cout, Cin/g, kH, kW]``
``.../b``  (QConv2D)          ``.../b``                       none (``[Cout]``)
``.../gamma``, ``beta``       same name (IQBN parameters)     none (``[4, C]``)
``batch_stats/.../mean, var`` same name (IQBN buffers)        none (``[4, C]``)
``.../proj/kernel`` (QER)     ``.../proj.weight``             HWIO -> OIHW; input channels stay q-major
``.../proj/bias``   (QER)     ``.../proj.bias``               none
============================  ==============================  ========================================
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _port_leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax leaf -> (port state name, array in the port's layout)."""
    parts = [re.sub(r"^model_(\d+)$", r"model.\1", p) for p in path]
    leaf = parts[-1]
    if leaf == "kernel":  # QER's flax nn.Conv
        return ".".join(parts[:-1] + ["weight"]), value.transpose(3, 2, 0, 1)
    if leaf == "w" and value.ndim == 5:  # QConv2D
        return ".".join(parts), value.transpose(0, 4, 3, 1, 2)
    return ".".join(parts), value


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a JAX variable tree (numpy-convertible leaves) into ``model`` in place.

    Every leaf must land on a port parameter or buffer of the same shape, and
    every parameter and buffer must be covered; anything else raises.
    """
    state = model.state_dict()
    loaded = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})).items():
            name, arr = _port_leaf(path, value)
            if name not in state:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} has no port state {name!r}")
            if tuple(state[name].shape) != arr.shape:
                raise ValueError(f"{name}: port shape {tuple(state[name].shape)} != "
                                 f"carried shape {arr.shape}")
            loaded[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(state[name].dtype)
    missing = sorted(set(state) - set(loaded))
    if missing:
        raise KeyError(f"port state not covered by the JAX variables: {missing}")
    model.load_state_dict(loaded)
    return model
