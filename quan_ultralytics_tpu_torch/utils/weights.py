"""Carry the JAX package's variables into a port module.

The JAX package keeps a flax tree ``{"params": ..., "batch_stats": ...}``; the
port's state names follow its paths, with ``model_N`` read as ``model.N``:
``params/model_10/m0/attn/qkv/w`` becomes ``model.10.m0.attn.qkv.w``; a tree
without ``model_N`` keys (the classification models: ``stage1_block0/conv1/w``,
``classifier/w``) carries name for name. Leaf by leaf:

============================  ==============================  ========================================
flax leaf                     port state                      layout transform
============================  ==============================  ========================================
``.../w``  (QConv2D)          ``.../w``                       ``[4, kH, kW, Cin/g, Cout]`` -> ``[4, Cout, Cin/g, kH, kW]``
``.../b``  (QConv2D)          ``.../b``                       none (``[Cout]``)
``.../gamma``, ``beta``       same name (IQBN parameters)     none (``[4, C]``)
``batch_stats/.../mean, var`` same name (IQBN buffers)        none (``[4, C]``)
``.../w``  (QDense)           ``.../w``                       none (``[4, F_in, F_out]``)
``.../b``  (QDense)           ``.../b``                       none (``[4, F_out]``)
``.../proj/kernel`` (QER)     ``.../proj.weight``             HWIO -> OIHW; input channels stay q-major
``.../proj/bias``   (QER)     ``.../proj.bias``               none
``.../linear/kernel`` (Dense) ``.../linear.weight``           ``[in, out]`` -> ``[out, in]``
``.../linear/bias``           ``.../linear.bias``             none
============================  ==============================  ========================================

`export_jax_variables` is the inverse, so a port model's weights can be
written in the JAX facade's checkpoint format (`read_checkpoint` reads one
with numpy alone).
"""

from __future__ import annotations

import io
import pickle
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

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
    if leaf == "kernel":  # QER's flax nn.Conv (HWIO), Classify's nn.Dense ([in, out])
        return ".".join(parts[:-1] + ["weight"]), (value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1))
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


def _jax_leaf(name: str, value: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """One port state entry -> (flax path, array in the flax layout): `_port_leaf` inverted."""
    parts = name.split(".")
    path = []
    for p in parts:
        if path and path[-1] == "model" and p.isdigit():
            path[-1] = f"model_{p}"
        else:
            path.append(p)
    if path[-1] == "weight" and value.ndim == 4:  # QER's conv: OIHW -> HWIO
        return tuple(path[:-1]) + ("kernel",), value.transpose(2, 3, 1, 0)
    if path[-1] == "weight" and value.ndim == 2:  # Classify's linear: [out, in] -> [in, out]
        return tuple(path[:-1]) + ("kernel",), value.T
    if path[-1] == "w" and value.ndim == 5:  # QConv2D: [4, Cout, Cin/g, kH, kW] -> [4, kH, kW, Cin/g, Cout]
        return tuple(path), value.transpose(0, 3, 4, 2, 1)
    return tuple(path), value


def to_jax_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port-named tensors (``stage1_block0.conv1.w``, ...) as one nested tree
    of float32 numpy arrays in the flax layout: `from_jax_tree` inverted."""
    out: Dict[str, Any] = {}
    for name, t in named.items():
        path, arr = _jax_leaf(name, t.detach().float().cpu().numpy())
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def from_jax_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """A nested flax-layout tree as ``{port state name: array in the port's layout}``."""
    return dict(_port_leaf(path, value) for path, value in _flatten(tree).items())


def export_jax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The model's state as a JAX variable tree ``{"params", "batch_stats"}``
    of float32 numpy arrays in the flax layout: `load_jax_variables` inverted.
    Parameters go to ``params``, the IQBN running statistics to ``batch_stats``."""
    params = set(dict(model.named_parameters()))
    state = model.state_dict()
    return {"params": to_jax_tree({n: t for n, t in state.items() if n in params}),
            "batch_stats": to_jax_tree({n: t for n, t in state.items() if n not in params})}


class OptaxState(tuple):
    """Stands in for an optax state class (``TraceState``, ``ScaleByScheduleState``,
    ``EmptyState``, ...) met in a JAX checkpoint, whose machine may have no
    optax: a tuple of the state's fields in order, with the class's ``name``."""

    name = ""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


# the globals a pickle of numpy arrays refers to (numpy 1.x and 2.x module names)
_NUMPY_GLOBALS = {(m, n) for m in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
                  for n in ("_reconstruct", "ndarray", "dtype")}


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles builtin containers and numpy arrays, reads any ``optax.*``
    class as an `OptaxState` (matched on the module's prefix: the path of a
    state class moves between optax versions), and refuses every other global:
    a checkpoint file cannot run code, and needs neither JAX, flax nor optax."""

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if module == "optax" or module.startswith("optax."):
            return type(name, (OptaxState,), {"name": name, "__module__": module})
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}: only numpy arrays are read")


def read_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """A facade checkpoint (``{model_yaml, nc, names, params, batch_stats,
    raw_params, step}``, the JAX facade's format, as `engine.model.YOLO`
    writes it too) or a classification checkpoint (``{epoch, params,
    batch_stats, opt_state, step, val_acc}``), unpickled with numpy alone."""
    return _NumpyUnpickler(io.BytesIO(Path(path).read_bytes())).load()
