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
``quant/.../act_absmax``      same name (int8 scale buffer)   none (a 0-d scalar; made on load)
============================  ==============================  ========================================

`export_jax_variables` is the inverse, so a port model's weights can be
written in the JAX facade's checkpoint format (`read_checkpoint` reads one
with numpy alone). `write_checkpoint` pickles a payload whose optax states
are `OptaxState` stand-ins so that JAX's ``pickle.load`` reads optax's own
classes, as a JAX trainer's checkpoint holds them.
"""

from __future__ import annotations

import importlib
import io
import pickle
import re
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """``{path: array}`` of a nested tree; optax's ``MaskedNode`` leaves (the
    parameters outside a masked optimizer group) are left out."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        elif type(v).__name__ != "MaskedNode":  # optax's, or its stand-in
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
    for path, _ in _flatten(variables.get("quant", {})).items():
        # calibrated int8 scales: a conv holds its ``act_absmax`` buffer only once calibrated
        owner = model.get_submodule(_port_leaf(path, None)[0].rsplit(".", 1)[0])
        if not hasattr(owner, path[-1]):
            owner.register_buffer(path[-1], torch.zeros((), device=owner.w.device))
    state = model.state_dict()
    loaded = {}
    for collection in ("params", "batch_stats", "quant"):
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


def to_jax_tree(named: Mapping[str, torch.Tensor], masked: Iterable[str] = ()) -> Dict[str, Any]:
    """Port-named tensors (``stage1_block0.conv1.w``, ...) as one nested tree
    of float32 numpy arrays in the flax layout: `from_jax_tree` inverted. The
    tensors named in ``masked`` are optax ``MaskedNode`` leaves instead (the
    parameters outside an optimizer group, in that group's state)."""
    masked = set(masked)
    out: Dict[str, Any] = {}
    for name, t in named.items():
        if name in masked:  # only the path is wanted: a zero-stride stand-in of the shape
            path, _ = _jax_leaf(name, np.broadcast_to(np.float32(0), tuple(t.shape)))
            leaf = optax_state("MaskedNode")
        else:
            path, arr = _jax_leaf(name, t.detach().float().cpu().numpy())
            leaf = np.ascontiguousarray(arr)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def from_jax_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """A nested flax-layout tree as ``{port state name: array in the port's layout}``."""
    return dict(_port_leaf(path, value) for path, value in _flatten(tree).items())


def export_jax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The model's state as a JAX variable tree ``{"params", "batch_stats"}``
    of float32 numpy arrays in the flax layout: `load_jax_variables` inverted.
    Parameters go to ``params``, the IQBN running statistics to ``batch_stats``,
    and a calibrated int8 model's ``act_absmax`` scales to ``quant`` (present
    only then, as in JAX)."""
    params = set(dict(model.named_parameters()))
    state = model.state_dict()
    quant = {n for n in state if n.endswith(".act_absmax")}
    out = {"params": to_jax_tree({n: t for n, t in state.items() if n in params}),
           "batch_stats": to_jax_tree({n: t for n, t in state.items()
                                       if n not in params and n not in quant})}
    if quant:
        out["quant"] = to_jax_tree({n: state[n] for n in quant})
    return out


class OptaxState(tuple):
    """Stands in for an optax state class (``TraceState``, ``ScaleByScheduleState``,
    ``EmptyState``, ...) in a checkpoint, on a machine that may have no
    optax: a tuple of the state's fields in order, with the class's ``name``
    and, as ``__module__``, the optax module that defines it."""

    name = ""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


# The optax module that defines each state class the port writes, in the optax
# that the JAX package runs (0.2.6; tests/test_torch_checkpoints.py holds each
# to `type(state).__module__` there). A pickle names a class by its module.
OPTAX_MODULES = {
    "EmptyState": "optax._src.base",
    "TraceState": "optax.transforms._accumulation",
    "MultiStepsState": "optax.transforms._accumulation",
    "PartitionState": "optax.transforms._combining",
    "MaskedState": "optax.transforms._masking",
    "MaskedNode": "optax.transforms._masking",
    "InjectStatefulHyperparamsState": "optax.schedules._inject",
    "WrappedScheduleState": "optax.schedules._inject",
    "ScaleByScheduleState": "optax._src.transform",
}
_OPTAX_CLASSES: Dict[Tuple[str, str], type] = {}


def _optax_class(module: str, name: str) -> type:
    """The `OptaxState` subclass standing in for ``module.name`` (one per class)."""
    key = (module, name)
    if key not in _OPTAX_CLASSES:
        _OPTAX_CLASSES[key] = type(name, (OptaxState,), {"name": name, "__module__": module})
    return _OPTAX_CLASSES[key]


def optax_state(name: str, *fields) -> OptaxState:
    """A stand-in for the optax state ``name`` (a key of ``OPTAX_MODULES``)
    holding ``fields``; `write_checkpoint` writes it as that optax class."""
    return _optax_class(OPTAX_MODULES[name], name)(*fields)


class _Module:
    """An optax module that a checkpoint names: pickled as
    ``importlib.import_module(name)``, and what that call gives when
    `read_checkpoint` reads it back."""

    def __init__(self, name: str):
        self.name = name


class _Global:
    """An optax state class: pickled as ``getattr(<its module>, name)``; called,
    a stand-in of it (the pickler wants a callable in that place)."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *fields) -> OptaxState:
        return _optax_class(self.module, self.name)(*fields)


class _OptaxPickler(pickle.Pickler):
    """Writes each `OptaxState` as ``getattr(importlib.import_module(module),
    name)(*fields)``: the optax NamedTuple itself when JAX's ``pickle.load``
    reads the file. Naming the class as a global would make the pickler import
    optax, which this machine may not have."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, OptaxState):
            return _Global(type(obj).__module__, obj.name), tuple(obj)
        if isinstance(obj, _Global):
            return getattr, (_Module(obj.module), obj.name)
        if isinstance(obj, _Module):
            return importlib.import_module, (obj.name,)
        return NotImplemented


def write_checkpoint(path: Union[str, Path], payload: Mapping[str, Any]) -> None:
    """Pickle ``payload`` (containers, numpy arrays, numbers, `OptaxState`
    stand-ins) to ``path``; the JAX package's ``pickle.load`` reads it, optax
    states included, and so does `read_checkpoint`."""
    buf = io.BytesIO()
    _OptaxPickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(payload)
    Path(path).write_bytes(buf.getvalue())


def _import_optax_module(name: str) -> _Module:
    if name != "optax" and not name.startswith("optax."):
        raise pickle.UnpicklingError(f"checkpoint imports {name}: only optax state classes are read")
    return _Module(name)


def _optax_getattr(module: Any, name: str) -> type:
    if not isinstance(module, _Module):
        raise pickle.UnpicklingError(f"checkpoint reads attribute {name} of {module!r}")
    return _optax_class(module.name, name)


# the globals a pickle of numpy arrays and scalars refers to (numpy 1.x and 2.x module names)
_NUMPY_GLOBALS = {(m, n) for m in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
                  for n in ("_reconstruct", "ndarray", "dtype", "scalar")}


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles builtin containers and numpy arrays, reads any ``optax.*``
    class as an `OptaxState` (matched on the module's prefix: the path of a
    state class moves between optax versions), written either as a global or
    as `write_checkpoint` writes it, and refuses every other global: a
    checkpoint file cannot run code, and needs neither JAX, flax nor optax."""

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if module == "optax" or module.startswith("optax."):
            return _optax_class(module, name)
        if (module, name) == ("importlib", "import_module"):
            return _import_optax_module
        if (module, name) == ("builtins", "getattr"):
            return _optax_getattr
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}: only numpy arrays are read")


def read_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """A checkpoint of either package, unpickled with numpy alone: a facade
    checkpoint (``{model_yaml, nc, names, params, batch_stats, raw_params,
    step}``), a trainer checkpoint (``{epoch, step, params, batch_stats,
    ema_params, opt_state}``) or a classification one (``{epoch, params,
    batch_stats, opt_state, step, val_acc}``); optax states come back as
    `OptaxState` stand-ins."""
    return _NumpyUnpickler(io.BytesIO(Path(path).read_bytes())).load()
