"""Load weights trained by the PyTorch reference (bryceag11/QUAN_ultralytics,
torch ``state_dict`` names and layouts) into the port's models: the port's
copy of the JAX package's ``utils/torch_port.py``.

The mapping is written once, on the flax paths that `utils.weights` already
uses: `export_jax_variables` gives the model's leaves by flax path, each is
fetched from the reference dict under its torch name and put in the flax
layout, and `load_jax_variables` carries the result into the model (which
checks that every parameter and buffer is covered, with its shape). Names:

    model.23.cv3.0.0.0.conv.weight_r  ->  model_23/detect/cv3_0_0a/conv/w[0]
    model.10.m.0.attn.qkv.weight_i    ->  model_10/m0/attn/qkv/w[1]
    ...bn.gamma [C, 4]                ->  .../bn/gamma [4, C] (transposed)
    ...bn.running_mean [C, 4]         ->  .../bn/mean [4, C]
    ...output_proj.weight (QER)       ->  .../proj/kernel (OIHW -> HWIO, and
                                          the input channels from the
                                          reference's c-major quaternion
                                          flatten, index c*4+q, to q-major q*C+c)

A leaf whose torch name is missing from the dict raises `KeyError` naming
it, a shape that does not fit raises `ValueError`; keys of the dict that no
leaf reads are ignored, as the JAX package ignores them (a reference state
dict also holds, for one, DFL's fixed convolution). `to_reference_state_dict`
is the inverse: a model's leaves in the reference's names and layouts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch.nn as nn

from quan_ultralytics_tpu_torch.utils.weights import _flatten, export_jax_variables, load_jax_variables


def torch_prefix(tokens) -> str:
    """Flax path tokens -> the reference's torch module path."""
    out = []
    for t in tokens:
        if t == "detect":
            continue  # flax nests OBB's Detect; torch OBB subclasses Detect
        m = re.fullmatch(r"model_(\d+)", t)
        if m:
            out.append(f"model.{m.group(1)}")
            continue
        m = re.fullmatch(r"(m|ffn)(\d+)", t)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            continue
        m = re.fullmatch(r"(cv\d)((?:_\d+)+)([ab]?)", t)
        if m:
            s = m.group(1) + m.group(2).replace("_", ".")
            if m.group(3):
                s += "." + ("0" if m.group(3) == "a" else "1")
            out.append(s)
            continue
        out.append(t)
    return ".".join(out)


def _qer_input_reorder(w_hwio: np.ndarray) -> np.ndarray:
    """Reorder a QER kernel's input dim from torch's c-major quaternion
    flatten (index c*4+q) to the q-major flatten (index q*C+c)."""
    return w_hwio[:, :, _c_major(w_hwio.shape[2]), :]


def _c_major(n: int) -> np.ndarray:
    """For q-major index q*C+c, the c-major index c*4+q of the same channel."""
    return np.arange(n).reshape(n // 4, 4).T.reshape(-1)


def _fetcher(sd: Mapping[str, Any]):
    def fetch(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"torch param {name!r} not found in state_dict")
        v = sd[name]
        return (v.detach().float().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)).astype(np.float32)
    return fetch


def _port(model: nn.Module, leaf_fn) -> nn.Module:
    """Replace every leaf of ``model`` by ``leaf_fn(parent path, leaf name)``."""
    ported: Dict[str, Dict] = {}
    for coll, tree in export_jax_variables(model).items():
        out: Dict[str, Any] = {}
        for path, leaf in _flatten(tree).items():
            v = np.asarray(leaf_fn(path[:-1], path[-1]), np.float32)
            if v.shape != leaf.shape:
                raise ValueError(f"{'/'.join(path)}: reference shape {v.shape} != model shape {leaf.shape}")
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v
        ported[coll] = out
    return load_jax_variables(model, ported)


def to_reference_state_dict(variables: Mapping[str, Mapping], prefix_fn=torch_prefix,
                            dense: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """The inverse of `port_state_dict` and `port_cls_state_dict`: a flax-path
    variable tree (``{collection: nested dict}``, as `export_jax_variables`
    gives it) -> a state dict in the reference's names and layouts.

    ``prefix_fn`` maps a leaf's parent path to its torch module path
    (`torch_prefix`, or ``lambda parent: _cls_prefix(parent, family)``);
    ``dense`` names the QDense modules (4x ``nn.Linear``, ``linear_r{c}``) of
    the classification families. QConv2D ``w [4, kh, kw, ci, co]`` -> four
    OIHW ``weight_{r,i,j,k}``, QER kernels HWIO -> OIHW with the input
    channels in the reference's c-major order, IQBN ``[4, C]`` -> ``[C, 4]``."""
    sd: Dict[str, np.ndarray] = {}
    for tree in variables.values():
        for path, v in _flatten(tree).items():
            v = np.asarray(v, np.float32)
            parent, name = path[:-1], path[-1]
            pre = prefix_fn(parent)
            if parent and parent[-1] in dense and name == "w":
                for c, comp in enumerate("rijk"):
                    sd[f"{pre}.linear_r{comp}.weight"] = np.ascontiguousarray(v[c].T)
            elif parent and parent[-1] in dense and name == "b":
                for c, comp in enumerate("rijk"):
                    sd[f"{pre}.linear_r{comp}.bias"] = v[c]
            elif name == "w":
                for c, comp in enumerate("rijk"):
                    sd[f"{pre}.weight_{comp}"] = np.ascontiguousarray(v[c].transpose(3, 2, 0, 1))
            elif name == "b":
                sd[f"{pre}.bias_r"] = v
            elif name == "kernel":
                ref = np.empty_like(v)
                ref[:, :, _c_major(v.shape[2]), :] = v
                sd[f"{prefix_fn(parent[:-1])}.output_proj.weight"] = np.ascontiguousarray(ref.transpose(3, 2, 0, 1))
            elif name == "bias" and parent and parent[-1] in ("proj", "mix"):
                sd[f"{prefix_fn(parent[:-1])}.bias"] = v
            elif name in ("gamma", "beta", "weight", "bias"):
                sd[f"{pre}.{name}"] = np.ascontiguousarray(v.T)
            elif name in ("mean", "var"):
                sd[f"{pre}.running_{name}"] = np.ascontiguousarray(v.T)
            else:
                raise KeyError(f"unmapped leaf {'/'.join(path)}")
    return sd


def port_state_dict(sd: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load a reference detection ``state_dict`` (name -> numpy array or torch
    tensor: parameters and buffers) into a port `DetectionModel` in place."""
    fetch = _fetcher(sd)

    def leaf(parent: Tuple[str, ...], name: str) -> np.ndarray:
        prefix = torch_prefix(parent)
        if name == "w":  # QConv2D [4, kH, kW, Cin/g, Cout] <- 4x OIHW
            return np.stack([fetch(f"{prefix}.weight_{c}").transpose(2, 3, 1, 0) for c in "rijk"])
        if name == "b":
            return fetch(f"{prefix}.bias_r")
        if name == "kernel":  # QER / QERPreserve real conv
            base = torch_prefix(parent[:-1])
            key = f"{base}.output_proj.weight" if f"{base}.output_proj.weight" in sd else f"{base}.mix.weight"
            return _qer_input_reorder(fetch(key).transpose(2, 3, 1, 0))
        if name == "bias" and parent and parent[-1] in ("proj", "mix"):
            # torch QER aliases the proj bias as its own `.bias` (head.py:39),
            # which wins name dedup in named_parameters
            base = torch_prefix(parent[:-1])
            for cand in (f"{base}.bias", f"{base}.output_proj.bias", f"{base}.mix.bias"):
                if cand in sd:
                    return fetch(cand)
            raise KeyError(f"no torch bias for {'/'.join(parent + (name,))} (tried {base}.bias, "
                           f"{base}.output_proj.bias, {base}.mix.bias)")
        if name in ("gamma", "beta", "weight", "bias"):  # IQBN / IQLN affine
            return fetch(f"{prefix}.{name}").T
        if name in ("mean", "var"):  # IQBN running stats
            return fetch(f"{prefix}.running_{name}").T
        raise KeyError(f"unmapped leaf {'/'.join(parent + (name,))}")

    return _port(model, leaf)


def _cls_prefix(parent, family: str) -> str:
    """Flax path -> torch module path for the classification families.

    wrn_cifar       (QWideResNet):     stage{s}_block{b} -> stage{s}.layer.{b};
                    classifier -> classifier.1 (Sequential(Flatten, QDense)).
    resnet_cifar    (QResNetCIFAR):    stem_conv/stem_bn -> conv1.0/conv1.1;
                    stage{s}_block{b} -> stage{s}.{b};
                    fc1/fc2 -> classifier.1/classifier.3.
    imagenet_resnet (QResNetImageNet): like resnet_cifar but the single
                    classifier -> classifier.2 (Sequential(Flatten, Dropout,
                    QDense), reference quaternion_models.py:204-209).
    imagenet_wrn    (QWideResNetImageNet): like imagenet_resnet but stages
                    nest as stage{s}.layer.{b} (QWideResNetBlock).
    """
    layered = family in ("wrn_cifar", "imagenet_wrn")
    out = []
    for t in parent:
        m = re.fullmatch(r"stage(\d+)_block(\d+)", t)
        if m:
            s, b = m.groups()
            out.append(f"stage{s}.layer.{b}" if layered else f"stage{s}.{b}")
        elif t == "stem_conv":
            out.append("conv1.0")
        elif t == "stem_bn":
            out.append("conv1.1")
        elif t == "classifier":
            out.append("classifier.1" if family == "wrn_cifar" else "classifier.2")
        elif t == "fc1":
            out.append("classifier.1")
        elif t == "fc2":
            out.append("classifier.3")
        else:
            out.append(t)
    return ".".join(out)


CLS_FAMILIES = ("wrn_cifar", "resnet_cifar", "imagenet_resnet", "imagenet_wrn")


def port_cls_state_dict(sd: Mapping[str, Any], model: nn.Module, family: Optional[str] = None) -> nn.Module:
    """Load a reference classification ``state_dict`` (Q-WRN / Q-ResNet
    families) into a port model of ``classification/models.py`` in place:
    QConv2D (4x OIHW -> [4, kh, kw, ci, co]), IQBN ([C, 4] -> [4, C]) and
    QDense (4x nn.Linear -> w [4, fi, fo], b [4, fo]).

    family: one of `CLS_FAMILIES`; found from the model's parameters when
    None (pass "imagenet_wrn" for QWRN-50-2: its tree reads as the ImageNet
    Q-ResNet's)."""
    fetch = _fetcher(sd)
    if family is None:
        top = {name.split(".")[0] for name, _ in model.named_parameters()}
        family = "resnet_cifar" if "fc1" in top else "imagenet_resnet" if "stem_conv" in top else "wrn_cifar"
    if family not in CLS_FAMILIES:
        raise ValueError(f"family {family!r}: expected one of {CLS_FAMILIES}")

    def leaf(parent: Tuple[str, ...], name: str) -> np.ndarray:
        prefix = _cls_prefix(parent, family)
        dense = bool(parent) and parent[-1] in ("classifier", "fc1", "fc2")
        if dense and name == "w":
            return np.stack([fetch(f"{prefix}.linear_r{c}.weight").T for c in "rijk"])
        if dense and name == "b":
            return np.stack([fetch(f"{prefix}.linear_r{c}.bias") for c in "rijk"])
        if name == "w":
            return np.stack([fetch(f"{prefix}.weight_{c}").transpose(2, 3, 1, 0) for c in "rijk"])
        if name == "b":
            return fetch(f"{prefix}.bias_r")
        if name in ("gamma", "beta"):
            return fetch(f"{prefix}.{name}").T
        if name in ("mean", "var"):
            return fetch(f"{prefix}.running_{name}").T
        raise KeyError(f"unmapped leaf {'/'.join(parent + (name,))}")

    return _port(model, leaf)
