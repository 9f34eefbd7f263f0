"""Model config -> PyTorch model, and the task model (counterpart of the JAX ``models/tasks.py``).

`parse_model` repeats the reference's channel bookkeeping
(ultralytics/nn/tasks.py:942-1098) for the modules the QUAN configs use and
gives a static layer spec; `QUANYOLO` builds one module per layer into
``model`` (so state names read ``model.10.m0.attn.qkv.w``, the JAX package's
flax path ``model_10/m0/attn/qkv/w``) and walks the skip-connection save
list in ``forward``. ``stem_s2d`` and ``stem_deep`` are the JAX package's
phase-composite and deep-packed stems (ops/stem.py, `stem_layout`): the same
math and parameters on space-to-depth packed activations.
"""

from __future__ import annotations

import copy
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from quan_ultralytics_tpu_torch.cfg.model_yaml import load_model_yaml
from quan_ultralytics_tpu_torch.cfg.models import MODELS
from quan_ultralytics_tpu_torch.models import block as B
from quan_ultralytics_tpu_torch.models import conv as C
from quan_ultralytics_tpu_torch.models import head as H
from quan_ultralytics_tpu_torch.ops.stem import depth_to_space_cmajor, depth_to_space_phasemajor

SCALE_RE = re.compile(r"yolo\d+([nslmx])")


# `fused_1x1` by default: on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 35),
# QUAN-YOLO11n-OBB's infer @1024, batch 8, takes 8.96 ms of device time with the
# fused 1x1 kernel at its 37 sites against 10.09 without in bf16, and 14.99 against
# 17.21 in f32, in 1,382 device operations against 1,678 (phase 4); the JAX
# package's QUAN_FUSED_1X1 is off by default. It acts in eval only.
FUSED_1X1 = True

# The stem's default form: the plain stem (STEM_S2D False, STEM_DEEP 0). The
# JAX package builds every model with its phase-composite stem (stem_s2d on),
# chosen on a TPU, which pads narrow activations to 128 lanes; an H100 does
# not. On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 53, run three times
# in one call by scripts/stem_phases.py --repeat 3), QUAN-YOLO11n-OBB's infer
# @1024, batch 8, bf16, K1+K3 takes 10.03-10.23 ms of device time with the
# plain stem, 9.66-9.89 with stem_s2d, 9.67-9.83 at stem_deep 1, 9.87-10.05
# at 2, 9.99-10.23 at 3 and 9.84-10.05 at 1 with stem_l0 "fine", lower in
# every round for stem_s2d and deep 1 (8.67, 8.56 and 8.58 ms in a whole run
# of chip_smoke.py). But this infer is bound by the host's launches, and on
# the host clock no form is shown no slower: its same-round difference from
# the plain stem has a median of -3.2 to +5.1 ms over 10 rounds, either sign,
# inside a spread of 10.6-16.4 ms between rounds. So the plain stem stays.
STEM_S2D = False
STEM_DEEP = 0


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names another.

    Raises when ``cuda`` is asked for (explicitly or by default) and no card
    is present: the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round up to the nearest multiple (reference utils/ops.py make_divisible)."""
    return math.ceil(x / divisor) * divisor


@dataclass(frozen=True)
class LayerSpec:
    i: int
    f: Tuple[int, ...]  # input layer indices (-1 = previous)
    module: str
    args: Tuple[Any, ...]
    n: int  # repeats (absorbed into module args for CSP blocks)
    c2: int  # output channels (total quaternion space)
    stride: int  # cumulative stride of the output


# Modules that take (c1, c2, ...) and get width scaling on args[0].
_CONV_LIKE = {"Conv", "DWConv", "Bottleneck", "QSPPF", "C2f", "C3", "C3k",
              "C3k2", "QC3k2", "QC2PSA", "QPSA", "Classify"}
# CSP-style modules that absorb the repeat count as arg index 2.
_ABSORB_N = {"C2f", "C3", "C3k", "C3k2", "QC3k2", "QC2PSA"}
_HEADS = {"Detect", "OBB", "HybridDetect", "Segment", "Pose"}


def resolve_model_cfg(model: Union[str, Path]) -> Tuple[Dict, str]:
    """A model YAML path, or a catalog name such as 'yolo11n-obb-quan.yaml', ->
    (config dict, scale letter). An existing file is read (`load_model_yaml`);
    otherwise the name, its scale letter dropped, is looked up in ``MODELS``.
    The scale letter follows the architecture number of the file name
    ('yolo11n-...' -> 'n'); without one it is the config's first scale."""
    name = Path(model).name
    m = SCALE_RE.search(name)
    base = re.sub(r"(yolo\d+)[nslmx]", r"\1", name)
    if Path(model).exists():
        cfg = load_model_yaml(model)
    elif base in MODELS:
        cfg = MODELS[base]
    else:
        raise FileNotFoundError(f"model config {model!r} is neither a file nor one of {sorted(MODELS)}")
    scale = m.group(1) if m else next(iter(cfg.get("scales", {"n": None})))
    return cfg, scale


def parse_model(cfg: Dict, scale: str, nc: Optional[int] = None) -> Tuple[List[LayerSpec], List[int], int]:
    """Compile a model config into layer specs: (specs, save_list, nc).

    Channels follow reference tasks.py:1016 (``make_divisible(min(c2,
    max_channels) * width, 8)``), depth tasks.py:969 (``max(round(n * depth),
    1)``) and the C3k2 m/l/x rule tasks.py:1045-1048.
    """
    nc = nc if nc is not None else cfg.get("nc", 80)
    depth, width, max_channels = cfg["scales"][scale]
    ch: List[int] = []
    strides: List[int] = []
    specs: List[LayerSpec] = []
    save: List[int] = []

    for i, (f, n, m, args) in enumerate(cfg["backbone"] + cfg["head"]):
        args = [nc if a == "nc" else a for a in args]
        n_scaled = max(round(n * depth), 1) if n > 1 else n
        fs = tuple(f) if isinstance(f, list) else (f,)
        in_ch = [ch[x] if (x != -1 or ch) else 3 for x in fs]
        in_stride = [strides[x] if (x != -1 or strides) else 1 for x in fs]

        if m in _CONV_LIKE:
            c1, c2 = in_ch[0], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            margs: List[Any] = [c1, c2, *args[1:]]
            if m in _ABSORB_N:
                margs.insert(2, n_scaled)
                n_scaled = 1
            if m == "C3k2" and scale in "mlx":
                margs[3] = True
            stride = in_stride[0] * (2 if m in {"Conv", "DWConv"} and len(margs) > 3 and margs[3] == 2 else 1)
        elif m == "QUpsample":
            c2 = in_ch[0]
            margs = list(args)
            stride = in_stride[0] // int(args[0])
        elif m == "Concat":
            c2 = sum(in_ch)
            margs = []
            stride = in_stride[0]
        elif m in _HEADS:
            if m == "Segment":  # width-scale the proto channels (reference tasks.py:1080)
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            margs = [*args, tuple(in_ch), tuple(in_stride)]
            c2 = 0
            stride = in_stride[0]
        else:
            raise ValueError(f"unsupported module {m!r} in model config")

        specs.append(LayerSpec(i, fs, m, tuple(margs), n_scaled, c2, stride))
        save.extend(x % i for x in fs if x != -1)
        ch.append(c2)
        strides.append(stride)

    return specs, sorted(set(save)), nc


class Concat(nn.Module):
    """Channel concat layer of the graph."""

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return B.qconcat(xs)


def _is_conv_k3s2(spec: LayerSpec) -> bool:
    return spec.module == "Conv" and tuple(spec.args[2:4]) == (3, 2)


def stem_layout(specs: Sequence[LayerSpec], save: Sequence[int], stem_s2d: bool = False,
                stem_deep: int = 0) -> Tuple[List[Dict[str, Any]], int]:
    """Each layer's stem form and the deep-packing level taken (the JAX
    ``QUANYOLO`` rules, models/tasks.py): ``[{"stem_mode", "packed",
    "packed_out"}]`` a layer, ``packed_out`` the layout of its output
    (``"cmajor"``, ``"phase"`` or None: unpacked), and K.

    * ``stem_deep`` = K >= 1 needs layers 0, 1, 3 to be Conv(k=3, s=2), layer 2
      a C3k2, and no save-list tap of layers 0-2: then layer 0 packs its output
      (``out``), the odd Convs up to 2K-1 stay packed (``both``) and so do the
      C3k2s up to 2K, and Conv 2K+1 unpacks (``in``). Each level above 1 needs
      a C3k2 at 2K and a Conv(3, 2) at 2K+1 whose input is no tap; K is cut to
      what the graph allows.
    * else ``stem_s2d``, where layers 0 and 1 are Conv(3, 2) and layer 0 is no
      tap: layer 0 ``phase_out``, layer 1 ``phase_in``.
    """
    n = len(specs)
    layout = [{"stem_mode": None, "packed": None, "packed_out": None} for _ in specs]
    deep_k = 0
    if (stem_deep and n > 3 and not any(i in save for i in (0, 1, 2))
            and all(_is_conv_k3s2(specs[i]) for i in (0, 1, 3))
            and specs[2].module in ("C3k2", "QC3k2")):
        deep_k = 1
        while deep_k < int(stem_deep):
            i_c3, i_cv = 2 * (deep_k + 1), 2 * (deep_k + 1) + 1
            if (n > i_cv and (i_c3 - 1) not in save and specs[i_c3].module in ("C3k2", "QC3k2")
                    and _is_conv_k3s2(specs[i_cv])):
                deep_k += 1
            else:
                break
    if deep_k:
        for i in range(2 * deep_k + 2):
            if i == 0:
                layout[i].update(packed="out", packed_out="cmajor")
            elif i == 2 * deep_k + 1:
                layout[i]["packed"] = "in"
            elif i % 2:
                layout[i].update(packed="both", packed_out="cmajor")
            else:  # a C3k2
                layout[i].update(packed=True, packed_out="cmajor")
    elif (stem_s2d and 0 not in save and n > 1 and _is_conv_k3s2(specs[0])
          and _is_conv_k3s2(specs[1])):
        layout[0].update(stem_mode="phase_out", packed_out="phase")
        layout[1]["stem_mode"] = "phase_in"
    return layout, deep_k


def unpack(y: torch.Tensor, packed_out: Optional[str]) -> torch.Tensor:
    """A layer's output in the public ``[B, H, W, 4, C]`` form."""
    if packed_out == "cmajor":
        return depth_to_space_cmajor(y)
    if packed_out == "phase":
        return depth_to_space_phasemajor(y)
    return y


def build_layer(spec: LayerSpec, dtype: Optional[torch.dtype], mapping_type: str, impl: str,
                fused_attn: bool, fused_1x1: bool, stem: Optional[Dict[str, Any]] = None) -> nn.Module:
    """The module of one layer spec; ``stem``: its Conv or C3k2's stem form and
    options (`stem_layout`, ``stem_l0``, ``stem_remat``, ``packed_impl``)."""
    m, a = spec.module, spec.args
    kw = dict(dtype=dtype, impl=impl, fused_1x1=fused_1x1)
    if m == "Conv":
        return C.Conv(*a, mapping_type=mapping_type, **kw, **(stem or {}))
    if m == "DWConv":
        return C.DWConv(*a, **kw)
    if m in ("C3k2", "QC3k2"):
        return B.C3k2(*a, **kw, **(stem or {}))
    if m == "QSPPF":
        return B.QSPPF(*a, **kw)
    if m == "C2f":
        return B.C2f(*a, **kw)
    if m == "QC2PSA":
        return B.QC2PSA(*a, fused_attn=fused_attn, **kw)
    if m == "QPSA":
        return B.QPSA(*a, fused_attn=fused_attn, **kw)
    if m == "QUpsample":
        return C.QUpsample(int(a[0]), str(a[1]) if len(a) > 1 else "nearest")
    if m == "Concat":
        return Concat()
    if m == "Detect":
        nc, ch, strides = a
        return H.Detect(nc, ch, strides, **kw)
    if m == "HybridDetect":
        nc, ch, strides = a
        return H.HybridDetect(nc, ch, strides, **kw)
    if m == "OBB":
        nc, ne, ch, strides = a
        return H.OBB(nc, ch, ne, strides, **kw)
    if m == "Segment":
        nc, nm, npr, ch, strides = a
        return H.Segment(nc, ch, nm, npr, strides, **kw)
    if m == "Pose":
        nc, kpt_shape, ch, strides = a
        return H.Pose(nc, ch, tuple(kpt_shape), strides, **kw)
    if m == "Classify":
        return H.Classify(*a, **kw)
    raise ValueError(f"unknown module {m!r}")


class QUANYOLO(nn.Module):
    """The YOLO graph built from a layer-spec tuple. ``forward`` returns the
    head output: per-level maps for Detect, ``(feats, angles)`` for OBB,
    ``(feats, mc, proto)`` for Segment, ``(feats, kpts)`` for Pose, ``[B, nc]``
    logits for Classify.

    ``stem_s2d``, ``stem_deep`` (level K): the JAX package's phase-composite
    and deep-packed stems, as `stem_layout` applies them; ``stem_l0``,
    ``stem_remat`` and ``packed_impl`` are their options (`models.conv.QConv2D`,
    JAX's ``QUAN_STEM_L0``, ``QUAN_STEM_REMAT`` and ``QUAN_PACKED_IMPL``). The
    parameters and outputs are the plain graph's; a packed tap of the save
    list is unpacked once, and captured and ``upto`` outputs are unpacked."""

    def __init__(self, specs: Sequence[LayerSpec], save: Sequence[int],
                 dtype: Optional[torch.dtype] = None, mapping_type: str = "poincare",
                 impl: str = "auto", fused_attn: bool = True, fused_1x1: bool = FUSED_1X1,
                 stem_s2d: bool = STEM_S2D, stem_deep: int = STEM_DEEP, stem_l0: str = "prepack",
                 stem_remat: bool = False, packed_impl: Optional[str] = None):
        super().__init__()
        self.specs, self.save = tuple(specs), tuple(save)
        self.dtype = dtype
        layout, self.deep_k = stem_layout(self.specs, self.save, stem_s2d, stem_deep)
        self.packed_out = [lay["packed_out"] for lay in layout]
        stems = []
        for i, (spec, lay) in enumerate(zip(self.specs, layout)):
            st = {k: lay[k] for k in ("stem_mode", "packed") if lay[k] is not None}
            if st:
                st["packed_impl"] = packed_impl
            if i == 0 and spec.module == "Conv":
                st.update(stem_l0=stem_l0, stem_remat=stem_remat)
            stems.append(st)
        self.model = nn.ModuleList(
            build_layer(s, dtype, mapping_type, impl, fused_attn, fused_1x1, st)
            for s, st in zip(self.specs, stems))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight anew, in module order, from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (C.QConv2D, C.QDense, H.QER, H.QERPreserve, H.Classify)):
                mod.reset_parameters(generator)

    def forward(self, x: torch.Tensor, upto: Optional[int] = None,
                capture: Optional[Dict[int, torch.Tensor]] = None):
        """The head output, or with ``upto`` the output of layer ``upto`` (the
        graph's prefix runs alone: `utils.profiler.profile_layers`). ``capture``
        collects each layer's output that is one tensor, by layer index (a
        head's tuple is left out)."""
        saved: Dict[int, Any] = {}
        y = x
        for spec, layer, packed_out in zip(self.specs, self.model, self.packed_out):
            inputs = [y if j == -1 else saved[j] for j in spec.f]
            y = layer(inputs if spec.module in _HEADS or spec.module == "Concat" else inputs[0])
            if spec.i in self.save:
                saved[spec.i] = unpack(y, packed_out)
            if capture is not None and isinstance(y, torch.Tensor):
                capture[spec.i] = unpack(y, packed_out)
            if spec.i == upto:
                return unpack(y, packed_out)
        return y


class DetectionModel(QUANYOLO):
    """Task model: the graph plus its metadata (analog of reference nn/tasks.py
    DetectionModel / OBBModel / SegmentationModel / PoseModel /
    ClassificationModel). Parameters are float32; ``dtype`` is the activation
    dtype. A classify model has no strides."""

    def __init__(self, cfg: Dict, scale: str, nc: Optional[int] = None, **kw):
        specs, save, nc_ = parse_model(cfg, scale, nc)
        super().__init__(specs, save, **kw)
        self.cfg, self.scale, self.nc = cfg, scale, nc_
        head = specs[-1]
        self.task = {"OBB": "obb", "Segment": "segment", "Pose": "pose",
                     "Classify": "classify"}.get(head.module, "detect")
        self.strides = () if self.task == "classify" else tuple(head.args[-1])
        self.reg_max = 16
        # pose: (keypoints, values a keypoint)
        self.kpt_shape = tuple(int(v) for v in head.args[1]) if self.task == "pose" else None

    @classmethod
    def from_yaml(cls, model: str = "yolo11n-obb-quan.yaml", nc: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None,
                  device: Optional[Union[str, torch.device]] = None,
                  mapping_type: str = "poincare", impl: str = "auto",
                  fused_attn: bool = True, fused_1x1: bool = FUSED_1X1,
                  seed: int = 0, int8_min_c: int = 0, stem_s2d: bool = STEM_S2D,
                  stem_deep: int = STEM_DEEP, stem_l0: str = "prepack", stem_remat: bool = False,
                  packed_impl: Optional[str] = None) -> "DetectionModel":
        """Build a model from a model YAML path or a catalog name (`resolve_model_cfg`),
        with weights drawn from ``seed``.

        Runs on ``cuda`` unless ``device`` names another device; raises when
        no card is present and the CPU was not asked for. Returned in eval
        mode. ``impl`` is the quaternion conv mapping (``auto``, with the
        fold thresholds of models/conv.py: the form with the least device time
        on the H100, where ``grouped``, the JAX library's default, takes the
        most); ``fused_attn`` runs the attention kernel (on by default);
        ``fused_1x1`` the fused 1x1 Conv+IQBN+SiLU kernel in eval (on by
        default, ``FUSED_1X1``; off in the JAX package). ``impl="int8"`` is the
        inference-only int8 serving form (`models.conv.QConv2D`; calibrate it
        with `ops.quant.calibrate_int8`), ``int8_min_c`` its width threshold;
        the fused 1x1 sites keep ``fused_1x1``'s kernel, as in JAX.
        ``stem_s2d``, ``stem_deep``, ``stem_l0``, ``stem_remat`` and
        ``packed_impl``: the stem's form (`QUANYOLO`; defaults ``STEM_S2D`` and
        ``STEM_DEEP``), keyword arguments where JAX reads ``QUAN_STEM_*``.
        """
        dev = resolve_device(device)
        cfg, scale = resolve_model_cfg(model)
        m = cls(cfg, scale, nc, dtype=dtype, mapping_type=mapping_type, impl=impl,
                fused_attn=fused_attn, fused_1x1=fused_1x1, stem_s2d=stem_s2d, stem_deep=stem_deep,
                stem_l0=stem_l0, stem_remat=stem_remat, packed_impl=packed_impl)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        for mod in m.modules():
            if isinstance(mod, C.QConv2D):
                mod.int8_min_c = int8_min_c
        return m.to(dev).eval()

    def decode(self, out):
        """Head output -> ``[B, A, ...]`` predictions in input-pixel units (classify:
        the ``[B, nc]`` logits as they are)."""
        if self.task == "classify":
            return out
        if self.task == "obb":
            feats, angles = out
            return H.decode_obb(feats, angles, self.strides, self.nc, self.reg_max)
        if self.task == "segment":
            feats, mc, _ = out
            return H.decode_segment(feats, mc, self.strides, self.nc, self.reg_max)
        if self.task == "pose":
            feats, kpts = out
            return H.decode_pose(feats, kpts, self.strides, self.nc, self.kpt_shape, self.reg_max)
        return H.decode_detect(out, self.strides, self.nc, self.reg_max)

    def features(self, x: torch.Tensor, layers: Optional[Sequence[int]] = None):
        """Per-layer feature maps (the JAX ``DetectionModel.features``; reference
        nn/tasks.py:140 ``_predict_once`` with visualize/embed): ``(head output,
        {layer: [B, H, W, 4, C] tensor})`` for every layer whose output is one
        tensor (heads return tuples and are left out), or for ``layers`` only."""
        feats: Dict[int, torch.Tensor] = {}
        out = self(x, capture=feats)
        if layers is not None:
            feats = {int(i): feats[int(i)] for i in layers}
        return out, feats

    def info(self, imgsz: int = 640, log=print) -> Dict[str, Any]:
        """The layer table and the params / GFLOPs summary (the JAX
        ``DetectionModel.info``; reference model_info, torch_utils.py:299, and
        parse_model's build log); returns `utils.profiler.summary`."""
        from quan_ultralytics_tpu_torch.utils.profiler import summary

        log(f"{'':>3}{'from':>14}{'n':>3}  {'module':<14}{'args'}")
        for s in self.specs:
            log(f"{s.i:>3}{str(list(s.f)):>14}{s.n:>3}  {s.module:<14}{list(s.args)}")
        info = summary(self, imgsz)
        log(f"{self.scale}-scale {self.task}: {info['params']:,} params, "
            f"~{info['approx_conv_gflops']:.1f} conv GFLOPs @ {imgsz}px")
        return info

    @property
    def extra_dim(self) -> int:
        """Columns an anchor carries through NMS after the class scores: the
        mask coefficients (segment) or the decoded keypoints (pose)."""
        if self.task == "pose":
            return self.kpt_shape[0] * self.kpt_shape[1]
        return int(self.specs[-1].args[1]) if self.task == "segment" else 0


def fused_1x1_sites(model: QUANYOLO, batch: int,
                    imgsz: Union[int, Tuple[int, int]]) -> List[Tuple[int, int, int]]:
    """``(Ci, Co, P)`` of every Conv that ``fused_1x1`` routes to the fused
    kernel, in forward order, for input frames ``[batch, H, W, 3]`` (``imgsz``
    is ``H = W`` or ``(H, W)``).

    Found by one forward of a copy of the model on the meta device, which
    computes shapes only.
    """
    meta = copy.deepcopy(model).to("meta").eval()
    sites: List[Tuple[int, int, int]] = []
    for mod in meta.modules():
        if isinstance(mod, B.QAttention):
            mod.fused_attn = False
        if isinstance(mod, C.Conv) and mod.fused:
            mod.fused = False  # the kernels do not run on meta tensors
            mod.register_forward_pre_hook(lambda m, args: sites.append(
                (m.conv.cin, m.conv.cout, args[0].shape[0] * args[0].shape[1] * args[0].shape[2])))
    with torch.no_grad():
        h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
        meta(torch.empty(batch, h, w, 3, device="meta"))
    return sites
