"""Model config -> PyTorch model, and the task model (counterpart of the JAX ``models/tasks.py``).

`parse_model` repeats the reference's channel bookkeeping
(ultralytics/nn/tasks.py:942-1098) for the modules the QUAN configs use and
gives a static layer spec; `QUANYOLO` builds one module per layer into
``model`` (so state names read ``model.10.m0.attn.qkv.w``, the JAX package's
flax path ``model_10/m0/attn/qkv/w``) and walks the skip-connection save
list in ``forward``. Only the plain graph is ported: the JAX package's
``stem_s2d`` / ``stem_deep`` are TPU layout rewrites of the same math.
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

SCALE_RE = re.compile(r"yolo\d+([nslmx])")


# `fused_1x1` by default: on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 35),
# QUAN-YOLO11n-OBB's infer @1024, batch 8, takes 8.96 ms of device time with the
# fused 1x1 kernel at its 37 sites against 10.09 without in bf16, and 14.99 against
# 17.21 in f32, in 1,382 device operations against 1,678 (phase 4); the JAX
# package's QUAN_FUSED_1X1 is off by default. It acts in eval only.
FUSED_1X1 = True


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


def build_layer(spec: LayerSpec, dtype: Optional[torch.dtype], mapping_type: str, impl: str,
                fused_attn: bool, fused_1x1: bool) -> nn.Module:
    """The module of one layer spec."""
    m, a = spec.module, spec.args
    kw = dict(dtype=dtype, impl=impl, fused_1x1=fused_1x1)
    if m == "Conv":
        return C.Conv(*a, mapping_type=mapping_type, **kw)
    if m == "DWConv":
        return C.DWConv(*a, **kw)
    if m in ("C3k2", "QC3k2"):
        return B.C3k2(*a, **kw)
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
    logits for Classify."""

    def __init__(self, specs: Sequence[LayerSpec], save: Sequence[int],
                 dtype: Optional[torch.dtype] = None, mapping_type: str = "poincare",
                 impl: str = "auto", fused_attn: bool = True, fused_1x1: bool = FUSED_1X1):
        super().__init__()
        self.specs, self.save = tuple(specs), tuple(save)
        self.dtype = dtype
        self.model = nn.ModuleList(
            build_layer(s, dtype, mapping_type, impl, fused_attn, fused_1x1) for s in self.specs)

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
        for spec, layer in zip(self.specs, self.model):
            inputs = [y if j == -1 else saved[j] for j in spec.f]
            y = layer(inputs if spec.module in _HEADS or spec.module == "Concat" else inputs[0])
            if spec.i in self.save:
                saved[spec.i] = y
            if capture is not None and isinstance(y, torch.Tensor):
                capture[spec.i] = y
            if spec.i == upto:
                break
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
                  seed: int = 0, int8_min_c: int = 0) -> "DetectionModel":
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
        """
        dev = resolve_device(device)
        cfg, scale = resolve_model_cfg(model)
        m = cls(cfg, scale, nc, dtype=dtype, mapping_type=mapping_type, impl=impl,
                fused_attn=fused_attn, fused_1x1=fused_1x1)
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
