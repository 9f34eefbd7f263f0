"""The port's CUDA kernels against their plain versions on the card.

K1 (fused attention forward), K2 (its backward) and K3 (fused 1x1
Conv+IQBN+SiLU) at the main path's shapes (yolo11n-obb-quan at imgsz 1024,
batch 8), as in chip_smoke.py; and the attention's autograd Function. Then
the validation path at a small size: the image reader's fixtures decoded by
the card machine's build of the C++ reader, the Validator on the card
against the CPU, one epoch of ``Trainer.fit``, and the prefetcher's upload
across changes of shape. Last the detect task (yolo11n-quan, nc = 80): K1
and K2 at the N values of rect batches at 640, K3 at the detect model's
sites at 640, the detect Predictor and Validator (rect off and on) on the
card against the CPU, and one fit epoch; and the segment and pose tasks
(yolo11n-seg-quan, nc = 80; yolo11n-pose-quan, nc = 1): their Predictor and
Validator (masks at proto and input resolution, OKS) on the card against the
CPU, one augmenting fit epoch each, and a train step at 640 (K2 at N = 400).
Then the classification slice: K1 and K2 at N = 49 (yolo11n-cls-quan at
224), K3 at that model's sites (the Classify conv channel-tiled), and one
Q-WRN-16-2 f32 step on the card against the CPU. Last the registered
operators ``quan_torch::qattention_fwd`` and ``quan_torch::qconv1x1_fused``
(called directly and under ``torch.export``), an exported OBB graph on the
card against the live model, and ``YOLO.embed`` and ``YOLO.track`` on the
card against the CPU. This file imports no JAX, so it runs on a machine that has a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card every test skips. f32 runs with TF32 off; the tolerances are
stated per dtype. K1 is held to its step-by-step plain version at the TPU
kernel's rounding points (`qattn.FWD_TOL`) and, as before, to the einsum path
run in f32 on the same values (``_TOL``: in bf16, K1 rounds ``scale * q`` and
the softmax numerator to bf16 where that path in f32 does not).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from quan_ultralytics_tpu_torch.data import YOLODataset, build_dataloader
from quan_ultralytics_tpu_torch.data.native.native import imread, imwrite_png
from quan_ultralytics_tpu_torch.engine.predictor import Results
from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
from quan_ultralytics_tpu_torch.engine.validator import Validator
from quan_ultralytics_tpu_torch.models.block import QAttention
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites
from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-2, 2e-2)}  # K1; K3: qconv_fused.K3_TOL


@pytest.fixture
def cuda():
    """The card, or a skip: these tests hold a CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref, rtol, atol, msg=""):
    """``|got - ref| <= rtol |ref| + atol max(1, max|ref|)`` elementwise."""
    got, ref = got.float(), ref.float()
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol * scale, msg=msg)


def _inputs(cuda, dtype, n, seed, batch=8, dk=2, dv=4, heads=8):
    """q, k, v and a cotangent dO of the attention, ``[batch, 4, heads, n, d]``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(batch, 4, heads, n, dk, generator=g, device=cuda).to(dtype) for _ in range(2))
    v, do = (torch.randn(batch, 4, heads, n, dv, generator=g, device=cuda).to(dtype) for _ in range(2))
    return q, k, v, do


def _k1_counts():
    return qattn.launches, qattn.launches_mma, qattn.launches_simt


def _k1_meets_fwd_tol(q, k, v, scale, msg):
    """K1 (one launch of the kernel of its dtype) against
    `qattn.qattention_fwd_plain` within `qattn.FWD_TOL`."""
    dtype = q.dtype
    before = _k1_counts()
    got = qattn.qattention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    own = (1, 1, 0) if dtype == torch.bfloat16 else (1, 0, 1)  # all, tensor cores, CUDA cores
    assert tuple(a - b for a, b in zip(_k1_counts(), before)) == own
    ref = qattn.qattention_fwd_plain(q, k, v, scale)
    assert got.dtype == dtype and got.shape == ref.shape
    err, rel, ok = qattn.kernel_error(got, ref, dtype, qattn.FWD_TOL)
    assert ok, f"{msg} {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 400, 200, 77])
def test_qattn_kernel_matches_plain_on_card(cuda, dtype, n):
    """K1 at the main path's widths against the plain version at the TPU
    kernel's rounding points (`qattn.FWD_TOL`; in bf16 the f32 forward of the
    same inputs misses it), and against the einsum path in f32 (``_TOL``)."""
    q, k, v, _ = _inputs(cuda, dtype, n, n)
    scale = 2 ** -0.5
    before = qattn.launches
    got = qattn.qattention_fused(q, k, v, scale)
    torch.cuda.synchronize()
    assert qattn.launches == before + 1
    ref = qattn.qattention_plain(q.float(), k.float(), v.float(), scale)
    _assert_close(got, ref, *_TOL[dtype])
    _k1_meets_fwd_tol(q, k, v, scale, f"N={n}")
    if dtype == torch.bfloat16:
        f32 = qattn.qattention_fwd_plain(q.float(), k.float(), v.float(), scale)
        assert not qattn.kernel_error(f32, qattn.qattention_fwd_plain(q, k, v, scale), dtype,
                                      qattn.FWD_TOL)[2], "the f32 forward meets the bf16 tolerance"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qattn_kernel_one_group_on_card(cuda, dtype):
    """G = 1 (one batch element, one component, one head), N = 1024."""
    q, k, v, _ = (t[:1, :1, :1] for t in _inputs(cuda, dtype, 1024, 6, batch=1))
    _k1_meets_fwd_tol(q, k, v, 0.5, "G=1")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [200, 77])
@pytest.mark.parametrize("dk,dv", sorted(qattn.SUPPORTED))
def test_qattn_kernel_every_width_on_card(cuda, dk, dv, n, dtype):
    """K1 at every (dk, dv) it is built for, at ragged N (no 16- or 32-key
    block divides it): the bf16 kernel's fragments and staged rows change with
    the widths, which the larger models' attention uses."""
    q, k, v, _ = _inputs(cuda, dtype, n, 100 * dk + dv + 1, batch=2, dk=dk, dv=dv, heads=2)
    _k1_meets_fwd_tol(q, k, v, dk ** -0.5, f"dk={dk} dv={dv} N={n}")


@pytest.mark.parametrize("n", [1024, 1100])
@pytest.mark.parametrize("dk,dv", [(8, 16), (16, 32), (32, 32)])
def test_qattn_kernel_key_tiles_on_card(cuda, dk, dv, n):
    """The bf16 K1 where a group's staged keys and values pass 48 KB (the
    larger models' widths at imgsz 1024), so it stages them in tiles, once per
    pass: N = 1,100 ends in a partial tile and a ragged step."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, n, 7 * dk + dv, batch=1, dk=dk, dv=dv, heads=2)
    _k1_meets_fwd_tol(q, k, v, dk ** -0.5, f"dk={dk} dv={dv} N={n}")


def test_qattn_bf16_is_deterministic_on_card(cuda):
    """No atomics: two runs of the bf16 K1 give bitwise the same output and row
    statistics."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, 1024, 8)
    runs = []
    for _ in range(2):
        stats = qattn.new_stats(q)
        runs.append((qattn.qattention_fwd(q, k, v, 0.5, stats), stats))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def _k2(q, k, v, do, scale):
    """K2 given the statistics K1 writes for it."""
    stats = qattn.new_stats(q)
    qattn.qattention_fwd(q, k, v, scale, stats)
    return qattn.qattention_bwd(q, k, v, do, scale, stats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 400, 200, 77])
def test_qattn_bwd_kernel_matches_plain_on_card(cuda, dtype, n):
    """K2 (given K1's row statistics) against the plain backward, which keeps
    its rounding points, within `qattn.BWD_TOL`; in bf16 the f32 gradients of
    the same inputs miss it."""
    q, k, v, do = _inputs(cuda, dtype, n, n + 1)
    scale = 2 ** -0.5
    before = qattn.launches_bwd
    got = _k2(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert qattn.launches_bwd == before + 1
    ref = qattn.qattention_bwd_plain(q, k, v, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        err, rel, ok = qattn.kernel_error(a, b, dtype, qattn.BWD_TOL)
        assert ok, f"{name} N={n} {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"
    if dtype == torch.bfloat16:
        f32 = qattn.qattention_bwd_plain(q.float(), k.float(), v.float(), do.float(), scale)
        for name, a, b in zip(("dq", "dk", "dv"), f32, ref):
            assert not qattn.kernel_error(a, b, dtype, qattn.BWD_TOL)[2], \
                f"the f32 {name} meets the bf16 tolerance"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qattn_bwd_kernel_one_group_on_card(cuda, dtype):
    """G = 1 (one batch element, one component, one head), N = 1024."""
    q, k, v, do = (t[:1, :1, :1] for t in _inputs(cuda, dtype, 1024, 5, batch=1))
    got = _k2(q, k, v, do, 0.5)
    ref = qattn.qattention_bwd_plain(q, k, v, do, 0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, rel, ok = qattn.kernel_error(a, b, dtype, qattn.BWD_TOL)
        assert ok, f"{name} {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [200, 77])
@pytest.mark.parametrize("dk,dv", sorted(qattn.SUPPORTED))
def test_qattn_bwd_kernel_every_width_on_card(cuda, dk, dv, n, dtype):
    """K2 at every (dk, dv) it is built for, at ragged N (no 16-row block
    divides it): the bf16 kernel's tiles and fragments change with the widths,
    which the larger models' attention uses."""
    q, k, v, do = _inputs(cuda, dtype, n, 100 * dk + dv, batch=2, dk=dk, dv=dv, heads=2)
    scale = dk ** -0.5
    got = _k2(q, k, v, do, scale)
    ref = qattn.qattention_bwd_plain(q, k, v, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        err, rel, ok = qattn.kernel_error(a, b, dtype, qattn.BWD_TOL)
        assert ok, f"{name} dk={dk} dv={dv} N={n} {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"


def test_qattn_bwd_bf16_is_deterministic_on_card(cuda):
    """dQ is summed as f32 partials per key block in a fixed order (no atomics):
    two runs give bitwise the same gradients."""
    q, k, v, do = _inputs(cuda, torch.bfloat16, 1024, 9)
    a, b = _k2(q, k, v, do, 0.5), _k2(q, k, v, do, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_writes_stats_only_under_grad_on_card(cuda, dtype):
    """K1 writes the row statistics for the backward only when one will follow:
    not under no_grad (nor for inputs that require no grad), and then they
    agree with the plain statistics."""
    q, k, v, _ = _inputs(cuda, dtype, 400, 3, batch=2)
    before = (qattn.launches, qattn.launches_stats)
    with torch.no_grad():
        qattn.qattention_fused(q.requires_grad_(), k, v, 0.5)
    qattn.qattention_fused(q.detach(), k, v, 0.5)
    assert (qattn.launches, qattn.launches_stats) == (before[0] + 2, before[1])
    out = qattn.qattention_fused(q.detach().requires_grad_(), k, v, 0.5)
    assert qattn.launches_stats == before[1] + 1
    stats = out.grad_fn.saved_tensors[3]
    ref = qattn.qattention_stats_plain(q.detach(), k, 0.5)
    torch.testing.assert_close(stats, ref, rtol=1e-5, atol=1e-5)


def test_qattention_function_matches_autograd_of_plain(cuda):
    """The Function (K1 forward, K2 backward) against autograd of the plain
    einsum + softmax path, f32, at dk=4, dv=8 and a ragged N."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k = (torch.randn(2, 4, 3, 150, 4, generator=g, device=cuda, requires_grad=True)
            for _ in range(2))
    v = torch.randn(2, 4, 3, 150, 8, generator=g, device=cuda, requires_grad=True)
    do = torch.randn(2, 4, 3, 150, 8, generator=g, device=cuda)
    got = torch.autograd.grad(qattn.qattention_fused(q, k, v, 0.5), (q, k, v), do)
    ref = torch.autograd.grad(qattn.qattention_plain(q, k, v, 0.5), (q, k, v), do)
    for a, b in zip(got, ref):
        _assert_close(a, b, 1e-4, 1e-5)


def test_attention_backward_reaches_qkv_on_card(cuda):
    """A backward through the CUDA QAttention module gives qkv.w a finite,
    non-zero gradient equal to the plain path's: the attention's output
    carries its gradient back through K2."""
    torch.manual_seed(0)
    fused = QAttention(128, 8, 0.5, fused_attn=True).to(cuda)
    plain = QAttention(128, 8, 0.5, fused_attn=False).to(cuda)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 8, 16, 4, 32, device=cuda)
    grads = []
    for mod in (fused, plain):
        (mod(x) ** 2).sum().backward()
        grads.append(mod.qkv.w.grad)
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0
    _assert_close(grads[0], grads[1], 1e-4, 1e-5)


def _k3_case(cuda, dtype, ci, co, p, g):
    """K3 against its plain version, with and without SiLU; each dtype launches
    its own kernel (bf16: tensor cores, f32: CUDA cores)."""
    x = torch.randn(p, 1, 1, 4, ci, generator=g, device=cuda).to(dtype)
    w = torch.randn(4, co, ci, 1, 1, generator=g, device=cuda) / math.sqrt(ci)
    scale = torch.rand(4, co, generator=g, device=cuda) + 0.5
    shift = torch.randn(4, co, generator=g, device=cuda) * 0.1
    own = (1, 1, 0) if dtype == torch.bfloat16 else (1, 0, 1)  # all, tensor cores, CUDA cores

    def counts():
        return qconv_fused.launches, qconv_fused.launches_mma, qconv_fused.launches_simt

    for silu in (True, False):
        before = counts()
        got = qconv_fused.qconv1x1_fused(x, w, scale, shift, apply_silu=silu)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == own
        ref = qconv_fused.qconv1x1_fused_plain(x, w, scale, shift, apply_silu=silu)
        assert got.dtype == dtype and got.shape == ref.shape
        _assert_close(got, ref, *qconv_fused.K3_TOL[dtype], msg=f"Ci={ci} Co={co} P={p} silu={silu}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv1x1_kernel_matches_plain_on_card(cuda, dtype):
    """K3 at the 21 (Ci, Co, P) shapes of the n model's fused sites at batch 8 @ 1024."""
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu", fused_1x1=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    for ci, co, p in sorted(set(fused_1x1_sites(model, 8, 1024))):
        _k3_case(cuda, dtype, ci, co, p, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv1x1_kernel_ragged_tile_on_card(cuda, dtype):
    """P = 1,000 pixels (no tile size divides it) at every (Ci, Co) of the sites."""
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu", fused_1x1=True)
    g = torch.Generator(device=cuda).manual_seed(1)
    for ci, co in sorted({(ci, co) for ci, co, _ in fused_1x1_sites(model, 8, 1024)}):
        _k3_case(cuda, dtype, ci, co, 1000, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv1x1_kernel_wider_models_on_card(cuda, dtype):
    """Every (Ci, Co) of the s, m, l and x models' fused sites at P = 1,000: the
    bf16 kernel splits Co into channel tiles where its weights pass one block's
    budget (Ci = 256, Co = 128 and wider)."""
    shapes = set()
    for scale in "smlx":
        model = DetectionModel.from_yaml(f"yolo11{scale}-obb-quan.yaml", nc=15, device="cpu",
                                         fused_1x1=True)
        shapes |= {(ci, co) for ci, co, _ in fused_1x1_sites(model, 8, 1024)}
    assert (256, 128) in shapes and (384, 192) in shapes
    g = torch.Generator(device=cuda).manual_seed(2)
    for ci, co in sorted(shapes):
        _k3_case(cuda, dtype, ci, co, 1000, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", [(7, 3), (13, 10), (6, 5), (10, 12), (200, 99), (256, 100)])
def test_qconv1x1_kernel_odd_widths_on_card(cuda, dtype, ci, co):
    """Widths no model has: odd Ci or Co, Ci not a multiple of 4, Co not a
    multiple of 8, and Co split into channel tiles of which the last is odd
    (Co = 99) or not a multiple of 8 (Co = 100), at a ragged P."""
    _k3_case(cuda, dtype, ci, co, 999, torch.Generator(device=cuda).manual_seed(ci * co))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 16, 3, device=cuda)  # dk = 3 is not instantiated
    with pytest.raises(ValueError, match="dk, dv"):
        qattn.qattention_fused(q, q, q, 1.0)
    x = torch.zeros(1, 2, 2, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qconv_fused.qconv1x1_fused(x, torch.zeros(4, 8, 8, device=cuda))


# ---------------------------------------------------------------- validation and fit on the card


FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.mark.parametrize("name", ["jpeg_420_q90_rst", "jpeg_422_q75_odd", "jpeg_gray_q95"])
def test_reader_fixtures_on_the_cards_machine(cuda, name):
    """The committed JPEGs decode to their committed OpenCV pixels with the C++
    reader built on the card's machine, and the PNG writer's files read back."""
    got = imread(FIXTURES / f"{name}.jpg")
    assert np.array_equal(got, np.load(FIXTURES / f"{name}.npy"))


def test_png_roundtrip_on_the_cards_machine(cuda, tmp_path):
    im = np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    imwrite_png(tmp_path / "a.png", im)
    assert np.array_equal(imread(tmp_path / "a.png"), im)


def _obb_set(root, n=6, size=128, nc=15, seed=0):
    """n PNG images with 2-6 filled rotated rectangles each and their labels."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            im = np.full((size, size, 3), 40, np.uint8)
            lines = []
            for _ in range(int(rng.integers(2, 7))):
                cx, cy = rng.uniform(0.25, 0.75, 2) * size
                w, h = rng.uniform(0.1, 0.3, 2) * size
                t = rng.uniform(0, math.pi)
                c, s = math.cos(t), math.sin(t)
                pts = np.array([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                                for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))])
                yy, xx = np.mgrid[0:size, 0:size]
                u = (xx - cx) * c + (yy - cy) * s
                v = -(xx - cx) * s + (yy - cy) * c
                im[(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = rng.integers(60, 256, 3)
                lines.append(" ".join([str(rng.integers(0, nc))] + [f"{x:.6f}" for x in (pts / size).reshape(-1)]))
            imwrite_png(root / "images" / split / f"im{i}.png", im)
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "train": "images/train", "val": "images/val",
            "names": {i: f"c{i}" for i in range(nc)}}


def _kept(val, ds, device):
    """Per image, the kept detections (xywhr, conf, cls in letterbox pixels) of
    ``val``'s device pass on the loader's batches."""
    out = []
    for batch in build_dataloader(ds, 4, 128, hyp=None, augment=False, shuffle=False, drop_last=False,
                                  with_meta=True):
        det, ok, _ = val.infer(torch.from_numpy(batch["img"]).to(device))
        out += [det[b][ok[b]].cpu().numpy() for b in range(batch["n_real"])]
    return out


def test_validator_on_card_matches_the_cpu(cuda, tmp_path):
    """The Validator on the card (K1 in f32 on the CUDA cores, TF32 off) against
    the same weights on the CPU (the plain attention). The QER biases are drawn
    N(0, 1) so that the random model's scores spread, and each image is also
    labelled with the CPU model's top 4 detections, so that boxes are kept and
    matched. Per image, the same number of kept detections and every kept row
    within 1e-4 of max(1, |value|) of a row of the other (near-equal scores may
    swap neighbours); then the metrics within 1e-3, mAP50 above 0."""
    from quan_ultralytics_tpu_torch.models.head import QER

    cfg = _obb_set(tmp_path)
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device=cuda)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, QER):
                mod.proj.bias.copy_(torch.randn(mod.proj.bias.shape, generator=gen))
    cpu = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    val, ref_val = Validator(model, imgsz=128), Validator(cpu, imgsz=128)
    # 128 x 128 images at imgsz 128: letterbox pixels are source pixels
    for i, d in enumerate(_kept(ref_val, YOLODataset(cfg, "val", task="obb"), "cpu")):
        assert len(d) >= 4, f"image {i}: the CPU model keeps {len(d)} detections"
        with open(tmp_path / "labels" / "val" / f"im{i}.txt", "a") as fh:
            for x, y, w, h, t, _, c in d[:4]:
                c_, s_ = math.cos(t), math.sin(t)
                pts = [(x + dx * c_ - dy * s_, y + dx * s_ + dy * c_)
                       for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))]
                fh.write(" ".join([str(int(c))] + [f"{v / 128:.6f}" for p in pts for v in p]) + "\n")
    ds = YOLODataset(cfg, "val", task="obb")
    before = qattn.launches_simt
    got = val(ds, batch_size=4)
    assert qattn.launches_simt - before == 2  # one K1 launch a batch
    ref = ref_val(ds, batch_size=4)
    for i, (g, r) in enumerate(zip(_kept(val, ds, cuda), _kept(ref_val, ds, "cpu"))):
        assert len(g) == len(r) > 0, f"image {i}: {len(g)} vs {len(r)} kept"
        worst = (np.abs(g[:, None, :] - r[None, :, :]) / np.maximum(1.0, np.abs(r[None, :, :]))).max(-1)
        assert worst.min(1).max() <= 1e-4 and worst.min(0).max() <= 1e-4, f"image {i}"
    assert ref["mAP50"] > 0
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])


def test_fit_epoch_on_card(cuda, tmp_path):
    """One epoch of Trainer.fit on the card in bf16 (K1 and K2 every micro-step),
    validating the EMA weights: finite loss, checkpoints written, the
    training weights back after validation."""
    cfg = _obb_set(tmp_path / "data")
    tds, vds = YOLODataset(cfg, "train", task="obb"), YOLODataset(cfg, "val", task="obb")
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=torch.bfloat16, device=cuda)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2, epochs=1, warmup_epochs=0), steps_per_epoch=3,
                 device=cuda)
    val = Validator(model, imgsz=128)

    def validate(trainer):
        with trainer.ema_weights():
            return val(vds, batch_size=2)

    k1, k2 = qattn.launches_stats, qattn.launches_bwd
    history = tr.fit(lambda e: build_dataloader(tds, 2, 128, hyp=None, augment=False, seed=e),
                     validate, save_dir=tmp_path / "run", log=lambda s: None)
    assert qattn.launches_stats - k1 == 3 and qattn.launches_bwd - k2 == 3
    assert math.isfinite(history[0]["loss"]) and tr.opt.count == 3
    assert all(0 <= history[0][k] <= 1 for k in ("mAP50", "mAP50-95"))
    assert (tmp_path / "run" / "last.ckpt").exists() and (tmp_path / "run" / "best.ckpt").exists()


def test_augmenting_fit_epoch_on_card(cuda, tmp_path):
    """One epoch of Trainer.fit at imgsz 256 on batches of the train
    augmentations (the default AugmentHyp: mosaic, warp, HSV, flips), 2
    micro-steps: finite loss, K1 with statistics and K2 once a micro-step."""
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp

    cfg = _obb_set(tmp_path / "data", n=4, size=256)
    tds = YOLODataset(cfg, "train", task="obb")
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=torch.bfloat16, device=cuda)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2, epochs=1, warmup_epochs=0), steps_per_epoch=2,
                 device=cuda)
    k1, k2 = qattn.launches_stats, qattn.launches_bwd
    batches = []

    def loader(epoch):
        for batch in build_dataloader(tds, 2, 256, hyp=AugmentHyp(), augment=True, seed=epoch):
            batches.append(int(batch["mask"].sum()))
            yield batch

    history = tr.fit(loader, None, save_dir=tmp_path / "run", log=lambda s: None)
    assert len(batches) == 2 and sum(batches) > 0
    assert qattn.launches_stats - k1 == 2 and qattn.launches_bwd - k2 == 2
    assert math.isfinite(history[0]["loss"]) and tr.opt.count == 2


def test_prefetch_on_card(cuda):
    """prefetch_to_device on the card: every batch comes out on the device equal
    to the host's, across changes of shape (as multi-scale gives), and each
    batch is still right when all are read at the end; file lists pass through."""
    from quan_ultralytics_tpu_torch.parallel.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    sizes = (256, 320, 384)
    host = [{"img": rng.integers(0, 256, (8, s, s, 3), dtype=np.uint8),
             "bboxes": rng.normal(size=(8, 128, 5)).astype(np.float32),
             "mask": rng.random((8, 128)) < 0.5, "im_files": [f"im{i}.png"]}
            for i, s in enumerate(sizes * 4)]
    got = list(prefetch_to_device(iter(host), cuda, size=2))
    assert len(got) == len(host)
    torch.cuda.synchronize()
    for g, h in zip(got, host):
        assert g["im_files"] == h["im_files"]
        for k in ("img", "bboxes", "mask"):
            assert g[k].is_cuda and torch.equal(g[k].cpu(), torch.from_numpy(h[k])), k


# ---------------------------------------------------------------- the detect task at 640


# the attention's N at layer 10 under rect validation at 640 (reference
# set_rectangle, half-stride pad): 640 x 480 frames -> 512 x 672 (N = 16 x 21),
# 640 x 427 -> 448 x 672 (14 x 21); 300 and 280 are ragged in both kernels' tiles
RECT_N = (336, 294, 300, 280)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", RECT_N)
def test_qattn_kernels_at_rect_sizes_on_card(cuda, dtype, n):
    """K1 within `qattn.FWD_TOL` and K2 within `qattn.BWD_TOL` of their plain
    versions at the N values that rect batches at 640 give, batch 8."""
    q, k, v, do = _inputs(cuda, dtype, n, n + 7)
    scale = 2 ** -0.5
    _k1_meets_fwd_tol(q, k, v, scale, f"N={n}")
    before = qattn.launches_bwd
    got = _k2(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert qattn.launches_bwd == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, qattn.qattention_bwd_plain(q, k, v, do, scale)):
        err, rel, ok = qattn.kernel_error(a, b, dtype, qattn.BWD_TOL)
        assert ok, f"{name} N={n} {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv1x1_kernel_at_the_detect_sites_on_card(cuda, dtype):
    """K3 at every (Ci, Co, P) of yolo11n-quan's fused sites (nc = 80), batch 8
    at 640 x 640 and in a 512 x 672 rect batch."""
    model = DetectionModel.from_yaml("yolo11n-quan.yaml", nc=80, device="cpu", fused_1x1=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    shapes = set(fused_1x1_sites(model, 8, 640)) | set(fused_1x1_sites(model, 8, (512, 672)))
    for ci, co, p in sorted(shapes):
        _k3_case(cuda, dtype, ci, co, p, g)


def _detect_set(root, n=6, sizes=((96, 128), (128, 96), (128, 128)), nc=80, seed=0):
    """n PNG images of the given (h, w) sizes with 2-6 filled rectangles each
    and their 'cls xc yc w h' labels."""
    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        im = np.full((h, w, 3), 40, np.uint8)
        lines = []
        for _ in range(int(rng.integers(2, 7))):
            bw, bh = rng.uniform(0.1, 0.4, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            im[int((cy - bh / 2) * h):int((cy + bh / 2) * h), int((cx - bw / 2) * w):int((cx + bw / 2) * w)] = \
                rng.integers(60, 256, 3)
            lines.append(f"{rng.integers(0, nc)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        imwrite_png(root / "images" / "val" / f"im{i}.png", im)
        (root / "labels" / "val" / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "train": "images/val", "val": "images/val",
            "names": {i: f"c{i}" for i in range(nc)}}


def test_detect_predictor_and_validator_on_card_match_the_cpu(cuda, tmp_path):
    """yolo11n-quan (nc = 80) in f32 on the card (K1 on the CUDA cores, TF32 off)
    against the same weights on the CPU (the plain attention), the QER biases
    drawn N(0, 1) so that scores spread: the Predictor keeps the same boxes per
    frame (xyxy, conf, cls within 1e-4 of max(1, |value|) of a row of the
    other); the Validator, with rect off and on, launches K1 once a batch and
    gives the CPU's metrics within 1e-3."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.head import QER

    cfg = _detect_set(tmp_path)
    model = DetectionModel.from_yaml("yolo11n-quan.yaml", nc=80, device=cuda)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, QER):
                mod.proj.bias.copy_(torch.randn(mod.proj.bias.shape, generator=gen))
    cpu = DetectionModel.from_yaml("yolo11n-quan.yaml", nc=80, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    frames = [imread(tmp_path / "images" / "val" / f"im{i}.png") for i in range(3)]
    got, ref = (Predictor(m, imgsz=128, conf=0.05)(frames) for m in (model, cpu))
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0 and g.boxes.shape[1] == 6
        worst = (np.abs(g.boxes[:, None] - r.boxes[None]) / np.maximum(1.0, np.abs(r.boxes[None]))).max(-1)
        assert worst.min(1).max() <= 1e-4 and worst.min(0).max() <= 1e-4
    ds = YOLODataset(cfg, "val")
    for rect in (False, True):
        before = qattn.launches_simt
        metrics = Validator(model, imgsz=128)(ds, batch_size=4, rect=rect)
        assert qattn.launches_simt - before == 2  # one K1 launch a batch
        ref_metrics = Validator(cpu, imgsz=128)(ds, batch_size=4, rect=rect)
        for k in ref_metrics:
            assert abs(metrics[k] - ref_metrics[k]) <= 1e-3, (rect, k, metrics[k], ref_metrics[k])


def test_detect_fit_epoch_on_card(cuda, tmp_path):
    """One epoch of Trainer.fit of yolo11n-quan on the card in bf16 at 128 (K1
    and K2 every micro-step), validating the EMA weights: finite loss, metrics
    in [0, 1], checkpoints written."""
    cfg = _detect_set(tmp_path / "data")
    ds = YOLODataset(cfg, "val")
    model = DetectionModel.from_yaml("yolo11n-quan.yaml", nc=80, dtype=torch.bfloat16, device=cuda)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2, epochs=1, warmup_epochs=0), steps_per_epoch=3,
                 device=cuda)
    val = Validator(model, imgsz=128)

    def validate(trainer):
        with trainer.ema_weights():
            return val(ds, batch_size=2)

    k1, k2 = qattn.launches_stats, qattn.launches_bwd
    history = tr.fit(lambda e: build_dataloader(ds, 2, 128, hyp=None, augment=False, seed=e),
                     validate, save_dir=tmp_path / "run", log=lambda s: None)
    assert qattn.launches_stats - k1 == 3 and qattn.launches_bwd - k2 == 3
    assert math.isfinite(history[0]["loss"]) and tr.opt.count == 3
    assert all(0 <= history[0][k] <= 1 for k in ("mAP50", "mAP50-95"))
    assert (tmp_path / "run" / "last.ckpt").exists() and (tmp_path / "run" / "best.ckpt").exists()


# ---------------------------------------------------------------- the segment and pose tasks

SEGPOSE = {"segment": ("yolo11n-seg-quan.yaml", 80), "pose": ("yolo11n-pose-quan.yaml", 1)}
MASK_PIXEL_SHARE = 1e-3  # mask pixels that may flip at 0.5 between two summation orders


def _segpose_set(root, task, n=6, sizes=((96, 128), (128, 96), (128, 128)), seed=0):
    """n PNG images with 2-6 filled rectangles each, labelled as 8-point
    polygons (segment, 80 classes) or as figures of 17 keypoints inside them,
    mixed visibility (pose, one class)."""
    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    nc = SEGPOSE[task][1]
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        im = np.full((h, w, 3), 40, np.uint8)
        lines = []
        for _ in range(int(rng.integers(2, 7))):
            bw, bh = rng.uniform(0.1, 0.4, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            im[int((cy - bh / 2) * h):int((cy + bh / 2) * h), int((cx - bw / 2) * w):int((cx + bw / 2) * w)] = \
                rng.integers(60, 256, 3)
            if task == "segment":
                t = np.arange(8) * np.pi / 4
                vals = np.stack([cx + np.cos(t) * bw / 2, cy + np.sin(t) * bh / 2], 1).reshape(-1)
            else:
                k = np.stack([rng.uniform(cx - bw / 2, cx + bw / 2, 17), rng.uniform(cy - bh / 2, cy + bh / 2, 17),
                              rng.integers(0, 3, 17)], 1)
                vals = [cx, cy, bw, bh, *k.reshape(-1)]
            lines.append(" ".join([str(rng.integers(0, nc))] + [f"{v:.6f}" for v in vals]))
        imwrite_png(root / "images" / "val" / f"im{i}.png", im)
        (root / "labels" / "val" / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "train": "images/val", "val": "images/val",
            "names": {i: f"c{i}" for i in range(nc)}}


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_segpose_predictor_and_validator_on_card_match_the_cpu(cuda, tmp_path, task):
    """yolo11n-seg-quan (nc = 80) and yolo11n-pose-quan (nc = 1) in f32 on the
    card (K1 on the CUDA cores, TF32 off) against the same weights on the CPU,
    the QER biases drawn N(0, 1): the Predictor keeps the same boxes per frame
    (xyxy, conf, cls within 1e-4 of max(1, |value|) of a row of the other), with
    the matched row's keypoints within 1e-4 of max(1, |value|) or its mask
    unequal on at most 1e-3 of the frame's pixels; the Validator (segment:
    ``mask_native`` off and on) launches K1 once a batch and gives the CPU's
    box and mask or OKS metrics within 1e-3."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models.head import QER

    name, nc = SEGPOSE[task]
    cfg = _segpose_set(tmp_path, task)
    model = DetectionModel.from_yaml(name, nc=nc, device=cuda)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, QER):
                mod.proj.bias.copy_(torch.randn(mod.proj.bias.shape, generator=gen))
    cpu = DetectionModel.from_yaml(name, nc=nc, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    frames = [imread(tmp_path / "images" / "val" / f"im{i}.png") for i in range(3)]
    got, ref = (Predictor(m, imgsz=128, conf=0.05)(frames) for m in (model, cpu))
    unequal = total = 0
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0 and g.boxes.shape[1] == 6
        worst = (np.abs(g.boxes[:, None] - r.boxes[None]) / np.maximum(1.0, np.abs(r.boxes[None]))).max(-1)
        assert worst.min(1).max() <= 1e-4 and worst.min(0).max() <= 1e-4
        match = worst.argmin(1)
        if task == "pose":
            k = np.abs(g.keypoints - r.keypoints[match]) / np.maximum(1.0, np.abs(r.keypoints[match]))
            assert k.max() <= 1e-4
        else:
            assert g.masks.shape == r.masks.shape and g.masks.any()
            unequal += int((g.masks != r.masks[match]).sum())
            total += g.masks.size
    assert unequal <= MASK_PIXEL_SHARE * max(total, 1)
    ds = YOLODataset(cfg, "val", task=task)
    for native in ((False, True) if task == "segment" else (False,)):
        before = qattn.launches_simt
        metrics = Validator(model, imgsz=128)(ds, batch_size=4, mask_native=native)
        assert qattn.launches_simt - before == 2  # one K1 launch a batch
        ref_metrics = Validator(cpu, imgsz=128)(ds, batch_size=4, mask_native=native)
        assert len(ref_metrics) == 6
        for k in ref_metrics:
            assert abs(metrics[k] - ref_metrics[k]) <= 1e-3, (native, k, metrics[k], ref_metrics[k])


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_segpose_fit_epoch_on_card(cuda, tmp_path, task):
    """One epoch of Trainer.fit of each model on the card in bf16 at 128 (K1 and
    K2 every micro-step) through the augmenting loader (segment: mosaic; pose:
    the photometric list, HSV and flips), validating the EMA weights: finite
    loss, metrics in [0, 1], checkpoints written."""
    from quan_ultralytics_tpu_torch.data.augment import AugmentHyp

    name, nc = SEGPOSE[task]
    cfg = _segpose_set(tmp_path / "data", task)
    ds = YOLODataset(cfg, "val", task=task)
    model = DetectionModel.from_yaml(name, nc=nc, dtype=torch.bfloat16, device=cuda)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2, epochs=1, warmup_epochs=0), steps_per_epoch=3,
                 device=cuda)
    val = Validator(model, imgsz=128)

    def validate(trainer):
        with trainer.ema_weights():
            return val(ds, batch_size=2)

    k1, k2 = qattn.launches_stats, qattn.launches_bwd
    history = tr.fit(lambda e: build_dataloader(ds, 2, 128, hyp=AugmentHyp(), augment=True, seed=e),
                     validate, save_dir=tmp_path / "run", log=lambda s: None)
    assert qattn.launches_stats - k1 == 3 and qattn.launches_bwd - k2 == 3
    assert math.isfinite(history[0]["loss"]) and tr.opt.count == 3
    assert all(0 <= history[0][k] <= 1 for k in history[0] if k.startswith("mAP"))
    assert (tmp_path / "run" / "last.ckpt").exists() and (tmp_path / "run" / "best.ckpt").exists()


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_segpose_train_step_at_640_runs_k2_at_n400_on_card(cuda, task):
    """A bf16 train step of each model at 640 (batch 2): K1 with statistics and
    K2 launch once, on N = 400 tokens at layer 10, and the loss and every
    gradient are finite."""
    name, nc = SEGPOSE[task]
    model = DetectionModel.from_yaml(name, nc=nc, dtype=torch.bfloat16, device=cuda)
    seen = []
    for mod in model.modules():
        if isinstance(mod, QAttention):
            mod.register_forward_pre_hook(lambda _m, a: seen.append(a[0].shape[1] * a[0].shape[2]))
    rng = np.random.default_rng(0)
    M = 6
    batch = {"img": rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8),
             "cls": rng.integers(0, nc, (2, M)).astype(np.int32),
             "bboxes": np.concatenate([rng.uniform(0.3, 0.7, (2, M, 2)), rng.uniform(0.1, 0.3, (2, M, 2))],
                                      -1).astype(np.float32),
             "mask": np.ones((2, M), bool)}
    if task == "segment":
        masks = np.zeros((2, M, 160, 160), np.uint8)
        masks[:, :, 40:120, 40:120] = 1
        batch["masks"] = masks
    else:
        batch["keypoints"] = np.concatenate([rng.uniform(0.3, 0.7, (2, M, 17, 2)),
                                             rng.integers(0, 3, (2, M, 17, 1))], -1).astype(np.float32)
    tr = Trainer(model, TrainConfig(batch=2, nbs=2), steps_per_epoch=1, device=cuda)
    k1, k2 = qattn.launches_stats, qattn.launches_bwd
    loss, aux = tr.step(batch)
    torch.cuda.synchronize()
    assert qattn.launches_stats - k1 == 1 and qattn.launches_bwd - k2 == 1 and seen == [400]
    assert math.isfinite(float(loss)) and float(aux["nan_skipped"]) == 0


# ---------------------------------------------------------------- the classification slice


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qattn_kernels_at_the_classify_n_on_card(cuda, dtype):
    """K1 within `qattn.FWD_TOL` and K2 within `qattn.BWD_TOL` of their plain
    versions at N = 49 (QC2PSA at P5 of yolo11n-cls-quan, 7 x 7 at 224;
    under half of one query block), G = 32 x 8."""
    q, k, v, do = _inputs(cuda, dtype, 49, 49)
    scale = 2 ** -0.5
    _k1_meets_fwd_tol(q, k, v, scale, "N=49")
    before = qattn.launches_bwd
    got = _k2(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert qattn.launches_bwd == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, qattn.qattention_bwd_plain(q, k, v, do, scale)):
        err, rel, ok = qattn.kernel_error(a, b, dtype, qattn.BWD_TOL)
        assert ok, f"{name} N=49 {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv1x1_kernel_at_the_classify_sites_on_card(cuda, dtype):
    """K3 at every (Ci, Co, P) of yolo11n-cls-quan's fused sites at batch 8 @
    224, the Classify conv (Ci = 64, Co = 320 a component: its weights pass
    both kernels' budgets, so Co is split into channel tiles) among them."""
    model = DetectionModel.from_yaml("yolo11n-cls-quan.yaml", device="cpu", fused_1x1=True)
    sites = sorted(set(fused_1x1_sites(model, 8, 224)))
    assert (64, 320, 8 * 7 * 7) in sites
    g = torch.Generator(device=cuda).manual_seed(4)
    for ci, co, p in sites:
        _k3_case(cuda, dtype, ci, co, p, g)


def test_qwrn16_2_step_on_card_matches_the_cpu(cuda):
    """One f32 SGD update of Q-WRN-16-2 (batch 16 at 32, drop 0, TF32 off) on
    the card and on the CPU from the same weights and batch: loss within 1e-5
    relative, every parameter and IQBN statistic after the update within
    1e-4 of its max|value| (cuDNN's and the CPU's summation orders)."""
    from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ClsTrainer

    cfg = ClsConfig(model="qwrn16_2", num_classes=10, dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"img": rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 16).astype(np.int32)}
    runs = []
    for device in ("cpu", cuda):
        tr = ClsTrainer(cfg, steps_per_epoch=10, device=device)
        loss, _ = tr.train_step(batch)
        runs.append((float(loss), {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}))
    (cpu_loss, cpu_state), (card_loss, card_state) = runs
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for name, ref in cpu_state.items():
        _assert_close(card_state[name], ref, 1e-4, 1e-4, msg=name)


# ---------------------------------------------------------------- registered operators, export, embed, track


def test_registered_operators_launch_the_kernels_on_card(cuda):
    """``torch.ops.quan_torch.*`` on CUDA tensors laid out as the wrappers lay
    them out run the launchers (the counters move) and equal the wrappers'
    results; on meta tensors they give shapes."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, 400, 3)
    n0 = qattn.launches
    got = torch.ops.quan_torch.qattention_fwd(q, k, v, 0.5, None)
    assert qattn.launches == n0 + 1
    assert torch.equal(got, qattn.qattention_fwd(q, k, v, 0.5))
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 8, 8, 4, 16, generator=g, device=cuda).bfloat16()
    w = torch.randn(4, 24, 16, generator=g, device=cuda) * 0.1
    sc, sh = torch.rand(4, 24, device=cuda) + 0.5, torch.randn(4, 24, device=cuda) * 0.1
    n0 = qconv_fused.launches
    w16 = w.bfloat16()  # the operator takes the weights in x's dtype (the wrapper casts them)
    got = torch.ops.quan_torch.qconv1x1_fused(x, w16, sc, sh, True)
    assert qconv_fused.launches == n0 + 1 and torch.equal(got, qconv_fused.qconv1x1_fused(x, w, sc, sh))
    meta = torch.ops.quan_torch.qconv1x1_fused(x.to("meta"), w16.to("meta"), sc.to("meta"), sh.to("meta"), True)
    assert meta.shape == (2, 8, 8, 4, 24) and meta.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_obb_graph_on_card_matches_the_live_model(cuda, tmp_path, dtype):
    """yolo11n-obb-quan (nc 15) at 256, batch 2, with K1 and K3 (37 sites):
    the ``.pt2``'s graph calls 1 K1 and 37 K3 operators, launches them when
    run, and its decoded output equals the live model's (the same kernels on
    the same inputs: 0 in f32 and in bf16 up to the order of the ATen ops
    around them, so within qconv_fused.K3_TOL)."""
    from collections import Counter

    from quan_ultralytics_tpu_torch.engine import exporter

    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=dtype, device=cuda, fused_1x1=True)
    path = exporter.export_compiled(model, imgsz=256, batch=2, path=str(tmp_path / "m.pt2"))
    backend = exporter.ExportedBackend(path)
    ops = Counter(str(n.target) for n in backend._fn.graph.nodes if n.op == "call_function")
    assert ops["quan_torch.qattention_fwd.default"] == 1 and ops["quan_torch.qconv1x1_fused.default"] == 37
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    k1, k3 = qattn.launches, qconv_fused.launches
    with torch.inference_mode():
        got = backend(x)
        assert (qattn.launches - k1, qconv_fused.launches - k3) == (1, 37)
        ref = model.decode(model(x))
    _assert_close(got, ref, *qconv_fused.K3_TOL[dtype])


def test_embed_and_track_on_card(cuda, tmp_path):
    """``YOLO.embed`` of yolo11n-quan (nc 80, f32, K1 + K3) at 256 on the card
    against the same weights on the CPU: within 1e-3 of max|ref| (f32 summation
    order, TF32 off). ``YOLO.track`` (ByteTrack, then BoT-SORT) on the card: its
    tracks are those of a fresh tracker fed the card's own detections (and
    frames), array for array."""
    from quan_ultralytics_tpu_torch.engine.model import YOLO
    from quan_ultralytics_tpu_torch.trackers import BOTSORT, BYTETracker
    from quan_ultralytics_tpu_torch.trackers.byte_tracker import STrack

    rng = np.random.default_rng(0)
    frames = []
    for t in range(4):
        im = rng.integers(0, 60, (240, 320, 3), dtype=np.uint8)
        im[40 + 3 * t:120 + 3 * t, 50 + 5 * t:150 + 5 * t] = (230, 30, 40)
        frames.append(im)
    card, cpu = YOLO("yolo11n-quan.yaml", device=cuda), YOLO("yolo11n-quan.yaml", device="cpu")
    got, ref = card.embed(frames, imgsz=256), cpu.embed(frames, imgsz=256)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()
    dets = [r for f in frames for r in card.predict(f, imgsz=256, conf=0.0)]
    conf = dets[0].conf
    kw = dict(track_high_thresh=float(np.quantile(conf, 0.9)), new_track_thresh=float(np.quantile(conf, 0.9)),
              track_low_thresh=float(np.quantile(conf, 0.5)))
    for cls in (BYTETracker, BOTSORT):
        STrack._count = 0
        card._tracker = cls(**kw)
        tracks = card.track(frames, imgsz=256, conf=0.0, persist=True)
        STrack._count = 0
        fresh = cls(**kw)
        again = [fresh.update(d.boxes[:, :4], d.conf, d.cls, **({"frame": f} if cls is BOTSORT else {}))
                 for d, f in zip(dets, frames)]
        assert sum(len(t) for t in tracks) > 0
        assert all(np.array_equal(a, b) for a, b in zip(tracks, again))


def test_predict_save_and_visualize_on_card(cuda, tmp_path):
    """``obb predict save=True visualize=<dir>`` through the CLI on the card
    (QUAN-YOLO11n-OBB, nc 15, seeded f32 weights, imgsz 256): K1 and K3 launch,
    ``im{i}.jpg`` reads back at each frame's size, 23 feature grids an image;
    ``Results.plot`` of the card's rows and two fixed ones gives the same
    pixels and the same JPEG bytes from the frame on the card and on the
    host."""
    from quan_ultralytics_tpu_torch import cli
    from quan_ultralytics_tpu_torch.engine.model import YOLO

    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    for i, (h, w) in enumerate(((240, 320), (256, 200))):
        imwrite_png(src / f"f{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    torch.manual_seed(0)
    pkl = YOLO("yolo11n-obb-quan.yaml", nc=15, device="cpu").export(format="params", path=str(tmp_path / "m.pkl"))
    k1, k3 = qattn.launches, qconv_fused.launches
    assert cli.main(["obb", "predict", f"model={pkl}", f"source={src}", "imgsz=256", "save=True",
                     f"save_dir={tmp_path / 'pred'}", f"visualize={tmp_path / 'vis'}"]) == 0
    assert qattn.launches - k1 == 2 and qconv_fused.launches - k3 == 2 * 37  # predict + the features pass
    for i, hw in enumerate(((240, 320), (256, 200))):
        assert imread(tmp_path / "pred" / f"im{i}.jpg").shape[:2] == hw
        assert len(list((tmp_path / "vis" / f"im{i}").glob("stage*_features.png"))) == 23
    frame = imread(src / "f0.png")
    res = YOLO(pkl, device=cuda).predict(frame, imgsz=256)[0]
    assert res.boxes.shape[1:] == (7,)
    # the rows the card predicted and two fixed ones, drawn on the frame held
    # on the card and on the host: the same pixels
    rows = np.concatenate([res.boxes, np.array([[120, 100, 60, 30, 0.4, 0.91, 3],
                                                [60, 180, 40, 40, -0.2, 0.52, 7]], np.float32)])
    kw = {"orig_shape": frame.shape[:2], "boxes": rows, "names": res.names, "task": "obb"}
    on_card = Results(**kw, orig_img=torch.from_numpy(frame).to(cuda)).plot(tmp_path / "card.jpg")
    on_host = Results(**kw, orig_img=frame).plot(tmp_path / "host.jpg")
    np.testing.assert_array_equal(on_card, on_host)
    assert (tmp_path / "card.jpg").read_bytes() == (tmp_path / "host.jpg").read_bytes()
    assert not np.array_equal(on_host, frame)


def test_reference_weights_infer_on_card_matches_the_plain_path(cuda):
    """A reference-layout state dict of QUAN-YOLO11n-OBB (reference names and
    layouts, drawn with numpy) through ``port_state_dict``: the bf16 model's
    ``infer`` at 1024 with K1 + K3 against the plain path (einsum attention,
    unfused 1x1 convs) on the same dict, within 5e-2 of max|ref| (chip_smoke's
    PRED_TOL in bf16)."""
    from quan_ultralytics_tpu_torch.utils.torch_port import port_state_dict, to_reference_state_dict
    from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables

    fused = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=torch.bfloat16, device=cuda,
                                     fused_1x1=True).eval()
    rng = np.random.default_rng(11)

    def draw(tree):  # the seeded draws of tests/torch_port_helpers.fill_variables
        out = {}
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                out[k] = draw(leaf)
                continue
            shape = leaf.shape
            if k == "w":
                out[k] = rng.uniform(-1, 1, shape) * math.sqrt(3.0 / max(int(np.prod(shape[1:-1])), 1)) / 2
            elif k == "kernel":
                out[k] = rng.uniform(-1, 1, shape) * math.sqrt(3.0 / int(np.prod(shape[:-1])))
            elif k in ("gamma", "var"):
                out[k] = rng.uniform(0.5, 1.5, shape)
            else:
                out[k] = rng.normal(size=shape) * 0.1
        return out

    sd = to_reference_state_dict({c: draw(t) for c, t in export_jax_variables(fused).items()})
    port_state_dict(sd, fused)
    plain = port_state_dict(sd, DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=torch.bfloat16,
                                                         device=cuda, fused_1x1=False)).eval()
    for m in plain.modules():
        if isinstance(m, QAttention):
            m.fused_attn = False
    x = torch.rand(8, 1024, 1024, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    k1, k3 = qattn.launches, qconv_fused.launches
    with torch.inference_mode():
        got = fused.decode(fused(x)).float()
        assert (qattn.launches - k1, qconv_fused.launches - k3) == (1, 37)
        ref = plain.decode(plain(x)).float()
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 5e-2 * float(ref.abs().max())


def test_int8_product_on_card_equals_its_plain_version(cuda, monkeypatch):
    """The int8 serving path's product (`ops.qconv.int8_matmul`: ``torch._int_mm``,
    zero-padded to its rules M > 16 and K, N multiples of 8) against the exact
    float64 product, at every int8 conv of QUAN-YOLO11n-OBB (batch 2 at 256) and
    at odd shapes; and a whole int8 conv on the card against the CPU, bit for bit."""
    from quan_ultralytics_tpu_torch.engine.predictor import Predictor
    from quan_ultralytics_tpu_torch.models import conv as conv_mod
    from quan_ultralytics_tpu_torch.ops import qconv as qc

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in ((1, 3, 1), (16, 36, 16), (17, 40, 7), (100, 2305, 64), (4096, 576, 256)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        got = qc.int8_matmul(a, w)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, qc.int8_matmul_plain(a, w)), (m, k, n)
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, dtype=torch.bfloat16, device="cuda",
                                     impl="int8", fused_1x1=False)
    calls, original = [], conv_mod.qconv2d_int8

    def record(x, dk, b=None, **kw):
        calls.append((x, dk, b, kw))
        return original(x, dk, b, **kw)

    monkeypatch.setattr(conv_mod, "qconv2d_int8", record)
    Predictor(model, imgsz=256).infer(torch.randint(0, 256, (2, 256, 256, 3), device="cuda", dtype=torch.uint8))
    assert len(calls) > 50
    for x, dk, b, kw in calls:
        assert torch.equal(qc.int8_accumulator(x, dk, **kw)[0],
                           qc.int8_accumulator(x, dk, matmul=qc.int8_matmul_plain, **kw)[0]), tuple(dk.shape)
    for x, dk, b, kw in calls[:3] + calls[-3:]:
        cpu_kw = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        got = qc.qconv2d_int8(x, dk, b, **kw).cpu()
        ref = qc.qconv2d_int8(x.cpu(), dk.cpu(), None if b is None else b.cpu(), **cpu_kw)
        assert torch.equal(got, ref), tuple(dk.shape)


@pytest.mark.parametrize("k,s,p,ri,ro", [(3, 2, 1, 2, 2), (3, 1, 1, 2, 2), (1, 1, 0, 2, 2),
                                         (3, 2, 1, 2, 1), (3, 2, 1, 1, 2), (3, 2, 1, 4, 2)])
def test_packed_convs_bf16_on_card_match_their_plain_f32(cuda, k, s, p, ri, ro):
    """The stem's packed convs (cuDNN, channels-last) in bf16 on the card, folded
    and grouped, against the plain f32 conv of the unpacked tensors (TF32 off),
    within bf16's 2e-2 of max|ref|; the phase-composite pair likewise."""
    from quan_ultralytics_tpu_torch.ops import qconv as qc
    from quan_ultralytics_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(k * 10 + ri)
    cin, cout = (1, 4) if ri == 4 else (8, 16)
    x = torch.randn(2, 256, 256, 4, cin, generator=gen, device="cuda")
    w = torch.randn(4, cout, cin, k, k, generator=gen, device="cuda") * 0.2
    b = torch.randn(cout, generator=gen, device="cuda")
    ref = qc.qconv2d(x, w, b, stride=s, padding=p)
    B, H, W, Q, C = x.shape
    xin = x if ri == 1 else x.reshape(B, H // ri, ri, W // ri, ri, Q, C).permute(0, 1, 3, 5, 6, 2, 4).reshape(
        B, H // ri, W // ri, Q, C * ri * ri)
    for impl in ("folded", "grouped"):
        got = qc.qconv2d_packed(xin.bfloat16(), w, b, stride=s, padding=p, ri=ri, ro=ro, impl=impl)
        got = stem.depth_to_space_cmajor(got, ro) if ro > 1 else got
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert float((got.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max()), impl
    x0 = x[..., :1]  # the RGB layer's width
    w0 = torch.randn(4, 8, 1, 3, 3, generator=gen, device="cuda") * 0.2
    w1 = torch.randn(4, 8, 8, 3, 3, generator=gen, device="cuda") * 0.2
    ref2 = qc.qconv2d(qc.qconv2d(x0, w0, stride=2, padding=1), w1, stride=2, padding=1)
    got2 = qc.qconv2d_phase1(qc.qconv2d_phase0(x0.bfloat16(), w0, impl="folded"), w1, impl="folded")
    assert float((got2.float() - ref2).abs().max()) <= 2e-2 * float(ref2.abs().max())


def test_sparse_assigner_on_card_equals_dense_bitwise(cuda):
    """The sparse assigner and the chunked top-k on the card against the dense
    form, bit for bit: the OBB train batch's geometry (1024, 21,504 anchors,
    128 padded boxes an image, 34-100 valid), f32 and the bf16 metric, topk 10
    and 32."""
    from quan_ultralytics_tpu_torch.losses import tal
    from quan_ultralytics_tpu_torch.ops.boxes import make_anchors

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, M, nc, imgsz = 4, 128, 15, 1024
    anchors, stride_t = make_anchors([(imgsz // s, imgsz // s) for s in (8, 16, 32)], (8, 16, 32), 0.5,
                                     device="cuda")
    anc = anchors * stride_t
    A = anc.shape[0]
    gt = torch.cat([torch.rand(B, M, 2, generator=gen, device="cuda") * 800 + 100,
                    torch.rand(B, M, 2, generator=gen, device="cuda") * 180 + 20,
                    torch.rand(B, M, 1, generator=gen, device="cuda") * 3 - 1.5], -1)
    near = gt[torch.arange(B, device="cuda")[:, None], torch.randint(0, M, (B, A), generator=gen, device="cuda")]
    boxes = near + torch.randn(B, A, 5, generator=gen, device="cuda") * torch.tensor(
        [3.0, 3.0, 2.0, 2.0, 0.1], device="cuda")
    scores = torch.rand(B, A, nc, generator=gen, device="cuda")
    labels = torch.randint(0, nc, (B, M), generator=gen, device="cuda")
    valid = torch.arange(M, device="cuda")[None] < torch.randint(34, 101, (B, 1), generator=gen, device="cuda")
    args = (scores, boxes, anc, labels, gt, valid)
    for bf16 in (False, True):
        for topk in (10, 32):
            kw = dict(num_classes=nc, rotated=True, bf16_metric=bf16, topk=topk)
            dense = tal.task_aligned_assigner(*args, **kw)
            for other in (tal.task_aligned_assigner(*args, impl="sparse", **kw),
                          tal.task_aligned_assigner(*args, topk_impl="chunk", **kw)):
                for name in tal.AssignResult._fields:
                    assert torch.equal(getattr(dense, name), getattr(other, name)), (bf16, topk, name)
            assert bool(dense.fg_mask.any())
