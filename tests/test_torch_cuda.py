"""The port's CUDA kernels against their plain versions on the card.

K1 (fused attention forward), K2 (its backward) and K3 (fused 1x1
Conv+IQBN+SiLU) at the main path's shapes (yolo11n-obb-quan at imgsz 1024,
batch 8), as in chip_smoke.py; and the attention's autograd Function. This
file imports no JAX, so it runs on a machine that has a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card every test skips. f32 runs with TF32 off; the tolerances are
stated per dtype: in bf16, K1 rounds ``scale * q`` and the softmax numerator
to bf16 where the plain version in f32 does not.
"""

import math

import pytest
import torch

from quan_ultralytics_tpu_torch.models.block import QAttention
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel, fused_1x1_sites
from quan_ultralytics_tpu_torch.ops.kernels import qattn, qconv_fused

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 400, 200])
def test_qattn_kernel_matches_plain_on_card(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k = (torch.randn(8, 4, 8, n, 2, generator=g, device=cuda).to(dtype) for _ in range(2))
    v = torch.randn(8, 4, 8, n, 4, generator=g, device=cuda).to(dtype)
    scale = 2 ** -0.5
    before = qattn.launches
    got = qattn.qattention_fused(q, k, v, scale)
    torch.cuda.synchronize()
    assert qattn.launches == before + 1
    ref = qattn.qattention_plain(q.float(), k.float(), v.float(), scale)
    _assert_close(got, ref, *_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 400, 200])
def test_qattn_bwd_kernel_matches_plain_on_card(cuda, dtype, n):
    """K2 against the plain backward, which keeps its rounding points, within
    `qattn.BWD_TOL`; in bf16 the f32 gradients of the same inputs miss it."""
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    q, k = (torch.randn(8, 4, 8, n, 2, generator=g, device=cuda).to(dtype) for _ in range(2))
    v, do = (torch.randn(8, 4, 8, n, 4, generator=g, device=cuda).to(dtype) for _ in range(2))
    scale = 2 ** -0.5
    before = qattn.launches_bwd
    got = qattn.qattention_bwd(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert qattn.launches_bwd == before + 1
    ref = qattn.qattention_bwd_plain(q, k, v, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        err, rel, ok = qattn.bwd_error(a, b, dtype)
        assert ok, f"{name} N={n} {dtype}: max abs error {err:.3e}, mean rel {rel:.3e}"
    if dtype == torch.bfloat16:
        f32 = qattn.qattention_bwd_plain(q.float(), k.float(), v.float(), do.float(), scale)
        for name, a, b in zip(("dq", "dk", "dv"), f32, ref):
            assert not qattn.bwd_error(a, b, dtype)[2], f"the f32 {name} meets the bf16 tolerance"


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv1x1_kernel_matches_plain_on_card(cuda, dtype):
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu", fused_1x1=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    for ci, co, p in sorted(set(fused_1x1_sites(model, 8, 1024))):
        x = torch.randn(p, 1, 1, 4, ci, generator=g, device=cuda).to(dtype)
        w = torch.randn(4, co, ci, 1, 1, generator=g, device=cuda) / math.sqrt(ci)
        scale = torch.rand(4, co, generator=g, device=cuda) + 0.5
        shift = torch.randn(4, co, generator=g, device=cuda) * 0.1
        for silu in (True, False):
            before = qconv_fused.launches
            got = qconv_fused.qconv1x1_fused(x, w, scale, shift, apply_silu=silu)
            torch.cuda.synchronize()
            assert qconv_fused.launches == before + 1
            ref = qconv_fused.qconv1x1_fused_plain(x, w, scale, shift, apply_silu=silu)
            _assert_close(got, ref, *_TOL[dtype], msg=f"Ci={ci} Co={co} P={p} silu={silu}")


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 16, 3, device=cuda)  # dk = 3 is not instantiated
    with pytest.raises(ValueError, match="dk, dv"):
        qattn.qattention_fused(q, q, q, 1.0)
    x = torch.zeros(1, 2, 2, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qconv_fused.qconv1x1_fused(x, torch.zeros(4, 8, 8, device=cuda))
