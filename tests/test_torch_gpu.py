"""The CUDA flash-attention kernels on the card, against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports neither jax nor the JAX package,
so the machine with the card runs it without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import math

import pytest
import torch

from diffusion_classifier_tpu_torch.ops import flash_attention as fa
from diffusion_classifier_tpu_torch.ops.attention import attention

pytestmark = pytest.mark.gpu

# fp32: the JAX suite's flash tolerance (tests/test_ops.py:66-68); bf16: one
# bf16 ulp of an O(1) output
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-3), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# ragged last tiles and odd sequences on the tensor-core (bf16) kernels, at
# every head dim: chip_smoke.py phases 3 and 6
BF16_RAGGED = [
    ((2, 200, 2, 64), torch.bfloat16),
    ((1, 65, 1, 128), torch.bfloat16),
    ((3, 77, 2, 32), torch.bfloat16),
]
# the backward's shapes: chip_smoke.py phase 6
BWD_CASES = [
    ((16, 1024, 6, 64), torch.bfloat16),
    ((2, 1024, 6, 64), torch.float32),
    ((1, 512, 3, 128), torch.bfloat16),
    ((2, 200, 2, 32), torch.float32),  # ragged last tiles
    *BF16_RAGGED,
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _strided_qkv(shape, dtype, gen):
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return [x.view(b, s, h, d) for x in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((2, 1024, 6, 64), torch.bfloat16),
        ((2, 1024, 6, 64), torch.float32),
        ((1, 512, 3, 128), torch.bfloat16),
        ((2, 200, 2, 32), torch.float32),
        ((1, 65, 1, 128), torch.float32),
        ((2, 256, 4, 32), torch.bfloat16),
        *BF16_RAGGED,
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _strided_qkv(shape, dtype, cuda)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v), **TOL[dtype])


@pytest.mark.parametrize("shape,dtype", BWD_CASES[1:])
def test_forward_lse_is_the_row_logsumexp_in_log2(cuda, shape, dtype):
    q, k, v = _strided_qkv(shape, dtype, cuda)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    torch.testing.assert_close(out, fa.FLASH_FWD(q, k, v), rtol=0, atol=0)
    c = math.log2(math.e) / math.sqrt(shape[-1])
    s = (q.float() * c).transpose(1, 2) @ k.float().transpose(1, 2).transpose(-1, -2)
    want = torch.logsumexp(s * math.log(2.0), dim=-1) / math.log(2.0)
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape,dtype", BWD_CASES)
def test_backward_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _strided_qkv(shape, dtype, cuda)
    do = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    got = fa.FLASH_BWD(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, do, out)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g, w, **TOL[dtype], msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("shape", [(2, 200, 2, 64), (16, 1024, 6, 64)])
def test_backward_kernel_is_deterministic(cuda, shape):
    q, k, v = _strided_qkv(shape, torch.bfloat16, cuda)
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(q.dtype)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    first = fa.FLASH_BWD(q, k, v, out, do, lse)
    for a, b in zip(first, fa.FLASH_BWD(q, k, v, out, do, lse)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,dtype", [BWD_CASES[3], ((2, 256, 2, 64), torch.bfloat16)])
def test_function_gradients_match_plain_autograd(cuda, shape, dtype):
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3 * h * d), generator=cuda, device="cuda").to(dtype)
    do = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        x = qkv.clone().requires_grad_()
        q, k, v = (t.view(b, s, h, d) for t in x.split(h * d, dim=-1))
        before = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        fn(q, k, v).backward(do)
        launched = (fa.FLASH_FWD.launches - before[0], fa.FLASH_BWD.launches - before[1])
        assert launched == ((1, 1) if fn is fa.flash_attention else (0, 0))
        grads.append(x.grad)
    # the fused qkv tensor gets the three thirds' gradients side by side
    torch.testing.assert_close(grads[0], grads[1], **TOL[dtype])


def test_unaligned_bf16_view_is_copied_not_refused(cuda):
    b, s, h, d = 2, 200, 2, 64
    flat = torch.randn(b * s * h * d + 1, generator=cuda, device="cuda").to(torch.bfloat16)
    q = flat[1:].view(b, s, h, d)  # 2 bytes past a 16-byte boundary
    k, v = _strided_qkv((b, s, h, d), torch.bfloat16, cuda)[1:]
    assert not fa._aligned16(q) and fa._aligned16(k) and fa._aligned16(v)
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(q.dtype)
    before = fa.FLASH_FWD.copies, fa.FLASH_BWD.copies
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    grads = fa.FLASH_BWD(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.copies - before[0], fa.FLASH_BWD.copies - before[1]) == (1, 1)
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v), **TOL[q.dtype])
    for name, g, w in zip(("dq", "dk", "dv"), grads, fa.flash_attention_bwd_reference(q, k, v, do, out)):
        torch.testing.assert_close(g, w, **TOL[q.dtype], msg=lambda m: f"{name}: {m}")


def test_dispatcher_routes_cuda_tensors_to_the_kernel(cuda):
    q, k, v = _strided_qkv((1, 256, 2, 64), torch.bfloat16, cuda)
    for backend, launched in (("auto", 1), ("pallas", 1), ("xla", 0)):
        before = fa.FLASH_FWD.launches
        attention(q, k, v, backend=backend)
        assert fa.FLASH_FWD.launches - before == launched, backend
    d16 = torch.zeros((1, 64, 2, 16), device="cuda")
    before = fa.FLASH_FWD.launches
    attention(d16, d16, d16, backend="auto")  # outside the gate: plain version
    assert fa.FLASH_FWD.launches == before


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _strided_qkv((1, 128, 2, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.FLASH_FWD(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="dtype"):
        fa.FLASH_FWD(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="unsupported"):
        fa.FLASH_FWD(q[..., :48], k[..., :48], v[..., :48])


def test_backward_wrapper_raises_on_bad_input(cuda):
    q, k, v = _strided_qkv((1, 128, 2, 64), torch.float32, cuda)
    out, lse = fa.FLASH_FWD(q, k, v, lse=True)
    before = fa.FLASH_BWD.launches
    with pytest.raises(ValueError, match="lse"):
        fa.FLASH_BWD(q, k, v, out, out, lse[:, :1])
    with pytest.raises(ValueError, match="lse"):
        fa.FLASH_BWD(q, k, v, out, out, lse.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        fa.FLASH_BWD(q, k, v, out, out.to(torch.bfloat16), lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.FLASH_BWD(q, k, v, out, out.cpu(), lse)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.FLASH_BWD(q, k, v, out, out.transpose(1, 3).contiguous().transpose(1, 3), lse)
    assert fa.FLASH_BWD.launches == before
