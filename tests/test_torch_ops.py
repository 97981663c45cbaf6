"""Port parity: Haar DWT/IDWT, the flash-attention plain versions and the dispatcher.

The plain forward and backward are held to the JAX Pallas ``flash_attention``
and its custom VJP, which run in interpret mode on the CPU. The CUDA kernels
themselves run only on the card: their tests are in ``test_torch_gpu.py``.
The dispatcher's route outside the kernels' gate (and ``"xla"``),
``dot_product_attention``, is held to ``jax.nn.dot_product_attention``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_classifier_tpu.ops.flash_attention import flash_attention as jax_flash
from diffusion_classifier_tpu.ops.wavelet import haar_dwt2 as jax_dwt
from diffusion_classifier_tpu_torch.ops import flash_attention as fa
from diffusion_classifier_tpu_torch.ops.attention import attention, dot_product_attention
from diffusion_classifier_tpu_torch.ops.wavelet import haar_dwt2, haar_idwt2

torch.set_num_threads(1)


def test_haar_matches_jax_and_roundtrips():
    x = np.random.default_rng(0).standard_normal((2, 16, 12, 3)).astype(np.float32)
    y = haar_dwt2(torch.from_numpy(x))
    assert y.shape == (2, 8, 6, 12)
    # ±½ butterflies: exact in float32 up to the order of three additions
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_dwt(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(haar_idwt2(y).numpy(), x, atol=1e-6)


def test_haar_channel_interleave_is_4i_plus_k():
    x = torch.zeros(1, 2, 2, 2)
    x[0, :, :, 1] = 1.0  # constant channel 1: all energy in its cA, channel 4*1+0
    y = haar_dwt2(x)[0, 0, 0]
    np.testing.assert_allclose(y.numpy(), [0, 0, 0, 0, 2, 0, 0, 0], atol=1e-6)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# fp32: atol 2e-5 / rtol 2e-3, the JAX suite's own flash tolerance
# (tests/test_ops.py:66-68). bf16: both sides round p to bf16 before P·V and
# the output to bf16, at different places in their sums: one bf16 ulp of an
# O(1) output, atol 2e-2 / rtol 2e-2.
@pytest.mark.parametrize(
    "dtype,tol",
    [("float32", dict(atol=2e-5, rtol=2e-3)), ("bfloat16", dict(atol=2e-2, rtol=2e-2))],
)
def test_plain_version_matches_pallas_interpret(dtype, tol):
    q, k, v = _qkv((2, 256, 4, 64))
    jdt = getattr(jnp, dtype)
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = fa.flash_attention_reference(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol
    )


# fp32: measured max 5e-7 on gradients of order 1, held to the forward's
# 2e-5 / 2e-3. bf16: the two round p and ds to bf16 at the same points, but
# δ differs: the port's rowsum(dO∘O) reads the bf16-rounded O where JAX's
# rowsum(p∘dp) stays in fp32; measured one bf16 ulp (3.9e-3) on gradients
# of order 1, held to 2e-2 / 2e-2.
@pytest.mark.parametrize(
    "dtype,tol",
    [("float32", dict(atol=2e-5, rtol=2e-3)), ("bfloat16", dict(atol=2e-2, rtol=2e-2))],
)
@pytest.mark.parametrize(
    "shape",
    [(2, 128, 2, 64), (2, 128, 2, 32)],  # JAX's lane-group and head-major backward
)
def test_plain_backward_matches_pallas_interpret(shape, dtype, tol):
    q, k, v = _qkv(shape, seed=2)
    do = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(jax_flash, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, do))
    got = fa.flash_attention_bwd_reference(tq, tk, tv, tdo)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype and g.shape == tq.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), **tol)


def test_function_on_cpu_matches_plain_autograd_through_fused_qkv():
    b, s, h, d = 2, 72, 2, 32
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        x = qkv.clone().requires_grad_()
        q, k, v = (t.view(b, s, h, d) for t in x.split(h * d, dim=-1))
        fn(q, k, v).backward(do)
        grads.append(x.grad)
    # the three thirds' gradients side by side in the fused tensor; the
    # Function's δ form differs from autograd's in the last fp32 bits
    torch.testing.assert_close(grads[0], grads[1], atol=2e-5, rtol=2e-3)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_dispatcher_sends_cpu_tensors_to_plain_version(backend):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 200, 2, 32), seed=1))
    before = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    out = attention(q, k, v, backend=backend)
    # "xla" is JAX's jax.nn.dot_product_attention route in both packages
    plain = dot_product_attention if backend == "xla" else fa.flash_attention_reference
    torch.testing.assert_close(out, plain(q, k, v), rtol=0, atol=0)
    assert (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == before


def _bf16_row_ulp(out: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the scale of each output row: the largest |value| of a query's head vector."""
    top = np.maximum(np.abs(out).max(axis=-1, keepdims=True), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(top)) - 7)


# The route outside the kernels' gate (D=96 in the CheXpert and IPMSA UNets,
# D=40 for an odd width) against jax.nn.dot_product_attention on the CPU.
# bf16: one bf16 ulp at the scale of the output row. The two packages round
# the normalised probabilities to bf16 after fp32 softmaxes whose exp differs
# in the last fp32 bit, so a probability can land one bf16 ulp apart, which
# moves a near-zero output by that much of the row's scale; measured: at most
# 0.125, 1.0 and 0.25 of it, 4.9e-4 absolute. fp32: atol 1e-6 (measured
# ≤ 4.1e-7: summation order). The old route (flash_attention_reference:
# fp32 products, pre-scaled q, exp2, divide after P·V) misses the bf16 bound
# (1.25 and 1.5 row ulps at the first two shapes).
@pytest.mark.parametrize("shape", [(2, 64, 2, 96), (2, 1024, 1, 96), (1, 65, 3, 40)])
def test_plain_route_matches_jax_dot_product_attention(shape):
    q, k, v = _qkv(shape, seed=0)
    old_misses = []
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax.nn.dot_product_attention(
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v))).astype(jnp.float32))
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        got = dot_product_attention(tq, tk, tv)
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(attention(tq, tk, tv, backend="auto"), got)  # D ∉ {32, 64, 128}
        err = np.abs(got.float().numpy() - want)
        old = np.abs(fa.flash_attention_reference(tq, tk, tv).float().numpy() - want)
        if dtype == torch.float32:
            assert err.max() <= 1e-6, err.max()
        else:
            ulp = _bf16_row_ulp(want)
            assert np.all(err <= ulp), (err / ulp).max()
            old_misses.append(bool(np.any(old > ulp)))
    if shape[1] == 64 or shape[1] == 1024:
        assert old_misses == [True]  # the fault the route repairs


def test_dispatcher_rejects_unknown_backend():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError):
        attention(q, q, q, backend="cudnn")


def test_supports_gate():
    ok = torch.zeros(1, 200, 2, 64)  # ragged S is fine on the CUDA kernel
    assert fa.supports(ok, ok, ok)
    d16 = torch.zeros(1, 256, 2, 16)
    assert not fa.supports(d16, d16, d16)
    assert not fa.supports(ok, ok, torch.zeros(1, 201, 2, 64))
    assert not fa.supports(*(torch.zeros(200, 2, 64),) * 3)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 2, 64)
    before = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.FLASH_FWD(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.FLASH_BWD(q, q, q, q, q, torch.zeros(1, 2, 128))
    assert (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == before


def _scale_after_product(q, k, v, do):
    """The plain forward and backward with ``c`` applied to the fp32 product ``q·kᵀ``.

    The bf16 kernels feed bf16 q and k to the tensor cores and scale the fp32
    accumulator, where the plain versions scale q in fp32 before the product.
    """
    d = q.shape[-1]
    scale = 1.0 / d**0.5
    qf, kf, vf, dof = (x.to(torch.float32).transpose(1, 2) for x in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2)) * (scale * fa._LOG2_E)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).to(torch.float32) @ vf) / l
    out = o.transpose(1, 2).to(q.dtype)
    p = p / l
    dv = p.to(do.dtype).to(torch.float32).transpose(-1, -2) @ dof
    delta = (dof * out.to(torch.float32).transpose(1, 2)).sum(dim=-1, keepdim=True)
    ds = (p * (dof @ vf.transpose(-1, -2) - delta)).to(q.dtype).to(torch.float32)
    grads = ((ds @ kf) * scale, (ds.transpose(-1, -2) @ qf) * scale, dv)
    return out, tuple(g.transpose(1, 2).to(q.dtype) for g in grads)


# The kernels' reordering (scale after the product) stays inside the
# tolerances the card's tests hold them to: fp32 atol 2e-5 / rtol 2e-3, bf16
# atol 2e-2 / rtol 2e-2.
@pytest.mark.parametrize(
    "dtype,tol",
    [(torch.float32, dict(atol=2e-5, rtol=2e-3)), (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))],
)
def test_scale_after_product_is_within_the_kernel_tolerance(dtype, tol):
    shape = (2, 200, 2, 64)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(shape, seed=5))
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(shape).astype(np.float32)).to(dtype)
    out, grads = _scale_after_product(q, k, v, do)
    want = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out, want, **tol)
    for name, g, w in zip(("dq", "dk", "dv"), grads, fa.flash_attention_bwd_reference(q, k, v, do, want)):
        torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{name}: {m}")


def test_aligned16_passes_the_qkv_thirds_and_fails_an_offset_view():
    b, s, h, d = 2, 16, 2, 64
    qkv = torch.zeros((b, s, 3 * h * d), dtype=torch.bfloat16)
    assert all(fa._aligned16(x.view(b, s, h, d)) for x in qkv.split(h * d, dim=-1))
    assert not fa._aligned16(qkv[..., 1 : 1 + h * d].view(b, s, h, d))  # 2 bytes off
    assert not fa._aligned16(qkv[:, :, : h * d - 8].unflatten(-1, (h, d - 4)))  # head stride 60
    assert fa._aligned16(qkv[:1, :1, : h * d].reshape(1, 1, h, d))


def test_library_path_hashes_the_shared_header(tmp_path):
    kernel = fa.CudaKernel("flash_attn_fwd", [])
    kernel.source = str(tmp_path / "flash_attn_fwd.cu")
    (tmp_path / "flash_attn_fwd.cu").write_text("// kernel\n")
    (tmp_path / "flash_mma.cuh").write_text("// helpers\n")
    first = kernel.library_path()
    assert first == kernel.library_path() and first.endswith("libflash_attn_fwd.so")
    (tmp_path / "flash_mma.cuh").write_text("// helpers, edited\n")
    assert kernel.library_path() != first  # an edited header rebuilds


def test_wrapper_copies_and_counts_only_unaligned_bf16_inputs():
    kernel = fa.CudaKernel("flash_attn_fwd", [])
    b, s, h, d = 2, 16, 2, 64
    qkv = torch.randn((b, s, 3 * h * d + 1)).to(torch.bfloat16)
    third = qkv[..., : h * d].view(b, s, h, d)  # row stride 385: unaligned
    aligned = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    fp32 = third.float()[:, :, :, 1:]  # fp32 never takes the aligned path
    out = kernel._aligned(third, aligned, fp32)
    assert kernel.copies == 1
    assert out[0] is not third and fa._aligned16(out[0]) and torch.equal(out[0], third)
    assert out[1] is aligned and out[2] is fp32


def test_kernel_module_imports_without_nvcc():
    code = (
        "import os, sys; os.environ['PATH'] = ''; os.environ.pop('CUDA_HOME', None); "
        "import diffusion_classifier_tpu_torch.ops.flash_attention as m; "
        "assert m.FLASH_FWD._lib is None and m.FLASH_FWD.launches == 0; "
        "assert m.FLASH_BWD._lib is None and m.FLASH_BWD.launches == 0; "
        "assert m.FLASH_FWD.copies == 0 and m.FLASH_BWD.copies == 0; "
        "assert 'jax' not in sys.modules"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(fa.__file__))),
    )
    assert proc.returncode == 0, proc.stderr

