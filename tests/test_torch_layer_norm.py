"""The fused LayerNorm (``ops/layer_norm.py``): its dispatch on the CPU, its kernel on the card.

CPU tests: ``ops/layer_norm.py::layer_norm``, ``DiTBlock``, ``DiT`` and
``BasicTransformerBlock`` give the same bits, forward and gradients, as the
op chain they ran before the norm took its epilogue (a LayerNorm in float32,
the cast, then the AdaLN modulation or the affine, written out here as it
was); CPU tensors take the plain version and count ``norm.layer.plain``.

Tests marked ``gpu`` skip without a CUDA device (the kernel has no CPU
mode): the kernel against its plain version, and the dispatch's routing.
This file imports neither jax nor the JAX package, so the card's machine
runs it without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layer_norm.py
"""

import functools

import pytest
import torch
import torch.nn.functional as F

from diffusion_classifier_tpu_torch.models import layers
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTBlock, DiTConfig
from diffusion_classifier_tpu_torch.ops import layer_norm as ln
from diffusion_classifier_tpu_torch.ops.attention import attention
from diffusion_classifier_tpu_torch.utils import profiling

torch.set_num_threads(1)
BF16 = torch.bfloat16
EPS = 1e-5


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


# --- the op chain before the fused form, written out -----------------------------------


def _old_layer_norm(x, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps)


def _old_modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _old_dit_block(block, x, cond):
    b, s, dim = x.shape
    mods = block.adaLN_modulation(F.silu(cond))
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.chunk(6, dim=-1)
    h = _old_modulate(_old_layer_norm(x, block.norm_eps).to(block.dtype), shift_msa, scale_msa)
    q, k, v = (t.view(b, s, block.num_heads, block.head_dim) for t in block.qkv(h).split(dim, dim=-1))
    o = attention(q, k, v, backend=block.attn_backend).reshape(b, s, dim)
    x = x + gate_msa[:, None, :] * block.proj(o)
    h = _old_modulate(_old_layer_norm(x, block.norm_eps).to(block.dtype), shift_mlp, scale_mlp)
    h = F.gelu(block.mlp_fc1(h), approximate="tanh")
    return x + gate_mlp[:, None, :] * block.mlp_fc2(h)


def _old_transformer_block(block, x, context):
    def norm(m, t):
        return (_old_layer_norm(t, m.eps) * m.weight + m.bias).to(block.dtype)

    x = x + block.attn1(norm(block.norm1, x))
    if block.attn2 is not None:
        h = x if block.norm2 is None else norm(block.norm2, x)
        x = x + block.attn2(h, context)
    return x + block.ff(norm(block.norm3, x))


# --- CPU: the refactor keeps every bit ---------------------------------------------------


def _grads(module):
    return [p.grad.clone() for p in module.parameters() if p.grad is not None]


def _same_forward_and_grads(module, new, old, inputs):
    """``new(*inputs)`` and ``old(*inputs)`` equal, and so are their parameters' gradients."""
    outs, grads = [], []
    for fn in (new, old):
        module.zero_grad(set_to_none=True)
        out = fn(*inputs)
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append(_grads(module))
    assert outs[0].dtype == outs[1].dtype
    assert torch.equal(outs[0], outs[1])
    assert len(grads[0]) == len(grads[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with torch.no_grad():
        assert torch.equal(new(*inputs), outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_layer_norm_epilogues_equal_the_old_chain_on_cpu(dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, 24, generator=g) * 3 + 1).to(dtype)
    shift, scale = (torch.randn(3, 24, generator=g).to(dtype) for _ in range(2))
    w, b = torch.randn(24, generator=g), torch.randn(24, generator=g)
    assert torch.equal(ln.layer_norm(x, EPS), _old_layer_norm(x, EPS))
    assert torch.equal(
        ln.layer_norm(x, EPS, shift=shift, scale=scale, dtype=dtype),
        _old_modulate(_old_layer_norm(x, EPS).to(dtype), shift, scale),
    )
    assert torch.equal(
        ln.layer_norm(x, EPS, weight=w, bias=b, dtype=dtype),
        (_old_layer_norm(x, EPS) * w + b).to(dtype),
    )
    assert profiling.counters() == {"norm.layer.plain": 3}
    assert ln.LAYER_NORM.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_dit_block_equals_the_old_chain_on_cpu(dtype):
    block = DiTBlock(2, 16, dtype=dtype, attn_backend="xla")
    g = torch.Generator().manual_seed(1)
    for p in block.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g) * 0.2)
    x = torch.randn(2, 6, 32, generator=g).to(dtype).requires_grad_()
    cond = torch.randn(2, 32, generator=g).to(dtype)
    _same_forward_and_grads(block, block, functools.partial(_old_dit_block, block), (x, cond))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_dit_equals_the_old_chain_on_cpu(dtype):
    """The whole DiT: each block as before, and the final layer's input to ``final_proj`` as before."""
    cfg = DiTConfig(num_attention_heads=2, attention_head_dim=16, in_channels=4, num_layers=2,
                    sample_size=8, patch_size=2, num_classes=3, attn_backend="xla")
    model = DiT(cfg, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(3))
    t, y = torch.tensor([0.5, -2.0]), torch.tensor([0, 2])

    def run(old):
        seen = {}
        hooks = [
            model.blocks[-1].register_forward_hook(lambda m, a, out: seen.update(tokens=out)),
            model.final_modulation.register_forward_pre_hook(lambda m, a: seen.update(cond_silu=a[0])),
            model.final_proj.register_forward_pre_hook(lambda m, a: seen.update(final_in=a[0])),
        ]
        if old:
            for block in model.blocks:
                block.forward = functools.partial(_old_dit_block, block)
        try:
            out = model(x, t, y)
        finally:
            for h in hooks:
                h.remove()
            for block in model.blocks:
                block.__dict__.pop("forward", None)
        return out, seen

    with torch.no_grad():
        new, seen_new = run(old=False)
        assert profiling.counters().get("norm.layer.plain") == 2 * cfg.num_layers + 1
        old, seen_old = run(old=True)
        assert torch.equal(new, old)
        shift, scale = model.final_modulation(seen_old["cond_silu"]).chunk(2, dim=-1)
        want = _old_modulate(_old_layer_norm(seen_old["tokens"], cfg.norm_eps).to(dtype), shift, scale)
        assert torch.equal(seen_new["final_in"], want)


@pytest.mark.parametrize("tokens", [None, 1, 4], ids=["self", "one_token_context", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_basic_transformer_block_equals_the_old_chain_on_cpu(dtype, tokens):
    block = layers.BasicTransformerBlock(
        32, 2, 16, dtype, context_dim=None if tokens is None else 24, context_tokens=tokens
    )
    g = torch.Generator().manual_seed(4)
    for p in block.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g) * 0.2)
    x = (torch.randn(2, 6, 32, generator=g) * 2 + 0.5).to(dtype).requires_grad_()
    context = None if tokens is None else torch.randn(2, tokens, 24, generator=g).to(dtype)
    _same_forward_and_grads(
        block, functools.partial(block, context=context),
        lambda t: _old_transformer_block(block, t, context), (x,),
    )


def test_the_wrapper_refuses_cpu_tensors_and_unpaired_epilogues():
    x = torch.randn(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ln.LAYER_NORM(x, EPS)
    with pytest.raises(ValueError, match="pairs"):
        ln.layer_norm(x, EPS, weight=torch.ones(8))
    with pytest.raises(ValueError, match="one epilogue"):
        ln.LAYER_NORM(x, EPS, weight=torch.ones(8), bias=torch.zeros(8),
                      shift=torch.zeros(2, 8), scale=torch.zeros(2, 8))
    assert ln.LAYER_NORM.launches == 0


# --- the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _ulps(a, b):
    """bf16 ulps between ``a`` and ``b``, at the larger magnitude of the pair and at least 2⁻⁶'s.

    The floor: where ``y·w + b`` or ``x − mean`` cancels, a value near 0 has
    a bf16 ulp far below the fp32 statistics' own rounding (~1e-7), so two
    right answers may sit many of those ulps apart.
    """
    af, bf = a.float(), b.float()
    mag = torch.maximum(torch.maximum(af.abs(), bf.abs()), torch.full_like(af, 2.0**-6))
    return (af - bf).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _held_to_plain(got, want):
    """bf16: at least 99.9% of the outputs the same bits, none more than 1 ulp apart."""
    assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    same = (got.view(torch.int16) == want.view(torch.int16)).float().mean().item()
    assert same >= 0.999, same
    assert _ulps(got, want).max().item() <= 1.0


# (shape, input dtype): the DiT's classify forward and its batch of 32 rows, the UNet
# transformer blocks' 256 and 512 at its tails, an odd row count, DiT-B's and the UNet
# mid block's widths, a ragged chunk (100 fp32: 25 chunks of 4), a width no multiple of
# 8 (the one-element path), rows past 256 chunks (the two-pass kernel)
KERNEL_SHAPES = [
    ((128, 1024, 384), BF16),
    ((32, 1024, 384), BF16),
    ((1024, 64, 256), BF16),
    ((1024, 16, 512), BF16),
    ((3, 37, 384), BF16),
    ((4, 256, 768), BF16),
    ((2, 16, 1024), BF16),
    ((2, 64, 1152), BF16),
    ((4, 10, 100), BF16),
    ((4, 10, 100), torch.float32),
    ((2, 8, 4096), BF16),
    ((2, 64, 384), torch.float32),
]


def _inputs(shape, dtype, gen):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    b, d = shape[0], shape[-1]
    rows = torch.randn((b, 6 * d), generator=gen, device="cuda").to(dtype) * 0.5
    shift, scale = rows[:, :d], rows[:, d:2 * d]  # views of one [B, 6D] row, as the DiT's chunks
    w = torch.randn(d, generator=gen, device="cuda")
    bias = torch.randn(d, generator=gen, device="cuda")
    return x, shift, scale, w, bias


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", KERNEL_SHAPES, ids=lambda v: str(v))
def test_kernel_matches_plain_version(cuda, shape, dtype):
    x, shift, scale, w, b = _inputs(shape, dtype, cuda)
    out = BF16 if dtype == BF16 else torch.float32
    copies = ln.LAYER_NORM.copies
    # no epilogue, fp32 out (a caller that needs fp32) and in the compute dtype
    _held_to_plain(ln.LAYER_NORM(x, EPS), ln.layer_norm_reference(x, EPS))
    r = ln.LAYER_NORM(x, EPS, dtype=out)
    _held_to_plain(r, ln.layer_norm_reference(x, EPS, dtype=out))
    # affine: fp32 w and b, one rounding to the compute dtype
    _held_to_plain(ln.LAYER_NORM(x, EPS, weight=w, bias=b, dtype=out),
                   ln.layer_norm_reference(x, EPS, weight=w, bias=b, dtype=out))
    # AdaLN: the modulation's own three roundings are exact from the kernel's r, and
    # the whole against the plain chain as above
    shift, scale = shift.to(out), scale.to(out)
    got = ln.LAYER_NORM(x, EPS, shift=shift, scale=scale, dtype=out)
    assert torch.equal(got, r * (1.0 + scale[:, None, :]) + shift[:, None, :])
    want = ln.layer_norm_reference(x, EPS, shift=shift, scale=scale, dtype=out)
    if out == BF16:
        same = (got.view(torch.int16) == want.view(torch.int16)).float().mean().item()
        assert same >= 0.999, same
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert ln.LAYER_NORM.copies == copies


@pytest.mark.gpu
def test_strided_inputs_copied_only_when_the_last_dim_is(cuda):
    base = torch.randn((4, 384, 64), generator=cuda, device="cuda").to(BF16)
    x = base.transpose(1, 2)  # [4, 64, 384], last-dim stride 64
    copies = ln.LAYER_NORM.copies
    _held_to_plain(ln.LAYER_NORM(x, EPS, dtype=BF16), ln.layer_norm_reference(x, EPS, dtype=BF16))
    assert ln.LAYER_NORM.copies == copies + 1
    rows = torch.randn((4, 128, 384), generator=cuda, device="cuda").to(BF16)[:, ::2]  # rows strided
    _held_to_plain(ln.LAYER_NORM(rows, EPS, dtype=BF16), ln.layer_norm_reference(rows, EPS, dtype=BF16))
    flat = rows.reshape(-1, 384)[::3]  # 2-D, rows strided
    _held_to_plain(ln.LAYER_NORM(flat, EPS, dtype=BF16), ln.layer_norm_reference(flat, EPS, dtype=BF16))
    assert ln.LAYER_NORM.copies == copies + 1


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    x = torch.randn((2, 4, 64), generator=cuda, device="cuda")
    launches = ln.LAYER_NORM.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ln.LAYER_NORM(x.half(), EPS)
    with pytest.raises(ValueError, match="scale"):
        ln.LAYER_NORM(x, EPS, shift=torch.zeros(2, 64, device="cuda"), scale=torch.zeros(3, 64, device="cuda"))
    with pytest.raises(ValueError, match="weight"):
        ln.LAYER_NORM(x, EPS, weight=torch.ones(64, device="cuda", dtype=BF16),
                      bias=torch.zeros(64, device="cuda"))
    assert ln.LAYER_NORM.launches == launches


@pytest.mark.gpu
def test_no_grad_forwards_take_the_kernel_and_autograd_the_plain_chain(cuda):
    block = DiTBlock(6, 64, dtype=BF16, attn_backend="auto")
    layers.reset_parameters(block, torch.Generator().manual_seed(0))
    block = block.to("cuda")
    x = torch.randn((2, 64, 384), generator=cuda, device="cuda").to(BF16)
    cond = torch.randn((2, 384), generator=cuda, device="cuda").to(BF16)
    launches = ln.LAYER_NORM.launches
    with torch.no_grad():
        fast = block(x, cond)
    assert ln.LAYER_NORM.launches - launches == 2
    assert profiling.counters().get("norm.layer.kernel") == 2
    assert "norm.layer.plain" not in profiling.counters()
    slow = block(x, cond)  # grad on, the parameters require it
    assert ln.LAYER_NORM.launches - launches == 2
    assert profiling.counters()["norm.layer.plain"] == 2
    # the norms' last-bit differences carried through the attention and the MLP
    rel = ((fast.float() - slow.detach().float()).norm() / slow.detach().float().norm()).item()
    assert rel <= 1e-2, rel

    # under autograd: the plain chain's gradients, bit for bit
    xg = (torch.randn((2, 64, 384), generator=cuda, device="cuda") * 2).requires_grad_()
    scale = torch.randn((2, 384), generator=cuda, device="cuda").requires_grad_()
    shift = torch.randn((2, 384), generator=cuda, device="cuda").requires_grad_()
    grads = []
    for fn in (ln.layer_norm, ln.layer_norm_reference):
        out = fn(xg, EPS, shift=shift, scale=scale)
        grads.append(torch.autograd.grad(out.square().sum(), (xg, shift, scale)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert ln.LAYER_NORM.launches - launches == 2
