"""The fused GroupNorm (``ops/group_norm.py``): its dispatch and tiling on the CPU, its kernel on the card.

CPU tests: ``group_norm_reference``, ``ops/group_norm.py::group_norm`` and
``ResnetBlock2D`` give the same bits, forward and gradients, as the op
chain they ran before the norm took its SiLU epilogue (written out here as
it was); CPU tensors and forwards that record a graph take the plain
version and count ``norm.group.plain``, and a forward that records none
takes the kernel (a stand-in kernel on the CPU, the route's device test
set aside).

Tests marked ``gpu`` skip without a CUDA device (the kernel has no CPU
mode): the kernel against its plain version at the UNets' shapes, and the
dispatch's routing. This file imports neither jax nor the JAX package, so
the card's machine runs it without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_norm.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from diffusion_classifier_tpu_torch.models import layers
from diffusion_classifier_tpu_torch.ops import group_norm as gn
from diffusion_classifier_tpu_torch.ops import kernel
from diffusion_classifier_tpu_torch.utils import profiling

torch.set_num_threads(1)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


# --- the op chain before the fused form, written out -----------------------------------


def _old_group_norm(x, scale, bias, *, num_groups, eps):
    n, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.reshape(n, -1, num_groups, cg)
    count = xg.shape[1] * cg
    s_g = xg.sum(dim=(1, 3), dtype=torch.float32)
    ss_g = (xg * xg).sum(dim=(1, 3), dtype=torch.float32)
    mean = s_g / count
    var = torch.clamp(ss_g / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)
    inv_c = inv.repeat_interleave(cg, dim=1)
    w = (inv_c * scale[None, :]).to(x.dtype)
    b = (bias[None, :] - mean_c * inv_c * scale[None, :]).to(x.dtype)
    y = x.reshape(n, -1, c) * w[:, None, :] + b[:, None, :]
    return y.reshape(x.shape)


def _old_resnet_block(block, x, temb, skip=None):
    def gn_silu(v, norm, lo, hi, groups):
        return F.silu(_old_group_norm(v, norm.weight[lo:hi], norm.bias[lo:hi], num_groups=groups, eps=norm.eps))

    split = False
    if skip is not None:
        if x.shape[-1] % ((x.shape[-1] + skip.shape[-1]) // block.groups) == 0:
            split = True
        else:
            x, skip = torch.cat([x, skip], dim=-1), None
    in_ch = block.norm1.weight.shape[0]
    if not split:
        h = block.conv1(gn_silu(x, block.norm1, 0, in_ch, block.groups))
    else:
        xc = x.shape[-1]
        gh = block.groups * xc // in_ch
        hx = gn_silu(x, block.norm1, 0, xc, gh)
        hs = gn_silu(skip, block.norm1, xc, in_ch, block.groups - gh)
        h = layers.conv_nhwc(hx.to(block.dtype), block.conv1.weight[:, :xc], block.conv1.bias, padding=1)
        h = h + layers.conv_nhwc(hs.to(block.dtype), block.conv1.weight[:, xc:], None, padding=1)
    h = h + block.time_emb(F.silu(temb))[:, None, None, :]
    h = F.silu(_old_group_norm(h, block.norm2.weight, block.norm2.bias, num_groups=block.groups, eps=block.norm2.eps))
    h = block.conv2(h)
    if block.shortcut is None:
        return (torch.cat([x, skip], dim=-1) if split else x) + h
    w, b = block.shortcut.weight.to(block.dtype), block.shortcut.bias.to(block.dtype)
    if not split:
        res = F.linear(x.to(block.dtype), w)
    else:
        xc = x.shape[-1]
        res = F.linear(x.to(block.dtype), w[:, :xc]) + F.linear(skip.to(block.dtype), w[:, xc:])
    return (res + b) + h


def _randomise(module, seed):
    g = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.ndim == 1 else 0.0))


# --- CPU: the refactor keeps every bit ---------------------------------------------------


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape,groups", [((3, 4, 5, 24), 6), ((2, 7, 16), 4)], ids=["nhwc", "rows"])
def test_group_norm_equals_the_old_chain_on_cpu(shape, groups, dtype, silu):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 3 + 1).to(dtype).requires_grad_()
    c = shape[-1]
    scale = (torch.randn(c, generator=g) * 0.3 + 1).requires_grad_()
    bias = torch.randn(c, generator=g).requires_grad_()
    outs, grads = [], []
    for fn in (gn.group_norm, gn.group_norm_reference,
               lambda *a, silu, **k: (F.silu if silu else (lambda t: t))(_old_group_norm(*a, **k))):
        out = fn(x, scale, bias, num_groups=groups, eps=1e-5, silu=silu)
        grads.append(torch.autograd.grad(out.float().square().sum(), (x, scale, bias)))
        outs.append(out.detach())
    assert outs[0].dtype == dtype
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[2])
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[2]))
    with torch.no_grad():  # no graph recorded: a CPU tensor still takes the plain chain
        assert torch.equal(gn.group_norm(x, scale, bias, num_groups=groups, eps=1e-5, silu=silu), outs[2])
    assert profiling.counters() == {"norm.group.plain": 2}
    assert gn.GROUP_NORM.launches == 0


@pytest.mark.parametrize("case", ["no_skip", "split", "concat"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_resnet_block_equals_the_old_chain_on_cpu(dtype, case):
    """The block with ``group_norm(silu=True)``, per half on the split path, against ``F.silu`` after the old chain."""
    in_x, in_skip, out_ch, groups = {"no_skip": (16, None, 24, 4), "split": (16, 16, 16, 4),
                                      "concat": (8, 16, 16, 4)}[case]
    block = layers.ResnetBlock2D(in_x + (in_skip or 0), out_ch, 12, groups=groups, dtype=dtype)
    _randomise(block, 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 4, 4, in_x, generator=g).to(dtype).requires_grad_()
    skip = None if in_skip is None else torch.randn(2, 4, 4, in_skip, generator=g).to(dtype)
    temb = torch.randn(2, 12, generator=g).to(dtype)
    outs, grads = [], []
    for fn in (block, lambda *a: _old_resnet_block(block, *a)):
        block.zero_grad(set_to_none=True)
        out = fn(x, temb, skip)
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad.clone() for p in block.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    norms = {"no_skip": 2, "split": 3, "concat": 2}[case]
    assert profiling.counters() == {"norm.group.plain": norms}


class _StandIn:
    """A kernel object that computes the plain chain, recording its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, scale, bias, **kw):
        self.calls.append((tuple(x.shape), scale.shape[0], kw))
        return gn.group_norm_reference(x, scale, bias, **kw)


def test_dispatch_takes_the_kernel_only_where_no_graph_is_recorded(monkeypatch):
    stand_in = _StandIn()
    monkeypatch.setattr(gn, "GROUP_NORM", stand_in)
    block = layers.ResnetBlock2D(32, 16, 12, groups=4)
    _randomise(block, 3)
    g = torch.Generator().manual_seed(4)
    x, skip = torch.randn(2, 4, 4, 16, generator=g), torch.randn(2, 4, 4, 16, generator=g)
    temb = torch.randn(2, 12, generator=g)
    with torch.no_grad():  # a CPU tensor takes the plain chain, graph or none
        block(x, temb, skip)
    assert stand_in.calls == [] and profiling.counters() == {"norm.group.plain": 3}
    profiling.reset_counters()
    # the route as on the card, the device test set aside: the kernel wherever no graph is recorded
    monkeypatch.setattr(kernel, "takes_kernel", lambda x, *params: not kernel.records_graph(x, *params))
    slow = block(x, temb, skip)  # the parameters require grad: a graph is recorded
    assert stand_in.calls == [] and profiling.counters() == {"norm.group.plain": 3}
    with torch.no_grad():
        fast = block(x, temb, skip)
    assert torch.equal(fast, slow.detach())
    # each half of the split input on its own, with its slice of the weight and its groups; then norm2
    assert stand_in.calls == [
        ((2, 4, 4, 16), 16, dict(num_groups=2, eps=1e-5, silu=True)),
        ((2, 4, 4, 16), 16, dict(num_groups=2, eps=1e-5, silu=True)),
        ((2, 4, 4, 16), 16, dict(num_groups=4, eps=1e-5, silu=True)),
    ]
    assert profiling.counters() == {"norm.group.plain": 3, "norm.group.kernel": 3}
    # the attention blocks' norms take no epilogue; grad on, but nothing requires it: no graph
    attn = layers.AttentionBlock2D(16, 2, 8, groups=4)
    _randomise(attn, 5)
    attn.requires_grad_(False)
    attn(x)
    assert stand_in.calls[-1] == ((2, 4, 4, 16), 16, dict(num_groups=4, eps=1e-5, silu=False))
    assert profiling.counters()["norm.group.kernel"] == 4


def test_the_wrapper_refuses_what_it_does_not_take():
    x, scale, bias = torch.randn(2, 3, 3, 16), torch.ones(16), torch.zeros(16)
    cases = [
        (dict(x=x, num_groups=3), "groups 3 must divide"),
        (dict(x=x.half()), "float32 or bfloat16"),
        (dict(x=torch.randn(2, 3, 3, 12).to(BF16), scale=torch.ones(12), bias=torch.zeros(12), num_groups=4),
         "16-byte chunks"),
        (dict(scale=scale.to(BF16)), "scale must be a contiguous float32"),
        (dict(bias=torch.zeros(8)), "bias must be a contiguous float32"),
        ({}, "CUDA"),
    ]
    for override, message in cases:
        kw = dict(dict(x=x, scale=scale, bias=bias, num_groups=4), **override)
        with pytest.raises(ValueError, match=message):
            gn.GROUP_NORM(kw.pop("x"), kw.pop("scale"), kw.pop("bias"), eps=1e-5, **kw)
    with pytest.raises(ValueError, match="must divide"):
        gn.group_norm(x, scale, bias, num_groups=5, eps=1e-5)
    assert not kernel.takes_kernel(x, scale, bias)  # a CPU tensor
    assert gn.GROUP_NORM.launches == 0


# (hw, channels, group size): the CIFAR UNet's norms (a classify tail and the encode), the
# IPMSA and CheXpert UNets' (at 128 x 128 too tall to hold: two passes), odd row counts, and
# group sizes of no whole half chunk: diffusers' UNet2DModel widths 224-448-672 and SD's 320
# in 32 groups (a partial a channel)
UNET_TILES = [(1024, 128, 4), (1024, 128, 8), (256, 128, 4), (256, 128, 8), (256, 384, 12), (64, 128, 4),
              (64, 256, 8), (64, 256, 16), (64, 384, 12), (64, 768, 24), (16, 256, 8), (16, 512, 16),
              (16, 512, 32), (16, 768, 24), (1024, 768, 24), (1024, 1280, 40), (16384, 256, 8),
              (16384, 384, 12), (15, 40, 20), (49, 96, 4), (1024, 224, 7), (256, 448, 14), (64, 672, 21),
              (4096, 320, 10)]


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "f32"])
def test_tiling_holds_whole_groups_in_a_block(element_size):
    vec = 16 // element_size
    for hw, c, cg in UNET_TILES + [(4096, 320, 20), (16384, 128, 4)]:
        width, chunks = gn.tiling(hw, c, cg, element_size)
        assert width % cg == 0 and width % vec == 0 and c % width == 0, (hw, c, cg, width)
        assert width // vec <= 256 and width // cg <= 256
        rows_a_pass = 256 // (width // vec)
        if chunks:
            assert chunks in (2, 4, 8, 16) and chunks * rows_a_pass >= hw, (hw, c, cg, width, chunks)
            assert chunks == 2 or (chunks // 2) * rows_a_pass < hw  # the fewest that hold the rows
        else:  # not even the narrowest tile lets a thread hold its rows: the two-pass kernel
            assert -(-hw // rows_a_pass) > 16, (hw, c, cg)
            assert width == min(w for w in range(math.lcm(cg, vec), c + 1, math.lcm(cg, vec))
                                if c % w == 0 and w * element_size >= 32)
        assert width * element_size >= 32  # rows of whole 32-byte sectors
    # the cell's largest norm: 32-byte rows of 16 channels, 8 chunks a thread
    assert gn.tiling(1024, 128, 4, 2) == (16, 8)
    assert gn.tiling(4096, 320, 20, 2)[1] == 0
    assert gn.tiling(16, 4096, 4096, 2) is None  # one group wider than a block's 256 chunks
    assert gn.tiling(4096, 320, 10, 2) == (40, 0)  # 10 channels a group: a partial a channel
    assert gn.tiling(4096, 320, 10, 4) == (20, 0)
    assert gn.tiling(1024, 224, 7, 2) == (56, 0)


# --- the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(shape, dtype, gen):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    c = shape[-1]
    scale = 1 + 0.05 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.02 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias


def _held_to_plain(got, want):
    """At least 99.9% of the outputs the same bits (the fp32 statistics sum in another order); fp32 to 1e-5."""
    assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    same = (got.view(torch.int16) == want.view(torch.int16)).float().mean().item()
    assert same >= 0.999, same
    # where a channel's bf16 w or b falls on the other side of a rounding boundary:
    # about one bf16 ulp of the larger of the two products' magnitudes
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * max(1.0, want.float().abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("hw,c,cg", UNET_TILES, ids=lambda v: str(v))
def test_kernel_matches_plain_version(cuda, hw, c, cg, dtype):
    x, scale, bias = _inputs((3, hw, c), dtype, cuda)
    if hw == 1024:
        x = x.view(3, 32, 32, c)
    copies = gn.GROUP_NORM.copies
    for eps in (1e-5, 1e-6):
        for silu in (False, True):
            kw = dict(num_groups=c // cg, eps=eps, silu=silu)
            _held_to_plain(gn.GROUP_NORM(x, scale, bias, **kw), gn.group_norm_reference(x, scale, bias, **kw))
    assert gn.GROUP_NORM.copies == copies


@pytest.mark.gpu
def test_kernel_repeats_its_bits_and_copies_only_unviewable_inputs(cuda):
    x, scale, bias = _inputs((8, 32, 32, 128), BF16, cuda)
    kw = dict(num_groups=32, eps=1e-5, silu=True)
    first = gn.GROUP_NORM(x, scale, bias, **kw)
    assert all(torch.equal(first, gn.GROUP_NORM(x, scale, bias, **kw)) for _ in range(5))
    copies = gn.GROUP_NORM.copies
    halves = x[::2]  # samples strided: viewed as rows, no copy
    _held_to_plain(gn.GROUP_NORM(halves, scale, bias, **kw), gn.group_norm_reference(halves, scale, bias, **kw))
    assert gn.GROUP_NORM.copies == copies
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # channels strided: copied
    _held_to_plain(gn.GROUP_NORM(nchw, scale, bias, **kw), gn.group_norm_reference(nchw, scale, bias, **kw))
    assert gn.GROUP_NORM.copies == copies + 1
    # a slice of the weight (the split resnet's halves): a pointer offset
    _held_to_plain(gn.GROUP_NORM(x[..., :64].contiguous(), scale[64:], bias[64:], num_groups=16, eps=1e-5),
                   gn.group_norm_reference(x[..., :64], scale[64:], bias[64:], num_groups=16, eps=1e-5))


@pytest.mark.gpu
def test_no_grad_forwards_take_the_kernel_and_autograd_the_plain_chain(cuda):
    block = layers.ResnetBlock2D(256, 128, 64, groups=32, dtype=BF16)
    layers.reset_parameters(block, torch.Generator().manual_seed(0))
    block = block.to("cuda")
    x = torch.randn((4, 16, 16, 128), generator=cuda, device="cuda").to(BF16)
    skip = torch.randn((4, 16, 16, 128), generator=cuda, device="cuda").to(BF16)
    temb = torch.randn((4, 64), generator=cuda, device="cuda").to(BF16)
    launches = gn.GROUP_NORM.launches
    with torch.no_grad():
        fast = block(x, temb, skip)
    assert gn.GROUP_NORM.launches - launches == 3  # the split halves and norm2
    assert profiling.counters() == {"norm.group.kernel": 3}
    slow = block(x, temb, skip)
    assert gn.GROUP_NORM.launches - launches == 3
    assert profiling.counters()["norm.group.plain"] == 3
    rel = ((fast.float() - slow.detach().float()).norm() / slow.detach().float().norm()).item()
    assert rel <= 1e-2, rel
