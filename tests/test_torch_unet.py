"""Port parity: the UNet layers, the tiny UNet, the weight bridge and prefix classification.

The same numpy inputs and the same weights (a flax tree of seeded values,
converted by the port's weight bridge) go through the JAX module and its
port. The JAX attention at these sequence lengths (< 256 tokens) is XLA's;
the port's CPU attention is the flash kernel's plain version. Parameters
come from ``jax.eval_shape`` filled with seeded values (nonzero biases), so
no JAX init compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_UNET as TINY
from _torch_parity import JaxDraws, random_params, rel_l2
from diffusion_classifier_tpu.diffusion.classify import make_classifier as jax_make_classifier
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule
from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
from diffusion_classifier_tpu.models import layers as jl
from diffusion_classifier_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
from diffusion_classifier_tpu.models.unet import UNetConfig as JaxUNetConfig
from diffusion_classifier_tpu_torch.diffusion.classify import make_classifier
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser, supports_prefix
from diffusion_classifier_tpu_torch.models import layers as tl
from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
from diffusion_classifier_tpu_torch.ops.group_norm import group_norm
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)

C = 10
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(module, params):
    module.load_state_dict(flax_to_state_dict(params, module))
    return module.eval()


def _compare(jax_module, port_module, args):
    """fp32: JAX apply (jitted) vs the port on the same seeded weights."""
    params = random_params(jax_module.init, *args)
    want = np.asarray(jax.jit(jax_module.apply)(params, *args))
    port = _port(port_module, params)
    with torch.no_grad():
        got = port(*[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


# --- layers ------------------------------------------------------------------

# fp32: the two sum in different orders (atol 1e-5 on unit-variance
# outputs); bf16: the output is rounded to bf16 after the same float32
# statistics, so they differ by at most about one bf16 ulp where the
# rounding of x·w and +b falls differently
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_norm_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 4, 32)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = jl.group_norm_mxu(jnp.asarray(x, jdt), scale, bias, num_groups=8, eps=1e-5)
    got = group_norm(_t(x).to(tdt), _t(scale), _t(bias), num_groups=8, eps=1e-5)
    assert got.dtype == tdt
    want, got = np.asarray(want, np.float32), got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


# in_ch, skip channels, out_ch (8 groups): a skip of 16 on 16 splits at a
# group boundary (width 4); 8 on 16 straddles one (width 3) and concatenates
RESNETS = {
    "no_skip": (16, None, 16),
    "channel_change": (16, None, 32),
    "split_halves": (16, 16, 16),
    "concat_fallback": (16, 8, 16),
}


@pytest.mark.parametrize("case", list(RESNETS))
def test_resnet_block_matches_jax(case):
    xc, sc, out = RESNETS[case]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, xc)).astype(np.float32)
    temb = rng.standard_normal((2, 24)).astype(np.float32)
    skip = None if sc is None else rng.standard_normal((2, 4, 4, sc)).astype(np.float32)
    jblock = jl.ResnetBlock2D(out, groups=8)
    params = random_params(
        lambda key, a, t, s: jblock.init(key, a, t, skip=s), x, temb, skip
    )
    want = np.asarray(jax.jit(lambda p: jblock.apply(p, x, temb, skip=skip))(params))
    port = _port(tl.ResnetBlock2D(xc + (sc or 0), out, 24, groups=8), params)
    with torch.no_grad():
        got = port(_t(x), _t(temb), None if skip is None else _t(skip)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("tokens", [1, 3])
def test_spatial_transformer_matches_jax(tokens):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, tokens, 16)).astype(np.float32)
    port = tl.SpatialTransformer(
        32, 2, 16, groups=8, context_dim=16, context_tokens=tokens
    )
    # one context token: no norm2, no attn2.to_q/to_k (the bridge would raise)
    assert (port.blocks[0].norm2 is None) == (tokens == 1)
    assert hasattr(port.blocks[0].attn2, "to_q") == (tokens > 1)
    _compare(jl.SpatialTransformer(2, 16, groups=8), port, (x, ctx))


def test_attention_block_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 32)).astype(np.float32)
    _compare(jl.AttentionBlock2D(2, 16, groups=8), tl.AttentionBlock2D(32, 2, 16, groups=8), (x,))


@pytest.mark.parametrize("which", ["down", "up"])
def test_resample_matches_jax(which):
    x = np.random.default_rng(4).standard_normal((2, 4, 4, 8)).astype(np.float32)
    if which == "down":
        _compare(jl.Downsample2D(12), tl.Downsample2D(8, 12), (x,))
    else:
        _compare(jl.Upsample2D(12), tl.Upsample2D(8, 12), (x,))


# --- the tiny UNet --------------------------------------------------------------


def _jax_denoiser(jdt):
    return JaxDenoiser(
        backbone=JaxUNet(JaxUNetConfig(**TINY), dtype=jdt),
        encoder=JaxClassEmbedder(C, 16, dtype=jdt),
    )


def _port_denoiser(params, tdt):
    model = Denoiser(UNetCondition2D(UNetConfig(**TINY), tdt), ClassEmbedder(C, 16, tdt))
    return _port(model, params)


@pytest.fixture(scope="module")
def tiny_unet():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    lg = rng.uniform(-5, 5, 3).astype(np.float32)
    y = np.array([0, 4, C], np.int32)  # C: the null token
    params = random_params(_jax_denoiser(jnp.float32).init, x, lg, y, seed=6)
    full = np.asarray(jax.jit(_jax_denoiser(jnp.float32).apply)(params, x, lg, y))
    return params, x, lg, y, full


def test_tiny_unet_fp32_matches_jax_and_tail_of_encode_is_full(tiny_unet):
    params, x, lg, y, want = tiny_unet
    jden = _jax_denoiser(jnp.float32)
    jstate = jax.jit(lambda p, z, l: jden.apply(p, z, l, None, mode="encode"))(params, x, lg)
    port = _port_denoiser(params, torch.float32)
    assert supports_prefix(port.backbone) and port.backbone.prefix_split == 1
    with torch.no_grad():
        full = port(_t(x), _t(lg), _t(y))
        state = port(_t(x), _t(lg), None, mode="encode")
        tail = port(None, None, _t(y), mode="tail", prefix_state=state)
    np.testing.assert_allclose(full.numpy(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(tail, full, rtol=0, atol=0)
    # the prefix state itself: (h, skips, temb) as the JAX encode gives it
    got_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), state))
    for got, ref in zip(got_leaves, jax.tree.leaves(jstate), strict=True):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)


# bf16 rounds at different places in the two packages (XLA's CPU expansions
# of silu and gelu alone round 30-40% of bf16 elements differently from
# torch's), and ~20 layers compound it: for these inputs each package's bf16
# forward lies 1.5-2.4% (relative L2) from the fp32 forward over four weight
# seeds, and the two bf16 forwards 2.0-2.6% from each other, the port always
# the nearer to fp32. So the port's bf16 forward is held to the fp32 JAX
# forward at 2e-2, and to JAX's bf16 forward within 1.5x JAX's own bf16 error
# (two independent roundings lie ~1.4x apart; a wrong operation far more).
def test_tiny_unet_bf16_matches_jax(tiny_unet):
    params, x, lg, y, full_fp32 = tiny_unet
    want = np.asarray(jax.jit(_jax_denoiser(jnp.bfloat16).apply)(params, x, lg, y))
    port = _port_denoiser(params, torch.bfloat16)
    with torch.no_grad():
        got = port(_t(x), _t(lg), _t(y))
        tail = port(None, None, _t(y), mode="tail",
                    prefix_state=port(_t(x), _t(lg), None, mode="encode"))
    assert got.dtype == torch.float32
    torch.testing.assert_close(tail, got, rtol=0, atol=0)
    jax_err = rel_l2(want, full_fp32)
    assert rel_l2(got.numpy(), full_fp32) < min(2e-2, jax_err)
    assert rel_l2(got.numpy(), want) < 1.5 * jax_err


def test_flagship_tree_converts_exactly():
    from __graft_entry__ import _flagship

    from diffusion_classifier_tpu_torch.experiments.cifar10 import build_backbone
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    jden, size = _flagship()
    shapes = jax.eval_shape(
        jden.init, jax.random.PRNGKey(0), np.zeros((1, size, size, 3), np.float32),
        np.zeros(1, np.float32), np.zeros(1, np.int32),
    )
    leaves = jax.tree.leaves(shapes)
    assert len(leaves) == 515
    n_params = sum(int(np.prod(s.shape)) for s in leaves)
    assert round(n_params / 1e6, 1) == 95.9
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    config = ExperimentConfig(mixed_precision="bf16")
    with torch.device("meta"):
        port = Denoiser(build_backbone(config), ClassEmbedder(C, 128, torch.bfloat16))
    sd = flax_to_state_dict(zeros, port)  # raises on a missing or extra leaf
    assert set(sd) == set(port.state_dict()) and len(sd) == 515
    assert sum(v.numel() for v in sd.values()) == n_params
    assert sd["backbone.up_0_res_0.conv1.weight"].shape == (512, 1024, 3, 3)  # HWIO -> OIHW
    assert sd["backbone.up_0_res_0.shortcut.weight"].shape == (512, 1024)
    assert sd["encoder.embedding.weight"].shape == (C + 1, 128)


# --- classification with the shared prefix ---------------------------------------

B = 16  # class_chunk=-1 picks 1 class a chunk at B >= 16
PROTOCOL = dict(
    pred_param="v", num_classes=C, n_stages=2, evaluation_per_stage=(2, 4),
    n_keep_per_stage=(3, 1),
)


def test_prefix_classify_matches_jax_for_every_class_chunk(tiny_unet):
    params = tiny_unet[0]
    x = np.random.default_rng(7).uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    jden = _jax_denoiser(jnp.float32)
    rng = jax.random.PRNGKey(8)
    # class_chunk=0: one tail call on all candidates a group, so the
    # prefix state is repeated per class (K=10, then 3 after the pruning)
    jfn = jax.jit(jax_make_classifier(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab),
        jax_schedule("shifted_cosine", 64, 8), class_chunk=0, trace=True,
        encode_fn=lambda p, z, lg: jden.apply(p, z, lg, None, mode="encode"),
        tail_fn=lambda p, s, lab: jden.apply(p, None, None, lab, mode="tail", prefix_state=s),
        **PROTOCOL,
    ))
    want_pred, want_stages = jfn(params, x, np.zeros(B, np.int32), rng)

    port = _port_denoiser(params, torch.float32)
    calls = {"encode": 0, "tail": 0, "full": 0}

    def hook(module, args, output):
        calls["encode" if isinstance(output, tuple) else "tail" if args[0] is None else "full"] += 1

    port.register_forward_hook(hook)
    for chunk in (0, 1, -1):
        tfn = make_classifier(
            port, make_schedule_fn("shifted_cosine", 64, 8), class_chunk=chunk, trace=True,
            encode_fn=lambda z, lg: port(z, lg, None, mode="encode"),
            tail_fn=lambda s, lab: port(None, None, lab, mode="tail", prefix_state=s),
            **PROTOCOL,
        )
        got_pred, got_stages = tfn(_t(x), torch.zeros(B, dtype=torch.long), JaxDraws(rng, fast=False))
        np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
        for got, want in zip(got_stages, want_stages):
            np.testing.assert_array_equal(got["cand"].numpy(), np.asarray(want["cand"]))
            w = np.asarray(want["mean"])
            np.testing.assert_array_equal(np.isinf(got["mean"].numpy()), np.isinf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(got["mean"].numpy()[fin], w[fin], rtol=1e-4)
    # groups: stage 1 one group of 2 evals, stage 2 one of 2 (B·K·G within
    # the budget), so 2 encodes a run; the tails: 1 + 1 at class_chunk 0,
    # 10 + 3 at class_chunk 1 (and -1)
    assert calls == {"encode": 6, "tail": 2 + 13 + 13, "full": 0}
