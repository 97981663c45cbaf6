"""Port parity for UNet training: train steps against JAX, remat, dropout.

1. Three train steps of the tiny flagship UNet (``_torch_parity.TINY_UNET``
   with the ``'nn'`` class embedder, fp32) with two microbatches against JAX
   ``make_train_step`` (XLA attention): the same bridged weights, the JAX key
   tree's draws replayed through :class:`JaxTrainDraws`. The port runs with
   ``remat`` on, the JAX step with it off.
2. ``remat`` on against off: bit-identical gradients on the CPU, one
   checkpointed call per resnet block and transformer, none without grad.
3. Dropout: with ``dropout=0.5`` the port's forward equals the JAX forward
   (neither drops by default), and ``deterministic=False`` drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_UNET as TINY
from _torch_parity import JaxTrainDraws, random_params, to_numpy_tree
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
from diffusion_classifier_tpu.engine import state as jax_state
from diffusion_classifier_tpu.engine import steps as jax_steps
from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
from diffusion_classifier_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
from diffusion_classifier_tpu.models.unet import UNetConfig as JaxUNetConfig
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine import state
from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn, make_train_step
from diffusion_classifier_tpu_torch.models import unet as unet_module
from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
from diffusion_classifier_tpu_torch.models.layers import reset_parameters
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)

C = 10
TRAIN = dict(lr=1e-3, warmup=2, total=3, ema=dict(beta=0.9999, update_after_step=1, update_every=1))


def _jax_denoiser(**overrides):
    return JaxDenoiser(
        backbone=JaxUNet(JaxUNetConfig(**TINY, attn_backend="xla", **overrides)),
        encoder=JaxClassEmbedder(C, 16),
    )


def _port_denoiser(params=None, **overrides):
    model = Denoiser(UNetCondition2D(UNetConfig(**TINY, **overrides)), ClassEmbedder(C, 16))
    if params is None:
        reset_parameters(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(flax_to_state_dict(params, model))
    return model


@pytest.fixture(scope="module")
def tiny_run():
    rng = np.random.default_rng(11)
    batches = [
        (rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32), rng.integers(0, C, 4).astype(np.int32))
        for _ in range(3)
    ]
    keys = jax.random.split(jax.random.PRNGKey(12), 3)
    x0, y0 = batches[0]
    params = random_params(_jax_denoiser().init, x0, np.zeros(4, np.float32), y0, seed=13)
    return params, batches, keys


def _jax_train(params, batches, keys):
    jden = _jax_denoiser()
    loss_fn = jax_steps.make_loss_fn(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab),
        jax_schedule_fn("shifted_cosine", 64, 8), pred_param="v", null_token=C,
    )
    tx = jax_state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    step = jax_steps.make_train_step(
        loss_fn, tx, jax_state.EmaConfig(**TRAIN["ema"]), grad_accum_steps=2, donate=False
    )
    st = jax_state.init_train_state(params, tx)
    # XLA's lowest backend optimisation level halves the compile (14 → 8 s)
    x0, y0 = batches[0]
    step = step.lower(st, jnp.asarray(x0), jnp.asarray(y0), keys[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0}
    )
    losses = []
    for (x, y), key in zip(batches, keys):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y), key)
        losses.append(float(loss))
    return losses, to_numpy_tree(st.params), to_numpy_tree(st.ema_params)


# fp32 on both sides, summed in different orders: held to rtol 1e-5 / atol
# 2e-6 (losses to rtol 1e-5), as the DiT's steps in test_torch_train.py.
# No parameter of this UNet has a gradient that is zero in exact arithmetic
# while nonzero in float32 (the DiT's qkv key bias is such one; the UNet's
# q/k/v projections have no bias), so none needs the 2·lr allowance there.
def test_three_unet_train_steps_with_remat_match_jax(tiny_run):
    params, batches, keys = tiny_run
    want_losses, want_params, want_ema = _jax_train(params, batches, keys)

    model = _port_denoiser(params, remat=True)
    loss_fn = make_loss_fn(
        model, make_schedule_fn("shifted_cosine", 64, 8), pred_param="v", null_token=C
    )
    tx = state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    st = state.init_train_state(model, tx)
    step = make_train_step(loss_fn, tx, state.EmaConfig(**TRAIN["ema"]), grad_accum_steps=2)
    losses = [
        step(st, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), JaxTrainDraws(key)).item()
        for (x, y), key in zip(batches, keys)
    ]
    assert (st.step, st.ema_counter, st.opt_state.count) == (3, 3, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for got_model, want in ((st.model, want_params), (st.ema_model, want_ema)):
        want_sd = flax_to_state_dict(want, got_model)
        for name, value in got_model.state_dict().items():
            np.testing.assert_allclose(
                value.numpy(), want_sd[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name
            )


def test_unet_remat_recomputes_blocks_with_the_same_gradients(monkeypatch):
    calls = []

    def counting_checkpoint(fn, *args, **kwargs):
        calls.append(type(fn).__name__)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(unet_module, "checkpoint", counting_checkpoint)
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32))
    t, y = torch.tensor([0.5, -1.0, 2.0]), torch.tensor([0, 4, C])
    grads = []
    for remat in (False, True):
        model = _port_denoiser(remat=remat)
        calls.clear()
        model(x, t, y).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
        # 8 resnet blocks and 4 spatial transformers, each one boundary
        want = {"ResnetBlock2D": 8, "SpatialTransformer": 4} if remat else {}
        assert {n: calls.count(n) for n in set(calls)} == want
        calls.clear()
        with torch.no_grad():
            model(x, t, y)
        assert calls == []  # no recomputation without grad
    for a, b in zip(*grads, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_applies_only_when_not_deterministic():
    rng = np.random.default_rng(15)
    x = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    lg = rng.uniform(-5, 5, 3).astype(np.float32)
    y = np.array([0, 4, C], np.int32)
    jden = _jax_denoiser(dropout=0.5)
    params = random_params(jden.init, x, lg, y, seed=16)
    want = np.asarray(jax.jit(jden.apply)(params, x, lg, y))
    model = _port_denoiser(params, dropout=0.5).train()  # the training flag plays no part
    args = [torch.from_numpy(a) for a in (x, lg, y)]
    with torch.no_grad():
        got = model(*args)
        torch.manual_seed(0)
        dropped = model(*args, deterministic=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert (dropped - got).abs().max().item() > 1e-2
