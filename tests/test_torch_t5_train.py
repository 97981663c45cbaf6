"""Port parity on the text-conditioned ('t5') path: prefix classification, train steps, CFG sampling.

The narrow t5 UNet (``_torch_parity.T5_UNET`` over a seeded ``[4, 6, 16]``
class table, fp32) on the same weights (a seeded flax tree, bridged) and the
same draws (the JAX key tree replayed):

1. prefix classification against JAX ``make_classifier``: the condition-free
   prefix on ``[G·B]`` and the tails on a ``[G·B·K, 6, 16]`` context;
2. three train steps against JAX ``make_train_step``:
   the CFG dropout sends labels to the table's null row;
3. one CFG sampler step (and the final one) against JAX ``make_sampler``:
   the unconditional half of each pair reads the null row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree
import pytest
import torch

from _torch_parity import (
    T5_CLASSES,
    JaxDraws,
    JaxSampleDraws,
    JaxTrainDraws,
    random_params,
    seeded_t5_table,
    t5_denoisers,
    to_numpy_tree,
)
from diffusion_classifier_tpu.diffusion.classify import make_classifier as jax_make_classifier
from diffusion_classifier_tpu.diffusion.sampler import make_sampler as jax_make_sampler
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule
from diffusion_classifier_tpu.engine import state as jax_state
from diffusion_classifier_tpu.engine import steps as jax_steps
from diffusion_classifier_tpu_torch.diffusion.classify import make_classifier
from diffusion_classifier_tpu_torch.diffusion.sampler import make_sampler
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine import state
from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn, make_train_step
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)

C = T5_CLASSES
NULL = C  # the table's last row
TRAIN = dict(lr=1e-3, warmup=2, total=3, ema=dict(beta=0.9999, update_after_step=1, update_every=1))
# XLA's lowest backend optimisation level: the JAX programs compile in about half the time
FAST = {"xla_backend_optimization_level": 0}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=1)
def _pair():
    """``(jax denoiser, port denoiser with the bridged weights, flax params)``."""
    jden, port = t5_denoisers(seeded_t5_table(7))
    x = np.zeros((2, 8, 8, 1), np.float32)
    params = random_params(jden.init, x, np.zeros(2, np.float32), np.zeros(2, np.int32), seed=8)
    port.load_state_dict(flax_to_state_dict(params, port))
    return jden, port.eval(), params


def _prefix_fns(jden, port):
    jkw = dict(
        encode_fn=lambda p, z, lg: jden.apply(p, z, lg, None, mode="encode"),
        tail_fn=lambda p, s, lab: jden.apply(p, None, None, lab, mode="tail", prefix_state=s),
    )
    tkw = dict(
        encode_fn=lambda z, lg: port(z, lg, None, mode="encode"),
        tail_fn=lambda s, lab: port(None, None, lab, mode="tail", prefix_state=s),
    )
    return jkw, tkw


B = 8
PROTOCOL = dict(
    pred_param="v", num_classes=C, n_stages=2, evaluation_per_stage=(2, 4), n_keep_per_stage=(2, 1),
)


# fp32: the stage means agree to the models' rounding (rtol 1e-4, as the
# flagship's prefix classify); the candidates and predictions exactly
def test_t5_prefix_classify_matches_jax():
    jden, port, params = _pair()
    jkw, tkw = _prefix_fns(jden, port)
    x = np.random.default_rng(9).uniform(-1, 1, (B, 8, 8, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(10)
    schedule = ("shifted_cosine", 64, 8)
    jfn = jax.jit(jax_make_classifier(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab), jax_schedule(*schedule),
        class_chunk=0, trace=True, **jkw, **PROTOCOL,
    )).lower(params, x, np.zeros(B, np.int32), rng).compile(compiler_options=FAST)
    want_pred, want_stages = jfn(params, x, np.zeros(B, np.int32), rng)

    contexts = []
    hook = port.encoder.register_forward_hook(lambda m, args, out: contexts.append(tuple(out.shape)))
    tfn = make_classifier(port, make_schedule_fn(*schedule), class_chunk=0, trace=True, **tkw, **PROTOCOL)
    try:
        got_pred, got_stages = tfn(_t(x), torch.zeros(B, dtype=torch.long), JaxDraws(rng, fast=False))
    finally:
        hook.remove()
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
    for got, want in zip(got_stages, want_stages, strict=True):
        np.testing.assert_array_equal(got["cand"].numpy(), np.asarray(want["cand"]))
        w = np.asarray(want["mean"])
        np.testing.assert_array_equal(np.isinf(got["mean"].numpy()), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(got["mean"].numpy()[fin], w[fin], rtol=1e-4)
    # one group a stage (G·B·K within the CPU budget): the tails' contexts
    # are [G·B·K, 6, 16], K = 3 classes, then the 2 kept
    assert contexts == [(2 * B * 3, 6, 16), (2 * B * 2, 6, 16)]


@pytest.fixture(scope="module")
def train_run():
    rng = np.random.default_rng(11)
    batches = [
        (rng.uniform(-1, 1, (4, 8, 8, 1)).astype(np.float32), rng.integers(0, C, 4).astype(np.int32))
        for _ in range(3)
    ]
    # keys whose dropout draws (u < 0.1) send one label a step to the null row
    keys = jax.random.split(jax.random.PRNGKey(6), 3)
    return batches, keys


def _jax_train(jden, params, batches, keys):
    # the JAX step on the parameters as one flat vector, unravelled inside
    # the loss: clipping by the global norm, Adam and the EMA act element by
    # element, so it is the same step, traced and compiled as one leaf
    flat, unravel = ravel_pytree(params)
    loss_fn = jax_steps.make_loss_fn(
        lambda p, z, lg, lab: jden.apply(unravel(p), z, lg, lab), jax_schedule("shifted_cosine", 64, 8),
        pred_param="v", null_token=NULL,
    )
    tx = jax_state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    step = jax_steps.make_train_step(loss_fn, tx, jax_state.EmaConfig(**TRAIN["ema"]), donate=False)
    st = jax_state.init_train_state(flat, tx)
    x0, y0 = batches[0]
    step = step.lower(st, jnp.asarray(x0), jnp.asarray(y0), keys[0]).compile(compiler_options=FAST)
    losses = []
    for (x, y), key in zip(batches, keys):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y), key)
        losses.append(float(loss))
    return losses, to_numpy_tree(unravel(st.params)), to_numpy_tree(unravel(st.ema_params))


# fp32, held as the flagship's three steps (tests/test_torch_unet_train.py):
# losses rtol 1e-5, parameters and EMA rtol 1e-5 / atol 2e-6
def test_three_t5_train_steps_match_jax(train_run):
    batches, keys = train_run
    jden, port, params = _pair()
    # at least one label of these draws drops to the null row (u < 0.1)
    dropped = sum(
        int((np.asarray(JaxTrainDraws(key).loss(0, 1, 4, (4, 8, 8, 1))[0]) < 0.1).sum())
        for key in keys
    )
    assert dropped > 0
    want_losses, want_params, want_ema = _jax_train(jden, params, batches, keys)

    model = t5_denoisers(seeded_t5_table(7))[1]
    model.load_state_dict(flax_to_state_dict(params, model))
    loss_fn = make_loss_fn(model, make_schedule_fn("shifted_cosine", 64, 8), pred_param="v", null_token=NULL)
    tx = state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    st = state.init_train_state(model, tx)
    step = make_train_step(loss_fn, tx, state.EmaConfig(**TRAIN["ema"]), grad_accum_steps=1)
    losses = [
        step(st, _t(x), _t(y.astype(np.int64)), JaxTrainDraws(key)).item()
        for (x, y), key in zip(batches, keys)
    ]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # the table is no parameter: the optimizer and the EMA leave it as it was
    assert not any(p is st.model.encoder.table for p in st.model.parameters())
    np.testing.assert_array_equal(st.ema_model.encoder.table.numpy(), seeded_t5_table(7))
    for got_model, want in ((st.model, want_params), (st.ema_model, want_ema)):
        want_sd = flax_to_state_dict(want, got_model)
        for name, value in got_model.state_dict().items():
            np.testing.assert_allclose(
                value.numpy(), want_sd[name].numpy(), rtol=1e-5, atol=2e-6, err_msg=name
            )


def test_t5_cfg_sampler_step_matches_jax():
    jden, port, params = _pair()
    jkw, tkw = _prefix_fns(jden, port)
    x = np.random.default_rng(12).uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    labels = np.array([1, NULL], np.int32)
    sampler = dict(pred_param="v", cfg_w=0.3, null_token=NULL, sampling_steps=1)
    key = jax.random.PRNGKey(13)
    jfn = jax.jit(jax_make_sampler(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab), jax_schedule("shifted_cosine", 64, 8),
        **sampler, **jkw,
    )).lower(params, x, labels, key).compile(compiler_options=FAST)
    want = np.asarray(jfn(params, x, labels, key))

    pair_labels = []
    hook = port.encoder.register_forward_hook(lambda m, args, out: pair_labels.append(args[0].tolist()))
    tfn = make_sampler(port, make_schedule_fn("shifted_cosine", 64, 8), **sampler, **tkw)
    try:
        got = tfn(_t(x), _t(labels).long(), JaxSampleDraws(key))
    finally:
        hook.remove()
    assert got.shape == x.shape and float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # each step's tail on the CFG pair: the labels, then the null row for each
    assert pair_labels == [[1, NULL, NULL, NULL]] * 2
