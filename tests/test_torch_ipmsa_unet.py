"""Port parity for the IPMSA UNet at a narrow width: forward, prefix classify, train steps.

The narrow net (:func:`_torch_parity.narrow_ipmsa_pair`: the experiment's
five levels and block types at :data:`_torch_parity.IPMSA_UNET_NARROW` —
one resnet and one head a level, so level 3 runs D=64 on the flash kernels'
plain version and level 4 and the mid block D=96 on the plain route) on a
16 × 16 × 24 input (4 and 1 tokens there), with the same seeded weights in
both packages: the fp32 forward within relative L2 1e-4 of JAX's, the
prefix classifier's predictions identical on injected draws, two train
steps against JAX ``make_train_step`` at the narrow CheXpert UNet's
tolerance (``test_torch_chexpert_unet.py``). The full-width
trees and the entry points are ``test_torch_ipmsa.py``'s, the explanation
``test_torch_ipmsa_explain.py``'s.
"""

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest
import torch

from _torch_parity import (
    JaxDraws,
    JaxTrainDraws,
    narrow_ipmsa_pair,
    narrow_ipmsa_port,
    rel_l2,
    to_numpy_tree,
)
from diffusion_classifier_tpu.diffusion.classify import make_classifier as jax_make_classifier
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
from diffusion_classifier_tpu.engine import state as jax_state
from diffusion_classifier_tpu.engine import steps as jax_steps
from diffusion_classifier_tpu_torch.diffusion.classify import make_classifier
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine import state
from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn, make_train_step
from diffusion_classifier_tpu_torch.utils import convert

torch.set_num_threads(1)
C = 2
# the card's classify batch: below 16 rows class_chunk=-1 scores both classes in one tail
# (the chunked path at B=16 is tests/test_torch_chexpert_unet.py's)
B = 8


@pytest.fixture(scope="module")
def narrow():
    return narrow_ipmsa_pair()


def test_narrow_forward_matches_jax(narrow):
    jden, params, args = narrow
    want = np.asarray(jax.jit(jden.apply).lower(params, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(params, *args))
    port = narrow_ipmsa_port(params)
    assert port.backbone.prefix_split == 3  # levels 0-2 are condition-free
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in args])
    assert rel_l2(got.numpy(), want) <= 1e-4


def test_narrow_prefix_classify_matches_jax(narrow):
    jden, params, _ = narrow
    x = np.random.default_rng(33).uniform(-1, 1, (B, 16, 16, 24)).astype(np.float32)
    schedule = ("shifted_cosine", 64, 256)  # name, noise_d, image_size
    protocol = dict(pred_param="v", num_classes=C, n_stages=1, evaluation_per_stage=(4,),
                    n_keep_per_stage=(1,))
    rng = jax.random.PRNGKey(34)
    jfn = jax.jit(jax_make_classifier(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab), jax_schedule_fn(*schedule),
        encode_fn=lambda p, z, lg: jden.apply(p, z, lg, None, mode="encode"),
        tail_fn=lambda p, s, lab: jden.apply(p, None, None, lab, mode="tail", prefix_state=s),
        **protocol,
    ))
    labels = np.zeros(B, np.int32)
    want = np.asarray(jfn.lower(params, x, labels, rng).compile(
        compiler_options={"xla_backend_optimization_level": 0})(params, x, labels, rng))
    port = narrow_ipmsa_port(params)
    tfn = make_classifier(
        port, make_schedule_fn(*schedule),
        encode_fn=lambda z, lg: port(z, lg, None, mode="encode"),
        tail_fn=lambda s, lab: port(None, None, lab, mode="tail", prefix_state=s),
        **protocol,
    )
    with torch.no_grad():
        got = tfn(torch.from_numpy(x), torch.zeros(B, dtype=torch.long), JaxDraws(rng, fast=False))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < B  # both classes predicted: the comparison is not trivial


TRAIN = dict(lr=1e-3, warmup=1, total=2, ema=dict(beta=0.9999, update_after_step=0, update_every=1))


def _port_steps(params, batches, keys, dtype):
    """Two port train steps in ``dtype`` (float64: the reference of exact arithmetic); the state."""
    model = narrow_ipmsa_port(params, dtype)
    loss_fn = make_loss_fn(model, make_schedule_fn("shifted_cosine", 64, 256), pred_param="v", null_token=C)
    tx = state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    st = state.init_train_state(model, tx)
    step = make_train_step(loss_fn, tx, state.EmaConfig(**TRAIN["ema"]))

    class Draws(JaxTrainDraws):
        def loss(self, *args):
            return tuple(t.to(dtype) for t in super().loss(*args))

    losses = [
        step(st, torch.from_numpy(x).to(dtype), torch.from_numpy(y.astype(np.int64)), Draws(key)).item()
        for (x, y), key in zip(batches, keys)
    ]
    return losses, st


# the narrow CheXpert UNet's tolerance (tests/test_torch_chexpert_unet.py):
# the loss at rtol 1e-5, parameters at rtol 1e-5 / atol 2e-6; an element beyond
# that (Adam's scale-free step carries a near-cancelling gradient's fp32
# rounding into a full-size update) within twice the port's own fp32 error
# against its fp64 steps, and no more than 4 such elements.
def test_two_narrow_train_steps_match_jax(narrow):
    jden, params, _ = narrow
    rng = np.random.default_rng(35)
    batches = [(rng.uniform(-1, 1, (4, 16, 16, 24)).astype(np.float32), rng.integers(0, C, 4).astype(np.int32))
               for _ in range(2)]
    keys = jax.random.split(jax.random.PRNGKey(36), 2)
    # the JAX step on the parameters as one flat vector (unravelled inside
    # the loss): clipping by the global norm, Adam and the EMA act element
    # by element, so this is the same step, and its optimizer and EMA
    # trace and compile as one leaf instead of 377
    flat, unravel = ravel_pytree(params)
    loss_fn = jax_steps.make_loss_fn(
        lambda p, z, lg, lab: jden.apply(unravel(p), z, lg, lab),
        jax_schedule_fn("shifted_cosine", 64, 256), pred_param="v", null_token=C,
    )
    tx = jax_state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    step = jax_steps.make_train_step(loss_fn, tx, jax_state.EmaConfig(**TRAIN["ema"]), donate=False)
    st = jax_state.init_train_state(flat, tx)
    step = step.lower(st, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]), keys[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0}
    )
    want_losses = []
    for (x, y), key in zip(batches, keys):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y), key)
        want_losses.append(float(loss))

    losses, pst = _port_steps(params, batches, keys, torch.float32)
    _, exact = _port_steps(params, batches, keys, torch.float64)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    beyond = 0
    for got_model, exact_model, want in (
        (pst.model, exact.model, to_numpy_tree(unravel(st.params))),
        (pst.ema_model, exact.ema_model, to_numpy_tree(unravel(st.ema_params))),
    ):
        want_sd = convert.flax_to_state_dict(want, got_model)
        exact_sd = exact_model.state_dict()
        for name, value in got_model.state_dict().items():
            got, ref = value.numpy(), want_sd[name].numpy()
            err, tol = np.abs(got - ref), 1e-5 * np.abs(ref) + 2e-6
            fp32_err = np.abs(got - exact_sd[name].numpy())
            over = err > tol
            beyond += int(over.sum())
            assert np.all(err[over] <= 2 * fp32_err[over]), (name, err[over], fp32_err[over])
    assert beyond <= 4


