"""Port parity for the CheXpert UNet experiment (``experiments/chexpert-unet``).

1. The port's ``build_backbone`` has the JAX experiment's configuration,
   field for field, and at full width (220,427,532 parameters) the bridged
   JAX ``eval_shape`` tree has exactly the port's names and shapes (on the
   ``meta`` device: nothing is allocated).
2. At a narrow width (:data:`_torch_parity.CHEXPERT_UNET_NARROW`: the same
   levels, blocks and 8 heads) on a DWT-sized input, with the same seeded
   weights through the bridge: the fp32 forward within relative L2 1e-4 of
   JAX's, the prefix classifier's predictions identical on injected draws,
   two train steps against JAX ``make_train_step`` (loss and parameters at
   rtol 1e-5).
3. ``experiments/chexpert-unet/train_torch.py`` then ``inference_torch.py``
   on the CPU, on a CheXpert tree written under ``tmp_path``, at the narrow
   width: the checkpoint, the metrics and the mistakes file.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    CHEXPERT_UNET_NARROW,
    JaxDraws,
    JaxTrainDraws,
    jax_chexpert_unet_common,
    narrow_chexpert_unet,
    random_params,
    rel_l2,
    to_numpy_tree,
    write_chexpert_tree,
)
from diffusion_classifier_tpu.diffusion.classify import make_classifier as jax_make_classifier
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
from diffusion_classifier_tpu.engine import state as jax_state
from diffusion_classifier_tpu.engine import steps as jax_steps
from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
from diffusion_classifier_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from diffusion_classifier_tpu_torch.diffusion.classify import make_classifier
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine import state
from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn, make_train_step
from diffusion_classifier_tpu_torch.experiments import chexpert_unet
from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D
from diffusion_classifier_tpu_torch.utils import convert
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 2
# the experiment's data: 256 px through the Haar DWT, 2 classes
CONFIG = dict(image_size=256, image_channels=3, wavelet_transform=True, classes=C,
              encoder_type="nn", mixed_precision="no")


@pytest.fixture(scope="module")
def jax_common():
    return jax_chexpert_unet_common()


def _jax_backbone(jax_common, **config):
    return jax_common.build_backbone(JaxExperimentConfig(**dict(CONFIG, **config)))


def test_backbone_config_matches_the_jax_experiment(jax_common):
    for config in (dict(), dict(remat=True, mixed_precision="bf16", attn_backend="xla")):
        want = dataclasses.asdict(_jax_backbone(jax_common, **config).config)
        with torch.device("meta"):
            port = chexpert_unet.build_backbone(ExperimentConfig(**dict(CONFIG, **config)))
        got = dataclasses.asdict(port.config)
        assert {k: got[k] for k in want if k in got} == {k: v for k, v in want.items() if k in got}
        assert set(want) - set(got) <= {"dtype"}
        assert got["sample_size"] == 128 and got["in_channels"] == 12
        assert port.dtype == (torch.bfloat16 if config else torch.float32)


def test_full_width_tree_converts_exactly(jax_common):
    net = _jax_backbone(jax_common)
    jden = JaxDenoiser(backbone=net, encoder=JaxClassEmbedder(C, 256))
    shapes = jax.eval_shape(
        jden.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 128, 128, 12), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32), jax.ShapeDtypeStruct((1,), jnp.int32),
    )
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    backbone = sum(int(np.prod(s.shape)) for p, s in leaves if str(p[0].key) == "backbone")
    assert backbone == 220_427_532 and len(leaves) == 345
    with torch.device("meta"):
        port = Denoiser(chexpert_unet.build_backbone(ExperimentConfig(**CONFIG)), ClassEmbedder(C, 256))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {}
    for path, leaf in leaves:
        keys = tuple(str(p.key) for p in path)
        name = convert._torch_name(keys)
        zeros = np.broadcast_to(np.float32(0), leaf.shape)  # no memory
        got[name] = tuple(convert._convert_leaf(keys[-1], zeros, len(want.get(name, ()))).shape)
    assert got == want
    # 8 heads of 96 in the mid block's self-attention (outside the flash
    # kernels' gate); its one-token cross-attention has no to_q or to_k
    assert want["backbone.mid_attn_0.blocks.0.attn1.to_q.weight"] == (768, 768)
    assert "backbone.mid_attn_0.blocks.0.attn2.to_q.weight" not in want


# --- the narrow network -------------------------------------------------------------

B = 16  # class_chunk=-1 scores 1 class a chunk at B >= 16


@pytest.fixture(scope="module")
def narrow(jax_common):
    """JAX and port denoisers at the narrow width, the same seeded weights, inputs 8 x 8 x 12 (16 px)."""
    net = _jax_backbone(jax_common, image_size=16)
    jden = JaxDenoiser(
        backbone=JaxUNet(dataclasses.replace(net.config, **CHEXPERT_UNET_NARROW)),
        encoder=JaxClassEmbedder(C, 16),
    )
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (4, 8, 8, 12)).astype(np.float32)
    lg = rng.uniform(-5, 5, 4).astype(np.float32)
    y = np.array([0, 1, C, 1], np.int32)  # C: the null token
    params = random_params(jden.init, x, lg, y, seed=22)
    return jden, params, (x, lg, y)


def _port(params):
    model = Denoiser(narrow_chexpert_unet(ExperimentConfig(**dict(CONFIG, image_size=16))), ClassEmbedder(C, 16))
    model.load_state_dict(convert.flax_to_state_dict(params, model))
    return model


def test_narrow_forward_matches_jax(narrow):
    jden, params, args = narrow
    want = np.asarray(jax.jit(jden.apply)(params, *args))
    port = _port(params)
    assert port.backbone.prefix_split == 2  # levels 0-1 are condition-free
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in args])
    assert rel_l2(got.numpy(), want) <= 1e-4


def test_narrow_prefix_classify_matches_jax(narrow):
    jden, params, _ = narrow
    x = np.random.default_rng(23).uniform(-1, 1, (B, 8, 8, 12)).astype(np.float32)
    schedule = ("shifted_cosine", 64, 256)  # name, noise_d, image_size
    protocol = dict(pred_param="v", num_classes=C, n_stages=1, evaluation_per_stage=(4,),
                    n_keep_per_stage=(1,))
    rng = jax.random.PRNGKey(24)
    jfn = jax.jit(jax_make_classifier(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab), jax_schedule_fn(*schedule),
        encode_fn=lambda p, z, lg: jden.apply(p, z, lg, None, mode="encode"),
        tail_fn=lambda p, s, lab: jden.apply(p, None, None, lab, mode="tail", prefix_state=s),
        **protocol,
    ))
    want = np.asarray(jfn(params, x, np.zeros(B, np.int32), rng))
    port = _port(params)
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
    cfg = narrow_chexpert_unet(ExperimentConfig(**dict(CONFIG, image_size=16))).config
    model = Denoiser(UNetCondition2D(cfg, dtype), ClassEmbedder(C, 16, dtype))
    model.load_state_dict(convert.flax_to_state_dict(params, model))
    model.to(dtype)
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


# Loss at rtol 1e-5; parameters at rtol 1e-5 / atol 2e-6, as the flagship's
# steps in test_torch_unet_train.py, where float32 allows it. Adam's step
# is scale-free (≈ lr·sign of the moment), so a gradient element that is a
# near-cancelling sum carries its float32 rounding, relative to itself, into
# a full-size update: in this network the port's own float32 steps lie up to
# 5.2e-6 from its float64 steps (2 of 1.9 M elements beyond 2e-6). Such an
# element is held within twice that measured float32 error instead, and no
# more than 4 elements may need it. Since the port's attention outside the
# kernels' gate (D=12 here) computes as jax.nn.dot_product_attention does,
# its fp32 steps sit closer to its float64 steps than JAX's do at one
# element (to_k of the level-2 attention: the port 1.6e-7 from float64, JAX
# 3.1e-6): the float32 error allowed is the larger of the two packages'.
def test_two_narrow_train_steps_match_jax(narrow):
    jden, params, _ = narrow
    rng = np.random.default_rng(25)
    batches = [(rng.uniform(-1, 1, (4, 8, 8, 12)).astype(np.float32), rng.integers(0, C, 4).astype(np.int32))
               for _ in range(2)]
    keys = jax.random.split(jax.random.PRNGKey(26), 2)
    loss_fn = jax_steps.make_loss_fn(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab),
        jax_schedule_fn("shifted_cosine", 64, 256), pred_param="v", null_token=C,
    )
    tx = jax_state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    step = jax_steps.make_train_step(loss_fn, tx, jax_state.EmaConfig(**TRAIN["ema"]), donate=False)
    st = jax_state.init_train_state(params, tx)
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
        (pst.model, exact.model, to_numpy_tree(st.params)),
        (pst.ema_model, exact.ema_model, to_numpy_tree(st.ema_params)),
    ):
        want_sd = convert.flax_to_state_dict(want, got_model)
        exact_sd = exact_model.state_dict()
        for name, value in got_model.state_dict().items():
            got, ref = value.numpy(), want_sd[name].numpy()
            err, tol = np.abs(got - ref), 1e-5 * np.abs(ref) + 2e-6
            exact_ref = exact_sd[name].numpy()
            fp32_err = np.maximum(np.abs(got - exact_ref), np.abs(ref - exact_ref))
            over = err > tol
            beyond += int(over.sum())
            assert np.all(err[over] <= 2 * fp32_err[over]), (name, err[over], fp32_err[over])
    assert beyond <= 4


# --- the entry points on the CPU ------------------------------------------------------


def _script(name):
    path = os.path.join(REPO, "experiments", "chexpert-unet", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"chexpert_unet_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_then_inference_torch_on_a_chexpert_tree(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(chexpert_unet, "build_backbone", narrow_chexpert_unet)
    tree = write_chexpert_tree(tmp_path / "chexpert", n_each=20)  # 32 train, 4 valid, 4 test
    config = dict(
        CONFIG, data_path=tree, image_size=16, batch_size=4, num_workers=2, num_epochs=1,
        evaluation_per_stage=[1], evaluation_batches=0, sampling_steps=1, log_every_steps=1,
        use_comet=True, decode_cache_dir=str(tmp_path / "cache"), project_root=str(tmp_path),
        experiment_dir="exp",
    )
    monkeypatch.setenv("TRAINING_CONFIG", json.dumps(config))
    engine = _script("train_torch").main(["--device", "cpu"])
    assert engine.state.step == 8
    exp = tmp_path / "exp"
    events = [json.loads(line) for line in (exp / "track.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert {"val_accuracy", "val_f1", "val_precision", "val_recall"} <= {e.get("name") for e in events}
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        assert (exp / "checkpoints" / name).is_file()
    assert list((exp / "training_images").glob("*/epoch_0_sample_0_process_0.png"))
    assert len(os.listdir(tmp_path / "cache")) == 32 + 4  # train and valid images, decoded once

    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(dict(config, use_comet=False)))
    metric_output, preds, batches = _script("inference_torch").main(["--device", "cpu"])
    assert [sorted(d) for d in metric_output] == [["accuracy"], ["f1"], ["precision"], ["recall"]]
    preds = np.concatenate([p.numpy() for p in preds])
    labels = np.concatenate([b["prompt"] for b in batches])
    assert preds.shape == (4,) and set(preds.tolist()) <= {0, 1}
    lines = (exp / "mistakes-ddpm-chexpert.txt").read_text().splitlines()
    assert len([line for line in lines if line]) == int((preds != labels).sum())
    assert all(line.startswith("train/patient") for line in lines if line)
    assert "mistakes written to" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "cache")) == 32 + 4 + 4
