"""Port parity for the IPMSA experiments: the UNet, its counterfactual explanation, the DiT.

1. The port's ``build_backbone`` has the JAX experiment's configuration
   field for field; at full width the bridged JAX ``eval_shape`` tree
   (408,537,896 backbone parameters in 884 leaves) has exactly the port's
   names and shapes, as the IPMSA DiT's (32,955,520) does (``meta`` device).
2. The IPMSA DiT, narrowed to 2 layers of 2 × 32
   (:data:`_torch_parity.IPMSA_DIT_NARROW`), through
   ``experiments/ipmsa-dit/train_torch.py`` then ``inference_torch.py`` on
   a tree of 8 px images (one token a patch).
3. An engine is freed as soon as its last reference goes.

The narrow UNet's parity is ``test_torch_ipmsa_unet.py``'s, the
explanation's ``test_torch_ipmsa_explain.py``'s: three files, so the test
runner's workers take them in parallel.
"""

import dataclasses
import gc
import importlib.util
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    IPMSA_CONFIG,
    IPMSA_DIT_NARROW,
    IPMSA_NARROW_DATA,
    jax_experiment_common,
    narrow_ipmsa_dit,
    narrow_ipmsa_unet,
    write_ipmsa_tree,
)
from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
from diffusion_classifier_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
from diffusion_classifier_tpu_torch.experiments import ipmsa, ipmsa_dit
from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
from diffusion_classifier_tpu_torch.utils import convert
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = IPMSA_CONFIG["classes"]
CONFIG = IPMSA_CONFIG
UNET_PARAMS, UNET_LEAVES = 408_537_896, 884
DIT_PARAMS = 32_955_520


@pytest.fixture(scope="module")
def jax_common():
    return jax_experiment_common("ipmsa")


def _jax_backbone(jax_common, **config):
    return jax_common.build_backbone(JaxExperimentConfig(**dict(CONFIG, **config)))


def test_backbone_config_matches_the_jax_experiment(jax_common):
    for config in (dict(), dict(remat=True, mixed_precision="bf16", attn_backend="xla")):
        want = dataclasses.asdict(_jax_backbone(jax_common, **config).config)
        with torch.device("meta"):
            port = ipmsa.build_backbone(ExperimentConfig(**dict(CONFIG, **config)))
        got = dataclasses.asdict(port.config)
        assert {k: got[k] for k in want if k in got} == {k: v for k, v in want.items() if k in got}
        assert set(want) - set(got) <= {"dtype"}
        assert got["sample_size"] == 128 and got["in_channels"] == 40
        assert port.dtype == (torch.bfloat16 if config else torch.float32)


def _converted_shapes(leaves, want):
    got = {}
    for path, leaf in leaves:
        keys = tuple(str(p.key) for p in path)
        name = convert._torch_name(keys)
        zeros = np.broadcast_to(np.float32(0), leaf.shape)  # no memory
        got[name] = tuple(convert._convert_leaf(keys[-1], zeros, len(want.get(name, ()))).shape)
    return got


def test_full_width_trees_convert_exactly(jax_common):
    # the parameters' shapes depend on neither the attention backend nor the
    # input's size: plain attention and 32 px trace in a fraction of the time
    net = _jax_backbone(jax_common, attn_backend="xla")
    jden = JaxDenoiser(backbone=net, encoder=JaxClassEmbedder(C, 256))
    shapes = jax.eval_shape(
        jden.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 32, 32, 40), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32), jax.ShapeDtypeStruct((1,), jnp.int32),
    )
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    backbone = [(p, s) for p, s in leaves if str(p[0].key) == "backbone"]
    assert sum(int(np.prod(s.shape)) for _, s in backbone) == UNET_PARAMS and len(backbone) == UNET_LEAVES
    with torch.device("meta"):
        port = Denoiser(ipmsa.build_backbone(ExperimentConfig(**CONFIG)), ClassEmbedder(C, 256))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert _converted_shapes(leaves, want) == want
    # 8 heads: 64 wide at level 3 (inside the kernels' gate), 96 at level 4 and mid (outside)
    assert want["backbone.down_3_attn_0.blocks.0.attn1.to_q.weight"] == (512, 512)
    assert want["backbone.mid_attn_0.blocks.0.attn1.to_q.weight"] == (768, 768)
    assert port.backbone.config.attention_head_dim == 8

    dit_config = JaxExperimentConfig(**dict(CONFIG, encoder_type="DiT", patch_size=4, attn_backend="xla"))
    dit = jax_experiment_common("ipmsa-dit").build_backbone(dit_config)
    shapes = jax.eval_shape(
        dit.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 128, 128, 40), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.float32), jax.ShapeDtypeStruct((1,), jnp.int32),
    )
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    assert sum(int(np.prod(s.shape)) for _, s in leaves) == DIT_PARAMS
    with torch.device("meta"):
        port = ipmsa_dit.build_backbone(ExperimentConfig(**dict(CONFIG, encoder_type="DiT", patch_size=4)))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert _converted_shapes(leaves, want) == want
    assert port.config.num_attention_heads == 6 and port.config.attention_head_dim == 64


# --- the IPMSA DiT's entry points ------------------------------------------------------


def _script(experiment, name):
    path = os.path.join(REPO, "experiments", experiment, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{experiment}_{name}".replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_dit_train_then_inference_torch_on_an_mri_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(ipmsa_dit, "build_backbone", narrow_ipmsa_dit)
    exp = tmp_path / "exp"
    # 8 px images (6 x 8 in-plane, padded): the DWT's 4 x 4 at patch 4 is one token
    write_ipmsa_tree(tmp_path / "volumes", exp / "split", counts=(8, 4, 4), shape=(5, 6, 8))
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "volumes"))
    config = dict(CONFIG, image_size=8, image_channels=6, slices=3, encoder_type="DiT", patch_size=4,
                  data_path="volumes", batch_size=4, num_workers=2, num_epochs=1, evaluation_per_stage=[1],
                  evaluation_batches=0, sampling_steps=1, log_every_steps=1, use_comet=True,
                  project_root=str(tmp_path), experiment_dir="exp")
    monkeypatch.setenv("TRAINING_CONFIG", json.dumps(config))
    saved = []
    engine = _script("ipmsa-dit", "train_torch").main(
        ["--device", "cpu"], plot_function=lambda **kw: saved.append(kw["epoch"]))
    assert engine.state.step == 2 and saved == [0]
    config_used = engine.denoiser.backbone.config
    assert {k: getattr(config_used, k) for k in IPMSA_DIT_NARROW} == IPMSA_DIT_NARROW
    assert (config_used.in_channels, config_used.sample_size, config_used.patch_size) == (24, 4, 4)
    events = [json.loads(line) for line in (exp / "track.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {"val_accuracy", "val_f1", "val_precision", "val_recall"} <= {e.get("name") for e in events}
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        assert (exp / "checkpoints" / name).is_file()

    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(dict(config, use_comet=False)))
    metric_output, preds, batches = _script("ipmsa-dit", "inference_torch").main(["--device", "cpu"])
    assert [sorted(d) for d in metric_output] == [["accuracy"], ["f1"], ["precision"], ["recall"]]
    preds = np.concatenate([p.numpy() for p in preds])
    assert preds.shape == (4,) and set(preds.tolist()) <= {0, 1}
    with pytest.raises(ValueError, match="DiT"):
        ipmsa_dit.build_engine(ExperimentConfig(**dict(config, encoder_type="nn")), device="cpu")


def test_an_engine_is_freed_without_the_cyclic_collector(monkeypatch):
    """Dropping an engine's last reference frees its parameters at once (explain builds one engine a label).

    Its sampler and classifier closures reach it through a weak proxy; a
    strong one made every engine a reference cycle, which kept a finished
    engine's parameters on the card until the cyclic collector ran.
    """
    monkeypatch.setattr(ipmsa, "build_backbone", narrow_ipmsa_unet)
    config = ExperimentConfig(**dict(CONFIG, **IPMSA_NARROW_DATA, evaluation_per_stage=[1]))
    engine = ipmsa.build_engine(config, device="cpu")
    engine.init_params()
    engine._build_train_state(total_steps=2)
    x = np.random.default_rng(38).uniform(-1, 1, (2, 32, 32, 6)).astype(np.float32)
    engine.train_step({"images": x, "prompt": np.array([0, 1])})
    assert engine.classify(x).shape == (2,)
    freed = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert freed() is None
    finally:
        gc.enable()
