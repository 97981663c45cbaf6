"""Port parity for the text-conditioned ('t5') path: the class table, its encoder, the UNet, the engine.

1. ``build_t5_class_table`` with ``tests/test_t5_encoder.py``'s tiny T5
   (``FlaxT5EncoderModel(seed=0)``, its weights carried into the torch
   ``T5EncoderModel``) and stub tokenizer against the JAX table: the null
   row, the all-pad mask fix-up, the caller's mask left as it was.
2. ``FrozenTableEncoder`` / ``make_encoder('t5')`` against the JAX module,
   and the errors of a missing or misshaped table.
3. The narrow t5 UNet (``_torch_parity.T5_UNET``: its table is 16 wide,
   its ``encoder_hid_dim`` 24) with and without ``text_proj``: the flax tree
   converts leaf for leaf (``encoder_hid_proj`` or ``to_k``/``to_v`` at the
   table's width, ``to_q``/``to_k``/``norm2`` for the 6-token context), the
   forward matches JAX and tail ∘ encode is the full forward.
4. The engine: the table from ``t5_table_path``, the backbone's context
   checked, ``encode_text_prompt`` against the JAX engine's.
5. ``experiments/cifar10/{train,inference}_torch.py`` on the CPU with
   ``encoder_type "t5"`` and a table file, at a quarter of the flagship's
   width.

Classification, training and sampling on this path are in
``tests/test_torch_t5_train.py``.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    T5_CLASSES,
    T5_UNET,
    random_params,
    seeded_t5_table,
    t5_denoisers,
    write_cifar_batches,
)
from diffusion_classifier_tpu.engine import DiffusionClassifier as JaxDiffusionClassifier
from diffusion_classifier_tpu.models.encoders import FrozenTableEncoder as JaxFrozenTableEncoder
from diffusion_classifier_tpu.models.encoders import build_t5_class_table as jax_build_t5_class_table
from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
from diffusion_classifier_tpu.models.unet import UNetConfig as JaxUNetConfig
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
from diffusion_classifier_tpu_torch.engine.diffusion_classifier import t5_class_table
from diffusion_classifier_tpu_torch.experiments import cifar10
from diffusion_classifier_tpu_torch.models.encoders import (
    FrozenTableEncoder,
    build_t5_class_table,
    make_encoder,
)
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import costs seconds, unused
transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["cat", "dog", "frog"]


def stub_tokenize(texts, max_length):
    """``tests/test_t5_encoder.py``'s tokenizer: characters to ids, 0 (pad) after the text."""
    ids = np.zeros((len(texts), max_length), np.int32)
    for i, t in enumerate(texts):
        for j, ch in enumerate(t[:max_length]):
            ids[i, j] = (ord(ch) % 63) + 1
    return ids


@functools.lru_cache(maxsize=1)
def tiny_t5_pair():
    """``(FlaxT5EncoderModel(seed=0), torch T5EncoderModel with its weights)`` of the JAX test's config."""
    cfg = transformers.T5Config(d_model=16, d_ff=32, num_layers=1, num_heads=2, vocab_size=64, d_kv=8)
    flax_model = transformers.FlaxT5EncoderModel(cfg, seed=0)
    torch_model = transformers.T5EncoderModel(cfg)
    sd = {}
    for path, value in jax.tree_util.tree_flatten_with_path(flax_model.params)[0]:
        *mods, leaf = [str(k.key) for k in path]
        value = np.asarray(value)
        if leaf == "kernel":  # Dense [in, out] -> Linear [out, in]
            value = value.T
        sd[".".join(mods + ["weight"])] = torch.from_numpy(np.ascontiguousarray(value))
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]  # tied, as in the flax model
    torch_model.load_state_dict(sd, strict=True)
    return flax_model, torch_model.eval()


# fp32 on both sides (one T5 layer, 6 tokens): they differ by the summation
# order of the matmuls and the softmax, ~1e-7 on unit-scale outputs
def test_t5_class_table_matches_jax():
    flax_model, torch_model = tiny_t5_pair()
    want = np.asarray(jax_build_t5_class_table(
        CLASSES, model=flax_model, max_length=6, tokenize_fn=stub_tokenize
    ))
    got = build_t5_class_table(CLASSES, model=torch_model, max_length=6, tokenize_fn=stub_tokenize)
    assert got.shape == want.shape == (4, 6, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the null row (the empty text: all pad, so one position kept) differs from the classes'
    assert np.abs(got[0] - got[3]).max() > 1e-6

    # the all-pad fix-up: a caller's (ids, mask) pair, its mask left as it was
    ids = stub_tokenize(CLASSES + [""], 6)
    mask = (ids != 0).astype(np.int32)
    before = mask.copy()
    got_pair = build_t5_class_table(CLASSES, model=torch_model, max_length=6,
                                    tokenize_fn=lambda texts, n: (ids, mask))
    np.testing.assert_array_equal(mask, before)
    assert mask[3].sum() == 0  # the null row is all pad ...
    np.testing.assert_allclose(got_pair, got, atol=0, rtol=0)  # ... and attends position 0 in both
    # without the fix-up the null row would attend nothing: an explicit one-position mask gives it
    fixed = mask.copy()
    fixed[3, 0] = 1
    np.testing.assert_allclose(
        build_t5_class_table(CLASSES, model=torch_model, max_length=6,
                             tokenize_fn=lambda texts, n: (ids, fixed)),
        got, atol=0, rtol=0,
    )


def test_frozen_table_encoder_matches_jax_and_make_encoder_checks():
    table = seeded_t5_table(1)
    labels = np.array([0, 3, 2, 3], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JaxFrozenTableEncoder(jnp.asarray(table), dtype=jdt).apply({"params": {}}, labels)
        enc, null = make_encoder("t5", num_classes=T5_CLASSES, t5_table=table, dtype=tdt)
        assert isinstance(enc, FrozenTableEncoder) and null == T5_CLASSES
        got = enc(torch.from_numpy(labels))
        assert got.dtype == tdt and got.shape == (4, 6, 16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # a buffer, not a parameter: no optimizer, EMA or checkpoint holds it
    assert list(enc.parameters()) == [] and enc.state_dict() == {}
    assert [n for n, _ in enc.named_buffers()] == ["table"]
    with pytest.raises(ValueError, match="precomputed"):
        make_encoder("t5", num_classes=T5_CLASSES)
    with pytest.raises(ValueError, match=r"\[4, S, D\]"):
        make_encoder("t5", num_classes=T5_CLASSES, t5_table=table[:3])


@pytest.mark.parametrize("hid_type", ["text_proj", None])
def test_t5_unet_tree_and_forward_match_jax(hid_type):
    table = seeded_t5_table(2)
    jden, port = t5_denoisers(table, hid_type)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    lg = rng.uniform(-5, 5, 3).astype(np.float32)
    y = np.array([0, 2, T5_CLASSES], np.int32)  # the last: the null row
    params = random_params(jden.init, x, lg, y, seed=4)
    sd = flax_to_state_dict(params, port)  # raises on a missing or extra leaf
    assert set(sd) == set(port.state_dict())
    attn2 = "backbone.down_1_attn_0.blocks.0.attn2"
    if hid_type == "text_proj":
        # flax's Dense took the table's width 16, not encoder_hid_dim 24
        assert sd["backbone.encoder_hid_proj.weight"].shape == (16, 16)
        assert sd[f"{attn2}.to_k.weight"].shape == (32, 16)
    else:
        assert "backbone.encoder_hid_proj.weight" not in sd
        assert sd[f"{attn2}.to_k.weight"].shape == sd[f"{attn2}.to_v.weight"].shape == (32, 16)
    # a 6-token context: the full cross-attention, with its query and pre-norm
    assert f"{attn2}.to_q.weight" in sd and "backbone.down_1_attn_0.blocks.0.norm2.weight" in sd
    port.load_state_dict(sd)
    port.eval()
    want = np.asarray(jax.jit(jden.apply)(params, x, lg, y))
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in (x, lg, y)]
        full = port(*t)
        tail = port(None, None, t[2], mode="tail", prefix_state=port(t[0], t[1], None, mode="encode"))
    np.testing.assert_allclose(full.numpy(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(tail, full, rtol=0, atol=0)


def test_unet_built_for_the_encoder_hid_dim_does_not_take_the_table():
    # the trap: a UNet built as for the 'nn' embedder has a [24 -> 16] projection
    cfg = UNetConfig(**T5_UNET)
    assert UNetCondition2D(cfg).encoder_hid_proj.weight.shape == (16, 24)
    assert UNetCondition2D(cfg, context_tokens=6, context_dim=16).encoder_hid_proj.weight.shape == (16, 16)


ENGINE = dict(
    data_path="synthetic", image_size=8, image_channels=1, classes=T5_CLASSES, encoder_type="t5",
    mixed_precision="no", batch_size=4, evaluation_per_stage=[2], evaluation_batches=0,
)


def test_engine_t5_table_and_encode_text_prompt_match_jax(tmp_path):
    table = seeded_t5_table(5)
    path = str(tmp_path / "table.npy")
    np.save(path, table)
    cfg = dict(ENGINE, t5_table_path=path)
    config = ExperimentConfig.from_dict(dict(cfg))
    np.testing.assert_array_equal(t5_class_table(config), table)
    backbone = UNetCondition2D(UNetConfig(**T5_UNET), context_tokens=6, context_dim=16)
    eng = DiffusionClassifier(backbone, config, device="cpu")
    assert eng.null_token == T5_CLASSES
    labels = np.array([1, T5_CLASSES, 0], np.int32)
    with pytest.raises(RuntimeError, match="initialize"):
        eng.encode_text_prompt(labels)
    eng.init_params()
    got = eng.encode_text_prompt(labels)
    assert eng.state.ema_model.encoder is not None  # the EMA copy's table

    jeng = JaxDiffusionClassifier(
        JaxUNet(JaxUNetConfig(**T5_UNET, attn_backend="xla")), JaxExperimentConfig.from_dict(dict(cfg))
    )
    # its parameters from eval_shape (an init compiles the UNet op by op)
    jeng._init_params = random_params(
        jeng.denoiser.init, np.zeros((1, 8, 8, 1), np.float32), np.zeros(1, np.float32),
        np.zeros(1, np.int32),
    )
    jeng._build_train_state(1)
    want = np.asarray(jeng.encode_text_prompt(labels))
    assert got.shape == want.shape == (3, 6, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, table[labels])  # the table's rows, the null row last

    # a backbone built for another context, or one that takes none, is refused
    with pytest.raises(ValueError, match="context_tokens=S"):
        DiffusionClassifier(UNetCondition2D(UNetConfig(**T5_UNET)), config, device="cpu")
    with pytest.raises(FileNotFoundError):
        DiffusionClassifier(backbone, ExperimentConfig.from_dict(
            dict(cfg, t5_table_path=str(tmp_path / "missing.npy"))), device="cpu")


def test_engine_encode_text_prompt_passes_labels_without_an_encoder():
    from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig

    dit = DiT(DiTConfig(num_attention_heads=2, attention_head_dim=32, in_channels=1, num_layers=1,
                        sample_size=8, patch_size=4, num_classes=T5_CLASSES))
    eng = DiffusionClassifier(dit, ExperimentConfig.from_dict(dict(ENGINE, encoder_type="DiT")),
                              device="cpu")
    got = eng.encode_text_prompt(np.array([2, 0], np.int32))
    assert got.tolist() == [2, 0]


# --- the entry points, on the CPU ------------------------------------------------

_FULL_WIDTH = cifar10.build_backbone


def _quarter_width(config):
    """The flagship at a quarter of its width, built for the config's t5 table as the experiment builds it."""
    with torch.device("meta"):
        full = _FULL_WIDTH(config)
    cfg = dataclasses.replace(
        full.config, block_out_channels=tuple(c // 4 for c in full.config.block_out_channels),
        encoder_hid_dim=full.config.encoder_hid_dim // 4,
        cross_attention_dim=full.config.cross_attention_dim // 4, norm_num_groups=8,
    )
    return UNetCondition2D(cfg, torch.float32, context_tokens=full.context_tokens,
                           context_dim=full.context_dim)


def _script(name):
    path = os.path.join(REPO, "experiments", "cifar10", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"cifar10_{name}_t5", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cifar10_scripts_run_t5_from_a_table_on_cpu(tmp_path, monkeypatch, capsys):
    # 2 classes: a [3, 8, 48] table (8 tokens, wider than the narrow net's
    # encoder_hid_dim of 32); 5 train images make one step at B=5
    monkeypatch.setattr(cifar10, "build_backbone", _quarter_width)
    write_cifar_batches(tmp_path / "data" / "cifar-10-batches-py", n_train=1, n_test=5, classes=2)
    table = np.random.default_rng(6).standard_normal((3, 8, 48)).astype(np.float32)
    np.save(tmp_path / "table.npy", table)
    config = dict(
        data_path=str(tmp_path / "data"), classes=2, encoder_type="t5",
        t5_table_path=str(tmp_path / "table.npy"), mixed_precision="no", batch_size=5,
        num_epochs=1, log_every_steps=1, evaluation_per_stage=[1], evaluation_batches=0,
        sampling_steps=1, project_root=str(tmp_path), experiment_dir="exp",
    )
    monkeypatch.setenv("TRAINING_CONFIG", json.dumps(config))
    engine = _script("train_torch").main(["--device", "cpu"])
    backbone = engine.denoiser.backbone
    assert engine.state.step == 1
    assert (backbone.context_tokens, backbone.context_dim) == (8, 48)
    assert backbone.encoder_hid_proj.weight.shape == (32, 48)
    ckpt = tmp_path / "exp" / "checkpoints"
    assert (ckpt / "ema_params.pt").is_file() and (tmp_path / "exp" / "training_images").is_dir()
    assert "step 1/1" in capsys.readouterr().out

    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(config))
    metric_output, preds, _ = _script("inference_torch").main(["--device", "cpu"])
    assert len(preds) == 1 and preds[0].shape == (5,) and set(preds[0].tolist()) <= {0, 1}
    assert 0.0 <= metric_output[0]["classification accuracy"] <= 1.0
    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(dict(config, classification=False)))
    saved = []
    samples, _ = _script("inference_torch").main(
        ["--device", "cpu"], plot_function=lambda **kw: saved.append(kw["samples"])
    )
    assert samples[0].shape == (5, 32, 32, 3) and float(samples[0].abs().max()) <= 1.0
    assert len(saved) == 1
