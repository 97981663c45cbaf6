"""Port parity for the training path, and the port's training entry point end to end.

1. ``weighted_mse_loss``, the EMA, the learning-rate schedule and the
   clip + Adam optimizer against the JAX package's (and optax's).
2. Three train steps of a tiny DiT, with one and with two microbatches,
   against JAX ``make_train_step``: same bridged weights, the JAX key tree's
   draws replayed through :class:`JaxTrainDraws`.
3. The port's copies of the synthetic data set and its loader against the
   JAX package's.
4. A checkpoint round trip of the whole train state, and a resume that
   continues exactly.
5. ``experiments/chexpert-dit/train_torch.py`` on the CPU at a tiny size.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import JaxTrainDraws, to_numpy_tree
from diffusion_classifier_tpu.data.synthetic import SyntheticDataLoader as JaxSynthetic
from diffusion_classifier_tpu.data.synthetic import make_synthetic_arrays as jax_arrays
from diffusion_classifier_tpu.diffusion.process import weighted_mse_loss as jax_wmse
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
from diffusion_classifier_tpu.engine import state as jax_state
from diffusion_classifier_tpu.engine import steps as jax_steps
from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig
from diffusion_classifier_tpu_torch.data.synthetic import SyntheticDataLoader, make_synthetic_arrays
from diffusion_classifier_tpu_torch.diffusion.process import weighted_mse_loss
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
from diffusion_classifier_tpu_torch.engine import state
from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
from diffusion_classifier_tpu_torch.engine.steps import make_loss_fn, make_train_step
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("pred_param", ["v", "eps"])
def test_weighted_mse_loss_matches_jax(pred_param):
    rng = np.random.default_rng(0)
    pred, z, eps = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(3))
    logsnr = rng.uniform(-8, 8, 3).astype(np.float32)
    want = jax_wmse(*(jnp.asarray(a) for a in (pred, z, eps, logsnr)), pred_param)
    got = weighted_mse_loss(*(torch.from_numpy(a) for a in (pred, z, eps, logsnr)), pred_param)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_ema_decay_and_update_match_jax():
    cfg = dict(beta=0.999, update_after_step=5, update_every=3)
    jcfg, tcfg = jax_state.EmaConfig(**cfg), state.EmaConfig(**cfg)
    rng = np.random.default_rng(1)
    ema, params = rng.standard_normal(7).astype(np.float32), rng.standard_normal(7).astype(np.float32)
    t_ema = [torch.from_numpy(ema.copy())]
    j_ema = jnp.asarray(ema)
    for counter in range(0, 40):
        assert state.ema_decay(counter, tcfg) == pytest.approx(
            float(jax_state.ema_decay(jnp.asarray(counter), jcfg)), rel=1e-6, abs=1e-7
        )
        j_ema = jax_state.ema_update(j_ema, jnp.asarray(params), jnp.asarray(counter), jcfg)
        state.ema_update(t_ema, [torch.from_numpy(params)], counter, tcfg)
    np.testing.assert_allclose(t_ema[0].numpy(), np.asarray(j_ema), rtol=1e-6, atol=1e-7)


def test_schedule_matches_jax():
    jsched = jax_state.cosine_warmup_schedule(2e-4, 100, 1000)
    tsched = state.cosine_warmup_schedule(2e-4, 100, 1000)
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 1200):
        want = float(jsched(step))
        assert tsched(step) == pytest.approx(want, rel=1e-6, abs=1e-12)
        # lr_at, the float64 host mirror for logging, differs near the end of
        # the cosine by float32's rounding of the schedule: a few 1e-12 here
        assert state.lr_at(2e-4, 100, 1000, step) == pytest.approx(want, rel=1e-5, abs=1e-10)


@pytest.mark.parametrize("scale", [1e-3, 10.0])  # global norm below / above the 1.0 clip
def test_optimizer_matches_optax(scale):
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (4,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_state.make_optimizer(1e-2, 2, 6)
    j_params = list(map(jnp.asarray, params))
    j_opt = tx.init(j_params)
    opt = state.make_optimizer(1e-2, 2, 6)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    t_opt = opt.init(t_params)
    for _ in range(4):
        grads = [scale * rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, j_opt = tx.update(list(map(jnp.asarray, grads)), j_opt, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update([torch.from_numpy(g) for g in grads], t_opt, t_params)
    assert t_opt.count == 4
    for got, want in zip(t_params, j_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_bf16_optimizer_state_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        state.make_optimizer(1e-4, 1, 2, state_dtype="bf16")
    with pytest.raises(ValueError):
        state.make_optimizer(1e-4, 1, 2, state_dtype="fp16")


# 2 layers, 2 heads x 32 (width 64), 32 px at patch 4: 64 tokens
TINY = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=4, num_layers=2,
    sample_size=32, patch_size=4, num_classes=3,
)
TRAIN = dict(lr=1e-3, warmup=2, total=3, ema=dict(beta=0.9999, update_after_step=1, update_every=1))


def _jax_train(params, batches, keys, k):
    """The JAX package's three train steps (XLA attention: the Pallas backward is held to the port's in test_torch_ops)."""
    dit = JaxDiT(JaxDiTConfig(**TINY, attn_backend="xla"))
    schedule = jax_schedule_fn("shifted_cosine", 64, 32)
    loss_fn = jax_steps.make_loss_fn(
        lambda p, z, lg, lab: dit.apply(p, z, lg, lab), schedule, pred_param="v", null_token=3
    )
    tx = jax_state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    step = jax_steps.make_train_step(
        loss_fn, tx, jax_state.EmaConfig(**TRAIN["ema"]), grad_accum_steps=k, donate=False
    )
    st = jax_state.init_train_state(params, tx)
    losses = []
    for (x, y), key in zip(batches, keys):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y), key)
        losses.append(float(loss))
    return losses, to_numpy_tree(st.params), to_numpy_tree(st.ema_params)


# fp32 on both sides; they differ in summation order (matmuls, attention,
# the global norm) and in where float32 rounds Adam's and the EMA's scalars.
# Held to rtol 1e-5 / atol 2e-6 (losses to rtol 1e-5). One exception: the
# key third of each qkv bias has a gradient that is zero in exact arithmetic
# (softmax ignores a shift shared by all keys), so both sides hold rounding
# noise there, which Adam's normalisation turns into steps of size ~lr and
# arbitrary sign; those entries are held to 2·lr.
@pytest.fixture(scope="module")
def tiny_run():
    rng = np.random.default_rng(5)
    batches = [
        (rng.uniform(-1, 1, (4, 32, 32, 4)).astype(np.float32), rng.integers(0, 3, 4).astype(np.int32))
        for _ in range(3)
    ]
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    x0, y0 = batches[0]
    init = jax.jit(JaxDiT(JaxDiTConfig(**TINY)).init)
    params = to_numpy_tree(init(jax.random.PRNGKey(0), x0, np.zeros(4, np.float32), y0))
    return params, batches, keys


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_jax(tiny_run, accum):
    params, batches, keys = tiny_run
    want_losses, want_params, want_ema = _jax_train(params, batches, keys, accum)

    model = Denoiser(DiT(DiTConfig(**TINY, attn_backend="auto")))
    model.backbone.load_state_dict(flax_to_state_dict(params, model.backbone))
    loss_fn = make_loss_fn(
        model, make_schedule_fn("shifted_cosine", 64, 32), pred_param="v", null_token=3
    )
    tx = state.make_optimizer(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    st = state.init_train_state(model, tx)
    step = make_train_step(loss_fn, tx, state.EmaConfig(**TRAIN["ema"]), grad_accum_steps=accum)
    losses = [
        step(st, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), JaxTrainDraws(key)).item()
        for (x, y), key in zip(batches, keys)
    ]
    assert (st.step, st.ema_counter, st.opt_state.count) == (3, 3, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for got_model, want in ((st.model.backbone, want_params), (st.ema_model.backbone, want_ema)):
        want_sd = flax_to_state_dict(want, got_model)
        for name, value in got_model.state_dict().items():
            got_np, want_np = value.numpy(), want_sd[name].numpy()
            if name.endswith("qkv.bias"):
                width = got_np.shape[0] // 3
                key = slice(width, 2 * width)
                np.testing.assert_allclose(got_np[key], want_np[key], rtol=0, atol=2 * TRAIN["lr"])
                got_np, want_np = np.delete(got_np, key), np.delete(want_np, key)
            np.testing.assert_allclose(got_np, want_np, rtol=1e-5, atol=2e-6, err_msg=name)


def test_remat_recomputes_blocks_with_the_same_gradients():
    x = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32))
    t, y = torch.tensor([0.5, -1.0]), torch.tensor([0, 2])
    grads = []
    for remat in (False, True):
        model = DiT(DiTConfig(**TINY, remat=remat))
        model.reset_parameters(torch.Generator().manual_seed(0))
        model(x, t, y).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_synthetic_data_copies_match_jax():
    kw = dict(batch_size=8, image_size=8, channels=3, classes=2, seed=3)
    xs, ys, templates = make_synthetic_arrays(40, image_size=8, channels=3, classes=2, seed=3)
    jxs, jys, jtemplates = jax_arrays(40, image_size=8, channels=3, classes=2, seed=3)
    for got, want in ((xs, jxs), (ys, jys), (templates, jtemplates)):
        np.testing.assert_array_equal(got, want)
    port, ref = SyntheticDataLoader(24, 16, **kw), JaxSynthetic(24, 16, **kw)
    for _ in range(2):  # the train split reshuffles every epoch, by seed
        for get in ("get_train_loader", "get_val_loader"):
            got, want = list(getattr(port, get)()), list(getattr(ref, get)())
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["images"], b["images"])
                np.testing.assert_array_equal(a["prompt"], b["prompt"])


# 8 px → DWT 4x4x12 → patch 2: 4 tokens; 2 layers keep the CPU run short
ENGINE_CONFIG = dict(
    data_path="synthetic", image_size=8, image_channels=3, wavelet_transform=True,
    classes=2, encoder_type="DiT", mixed_precision="no", batch_size=8,
    evaluation_per_stage=[1], evaluation_batches=0, learning_rate=1e-3,
    lr_warmup_steps=1, ema_warmup=0, ema_update_freq=1, seed=3,
)
ENGINE_DIT = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=12, out_channels=12,
    num_layers=2, sample_size=4, patch_size=2, num_classes=2,
)


def _engine(tmp_path, **overrides):
    config = ExperimentConfig.from_dict(
        dict(ENGINE_CONFIG, project_root=str(tmp_path), experiment_dir="exp", **overrides)
    )
    return DiffusionClassifier(DiT(DiTConfig(**ENGINE_DIT)), config, device="cpu")


def test_checkpoint_round_trip_and_resume(tmp_path):
    batches = list(SyntheticDataLoader(16, 8, batch_size=8, image_size=8, classes=2, seed=4).get_train_loader())
    trained = _engine(tmp_path)
    trained.init_params()
    trained._build_train_state(total_steps=4)
    for batch in batches:
        trained.train_step(batch)
    trained.save_checkpoint(1, "key0", {"value": 0.5, "save_flag": True})
    exp = tmp_path / "exp"
    for folder in ("checkpoints", "best_checkpoint"):
        assert json.loads((exp / folder / "experiment_state.json").read_text()) == {
            "epoch": 2, "best_metric": 0.5, "experiment_key": "key0"
        }

    resumed = _engine(tmp_path, seed=9)  # other init weights: all must come from the files
    resumed.init_params()
    resumed._build_train_state(total_steps=4)
    assert resumed.load_checkpoint(str(exp / "checkpoints")) == (2, 0.5, "key0")
    a, b = trained.state, resumed.state
    assert (b.step, b.ema_counter, b.opt_state.count) == (a.step, a.ema_counter, a.opt_state.count) == (2, 2, 2)
    for x, y in zip(a.params() + a.ema_params() + a.opt_state.mu + a.opt_state.nu,
                    b.params() + b.ema_params() + b.opt_state.mu + b.opt_state.nu):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the next step continues exactly: same state, same draws
    resumed.generator.manual_seed(11)
    trained.generator.manual_seed(11)
    torch.testing.assert_close(resumed.train_step(batches[0]), trained.train_step(batches[0]), rtol=0, atol=0)
    for x, y in zip(a.params() + a.ema_params(), b.params() + b.ema_params()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    # inference reads the EMA parameters alone
    evaluator = _engine(tmp_path)
    evaluator.init_params()
    evaluator.load_checkpoint(str(exp / "best_checkpoint"), train_state=False)
    for x, y in zip(evaluator.state.ema_params(), resumed.state.ema_params()):
        assert not torch.equal(x, y)  # resumed took one more step since the save
    assert evaluator.state.opt_state is None and evaluator.state.step == 0


class _FixedDraws:
    def __init__(self, seed):
        self.generator = torch.Generator().manual_seed(seed)

    def loss(self, micro, n_micro, batch, x_shape):
        self.generator.manual_seed(0)
        g = self.generator
        return torch.rand(batch, generator=g), torch.rand(batch, generator=g), torch.randn(x_shape, generator=g)


def test_engine_loss_uses_training_params_without_dropout(tmp_path):
    eng = _engine(tmp_path)
    eng.init_params()
    x = np.random.default_rng(6).uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    draws = _FixedDraws(0)
    loss = eng.loss(x, draws=draws)
    assert loss.ndim == 0 and torch.isfinite(loss)
    with torch.no_grad():  # scaling the EMA copy leaves the loss alone
        for p in eng.state.ema_params():
            p.mul_(2.0)
    torch.testing.assert_close(eng.loss(x, draws=draws), loss, rtol=0, atol=0)


def test_train_torch_runs_on_cpu(tmp_path, monkeypatch, capsys):
    import importlib.util

    # the experiment's full-width DiT-b4 (32.6M parameters) at one token per
    # image: 8 px → DWT 4x4x12 → patch 4
    config = dict(
        ENGINE_CONFIG, mixed_precision="bf16", patch_size=4, batch_size=64, num_epochs=1,
        log_every_steps=1, use_comet=True, project_root=str(tmp_path), experiment_dir="exp",
    )
    monkeypatch.setenv("TRAINING_CONFIG", json.dumps(config))
    path = os.path.join(REPO, "experiments", "chexpert-dit", "train_torch.py")
    spec = importlib.util.spec_from_file_location("train_torch", path)
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    engine = train_torch.main(["--device", "cpu"])
    assert engine.state.step == 256 // 64
    exp = tmp_path / "exp"
    events = [json.loads(line) for line in (exp / "track.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e.get("name") == "loss" and e.get("step") is not None]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert any(e.get("name") == "val_f1" for e in events)
    for name in ("ema_params.pt", "train_state.pt", "experiment_state.json"):
        assert (exp / "checkpoints" / name).is_file()
    out = capsys.readouterr().out
    assert "step 4/4" in out and "Checkpoint saved" in out
