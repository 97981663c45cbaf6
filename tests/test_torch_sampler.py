"""Port parity: CFG combine, the sampler step and the sampler against JAX; the engine's sampling paths.

The sampler runs on the same weights (seeded flax trees, bridged) and the
same draws (the JAX key tree, replayed by :class:`JaxSampleDraws`), in
float32 over 3 steps: the tiny UNet with its shared prefix (encode on B,
tail on 2B) and a tiny DiT without one (one 2B forward), from pure noise
and re-noised from t = 0.5. The engine tests run the port alone on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_UNET, JaxSampleDraws, random_params
from diffusion_classifier_tpu.diffusion import process as jp
from diffusion_classifier_tpu.diffusion.sampler import make_sampler as jax_make_sampler
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule
from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig
from diffusion_classifier_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
from diffusion_classifier_tpu.models.unet import UNetConfig as JaxUNetConfig
from diffusion_classifier_tpu_torch.data.synthetic import SyntheticDataLoader
from diffusion_classifier_tpu_torch.diffusion import process as tp
from diffusion_classifier_tpu_torch.diffusion.sampler import TorchSampleDraws, make_sampler
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)

C = 10
STEPS = 3
SAMPLER = dict(pred_param="v", cfg_w=0.3, null_token=C, sampling_steps=STEPS)
TINY_DIT = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=3, num_layers=1,
    sample_size=8, patch_size=2, num_classes=C, attn_backend="auto",
)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("pred_param", ["v", "eps"])
def test_cfg_combine_and_sampler_step_match_jax(pred_param):
    rng = np.random.default_rng(0)
    z, pred, u_pred = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        tp.cfg_combine(_t(pred), _t(u_pred), 0.3).numpy(),
        np.asarray(jp.cfg_combine(pred, u_pred, 0.3)), rtol=1e-6, atol=1e-6,
    )
    # per-sample logSNRs, and the scalar pair the sampler passes
    for lt, ls in ((np.float32([-2.0, 0.5, 3.0]), np.float32([-1.0, 1.5, 3.2])),
                   (np.float32(-0.3), np.float32(1.7))):
        want = jp.ddpm_sampler_step(z, pred, u_pred, lt, ls, cfg_w=0.3, pred_param=pred_param)
        got = tp.ddpm_sampler_step(
            _t(z), _t(pred), _t(u_pred), _t(lt), _t(ls), cfg_w=0.3, pred_param=pred_param
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _unet_pair():
    jden = JaxDenoiser(backbone=JaxUNet(JaxUNetConfig(**TINY_UNET)), encoder=JaxClassEmbedder(C, 16))
    port = Denoiser(UNetCondition2D(UNetConfig(**TINY_UNET)), ClassEmbedder(C, 16))
    return jden, port


def _dit_pair():
    return JaxDenoiser(backbone=JaxDiT(JaxDiTConfig(**TINY_DIT)), encoder=None), Denoiser(
        DiT(DiTConfig(**TINY_DIT))
    )


# fp32: both run the same steps on the same draws; they differ by the
# models' float32 rounding (~1e-6), which the steps carry along
@pytest.mark.parametrize(
    "backbone,from_t", [("unet", 1.0), ("unet", 0.5), ("dit", 1.0), ("dit", 0.5)]
)
def test_sampler_matches_jax_on_injected_draws(backbone, from_t):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    labels = np.array([3, C], np.int32)  # C: the null token, sampled unconditionally
    jden, port = _unet_pair() if backbone == "unet" else _dit_pair()
    params = random_params(jden.init, x, np.zeros(2, np.float32), labels, seed=2)
    port.load_state_dict(flax_to_state_dict(params, port))
    port.eval()
    prefix = backbone == "unet"

    jkw, tkw = {}, {}
    if prefix:
        jkw = dict(
            encode_fn=lambda p, z, lg: jden.apply(p, z, lg, None, mode="encode"),
            tail_fn=lambda p, s, lab: jden.apply(p, None, None, lab, mode="tail", prefix_state=s),
        )
        tkw = dict(
            encode_fn=lambda z, lg: port(z, lg, None, mode="encode"),
            tail_fn=lambda s, lab: port(None, None, lab, mode="tail", prefix_state=s),
        )
    key = jax.random.PRNGKey(3)
    jfn = jax_make_sampler(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab),
        jax_schedule("shifted_cosine", 64, 8), **SAMPLER, **jkw,
    )
    want = np.asarray(jax.jit(jfn, static_argnames="from_t")(params, x, labels, key, from_t=from_t))

    batches = []
    port.register_forward_hook(
        lambda m, args, out: batches.append(
            ("encode", args[0].shape[0]) if isinstance(out, tuple)
            else ("tail" if args[0] is None else "full", out.shape[0])
        )
    )
    tfn = make_sampler(port, make_schedule_fn("shifted_cosine", 64, 8), **SAMPLER, **tkw)
    got = tfn(_t(x), _t(labels).long(), JaxSampleDraws(key), from_t=from_t)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # S noisy steps and the final one: encode on B and tail on 2B, or one 2B forward
    per_step = [("encode", 2), ("tail", 4)] if prefix else [("full", 4)]
    assert batches == per_step * (STEPS + 1)


def _engine(tmp_path, **overrides):
    cfg = dict(
        data_path="synthetic", image_size=8, classes=C, encoder_type="nn",
        mixed_precision="no", batch_size=4, evaluation_per_stage=[2],
        evaluation_batches=0, sampling_steps=2, num_epochs=1, seed=4,
        project_root=str(tmp_path), experiment_dir="exp",
    )
    config = ExperimentConfig.from_dict({**cfg, **overrides})
    return DiffusionClassifier(UNetCondition2D(UNetConfig(**TINY_UNET)), config, device="cpu")


def test_engine_sample_and_evaluate_by_sampling(tmp_path):
    engine = _engine(tmp_path)
    with pytest.raises(RuntimeError, match="initialize"):
        engine.sample(np.zeros((2, 8, 8, 3), np.float32))
    engine.init_params()
    # the 'nn' encoder's width comes from the backbone's encoder_hid_dim
    assert engine.denoiser.encoder.embedding.weight.shape == (C + 1, 16)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    renoised = engine.sample(x, [1, 2], from_t=0.5, draws=TorchSampleDraws(torch.Generator().manual_seed(0)))
    again = engine.sample(x, [1, 2], from_t=0.5, draws=TorchSampleDraws(torch.Generator().manual_seed(0)))
    torch.testing.assert_close(renoised, again, rtol=0, atol=0)
    assert renoised.shape == x.shape and float(renoised.abs().max()) <= 1.0

    data = SyntheticDataLoader(16, 8, batch_size=4, image_size=8, classes=C, seed=4)
    samples, batches, metrics = engine.evaluate(data.get_val_loader(), stop_idx=0)
    assert metrics is None and len(samples) == len(batches) == 1
    assert samples[0].shape == (4, 8, 8, 3) and samples[0].device.type == "cpu"
    assert bool(torch.isfinite(samples[0]).all()) and float(samples[0].abs().max()) <= 1.0


def test_train_loop_hands_samples_to_plot_function(tmp_path):
    engine = _engine(tmp_path)
    data = SyntheticDataLoader(16, 8, batch_size=4, image_size=8, classes=C, seed=4)
    calls = []

    def plot_function(output_dir, batches, samples, epoch, process_idx):
        calls.append((output_dir, len(batches), tuple(samples[0].shape), epoch, process_idx))
        return None

    engine.train_loop(data.get_train_loader(), data.get_val_loader(), plot_function=plot_function)
    assert calls == [(str(tmp_path / "exp" / "training_images"), 1, (4, 8, 8, 3), 0, 0)]
    assert (tmp_path / "exp" / "training_images").is_dir()
    assert (tmp_path / "exp" / "checkpoints" / "ema_params.pt").is_file()
