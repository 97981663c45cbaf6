"""Port parity for the IPMSA counterfactual explanation: ``experiments/ipmsa/explain_torch.py`` vs JAX.

On an MRI tree written under ``tmp_path`` and the narrow UNet
(:func:`_torch_parity.narrow_ipmsa_pair`'s weights as the checkpoint's EMA
parameters), on the CPU: for each forced label the test batch re-noised to
t = 0.5 and sampled back over 2 steps, against JAX ``make_sampler(
from_t=0.5)`` on the same weights and the same draws (the JAX key tree
replayed through :class:`_torch_parity.JaxSampleDraws`), at relative L2
1e-4; the prompts forced, the samples finite in [-1, 1].
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    IPMSA_CONFIG,
    IPMSA_NARROW_DATA,
    JaxSampleDraws,
    narrow_ipmsa_pair,
    narrow_ipmsa_unet,
    rel_l2,
    write_ipmsa_tree,
)
from diffusion_classifier_tpu.diffusion.sampler import make_sampler as jax_make_sampler
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
from diffusion_classifier_tpu.ops.wavelet import haar_dwt2 as jax_dwt
from diffusion_classifier_tpu_torch.engine import diffusion_classifier as engine_module
from diffusion_classifier_tpu_torch.experiments import ipmsa
from diffusion_classifier_tpu_torch.utils import convert
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = IPMSA_CONFIG["classes"]


@pytest.fixture(scope="module")
def narrow():
    return narrow_ipmsa_pair()


def _script(experiment, name):
    path = os.path.join(REPO, "experiments", experiment, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{experiment}_{name}".replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STEPS = 2


def test_explain_torch_matches_jax_on_injected_draws(narrow, tmp_path, monkeypatch):
    jden, params, _ = narrow
    exp = tmp_path / "exp"
    write_ipmsa_tree(tmp_path / "volumes", exp / "split", counts=(4, 4, 4), shape=(7, 28, 24), lz4=True)
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "volumes"))
    monkeypatch.setattr(ipmsa, "build_backbone", narrow_ipmsa_unet)
    config = dict(IPMSA_CONFIG, **IPMSA_NARROW_DATA, data_path="volumes", batch_size=4, num_workers=0, evaluation_batches=0,
                  sampling_steps=STEPS, cfg_w=0.3, project_root=str(tmp_path), experiment_dir="exp")
    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(config))
    # the checkpoint: the seeded weights as the EMA parameters
    engine = ipmsa.build_engine(ExperimentConfig(**config), device="cpu")
    engine.init_params()
    engine.state.ema_model.load_state_dict(convert.flax_to_state_dict(params, engine.state.ema_model))
    engine.save_checkpoint(0)
    keys = iter(jax.random.split(jax.random.PRNGKey(37), 2))
    used = []

    def draws(generator):
        used.append(next(keys))
        return JaxSampleDraws(used[-1])

    monkeypatch.setattr(engine_module, "TorchSampleDraws", draws)
    saved = []
    out = _script("ipmsa", "explain_torch").main(
        ["--device", "cpu"], plot_function=lambda **kw: saved.append(kw["output_dir"]))
    assert sorted(out) == [False, True] and len(saved) == 2 and len(used) == 2

    sampler = jax.jit(jax_make_sampler(
        lambda p, z, lg, lab: jden.apply(p, z, lg, lab), jax_schedule_fn("shifted_cosine", 64, 32),
        encode_fn=lambda p, z, lg: jden.apply(p, z, lg, None, mode="encode"),
        tail_fn=lambda p, s, lab: jden.apply(p, None, None, lab, mode="tail", prefix_state=s),
        pred_param="v", cfg_w=0.3, null_token=C, sampling_steps=STEPS,
    ), static_argnames="from_t")
    compiled = None
    for key, label in zip(used, (True, False)):
        samples, batches = out[label]
        (sample,), (batch,) = samples, batches
        assert (batch["prompt"] == int(label)).all()  # the forced label
        x = jax_dwt(jnp.asarray(batch["images"])) / 2.0
        labels = jnp.asarray(batch["prompt"])
        if compiled is None:  # one program for both labels
            compiled = sampler.lower(params, x, labels, key, from_t=0.5).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        want = np.asarray(compiled(params, x, labels, key))
        assert sample.shape == (4, 16, 16, 24) and torch.isfinite(sample).all()
        assert float(sample.abs().max()) <= 1.0
        assert rel_l2(sample.numpy(), want) <= 1e-4


