"""DiT-XL/2's shape on the port, at a tiny size on the CPU: D = 72 heads, the learned Σ, a pruning tournament.

- A 2-layer DiT of 2 heads × 72 with ``out_channels`` twice the input's,
  built by the engine, classifies through a three-stage tournament; the
  plain reference (``portbench/reference/dit.py``, fp32, its own attention)
  scores every (evaluation, image, class) from the same weights and draws,
  and runs the same tournament: the same predictions, and the port's
  per-stage means within rtol 1e-4 of the reference's (float32 sums of
  squared errors over 256 values, where the two forwards differ by ~1e-6
  relative).
- The learned Σ half is never read: poisoned with NaN it leaves the
  answers and the loss as they were, and the loss's gradient reaches no
  Σ row of the final projection; the ε half is a view, no copy.
- The flash gate takes D = 72 in bf16 only where no graph is recorded.
- The ``dit-xl-2`` preset has the published DiT-XL/2's parameters.
"""

import math

import numpy as np
import pytest
import torch

from diffusion_classifier_tpu_torch.diffusion.classify import make_classifier
from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
from diffusion_classifier_tpu_torch.engine.steps import TorchTrainDraws
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.models.presets import build_preset
from diffusion_classifier_tpu_torch.ops.flash_attention import supports
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig
from portbench.reference import diffusion as rd
from portbench.reference import dit as ref_dit

C, B, SIZE = 6, 2, 8
STAGES = dict(n_stages=3, evaluation_per_stage=[2, 4, 6], n_keep_per_stage=[3, 2, 1])
MODEL = dict(num_attention_heads=2, attention_head_dim=72, patch_size=2, in_channels=4, out_channels=8,
             num_layers=2, mlp_ratio=4, norm_eps=1e-5)


def _engine():
    config = ExperimentConfig(image_size=SIZE, image_channels=4, classes=C, encoder_type="DiT", pred_param="eps",
                              schedule="cosine", noise_d=SIZE, mixed_precision="no", seed=3, **STAGES)
    backbone = DiT(DiTConfig(num_attention_heads=2, attention_head_dim=72, in_channels=4, out_channels=8,
                             num_layers=2, sample_size=SIZE, patch_size=2, num_classes=C))
    engine = DiffusionClassifier(backbone, config, device="cpu")
    engine.init_params()
    return engine


def _images():
    return np.random.default_rng(0).uniform(-1, 1, (B, SIZE, SIZE, 4)).astype(np.float32)


class _Logged:
    """Torch draws that keep every group's ``(t, ε)`` for the reference."""

    def __init__(self, seed):
        self.generator = torch.Generator().manual_seed(seed)
        self.log = []

    def noise(self, stage, n_stages, group_idx, n_groups, t_shape, eps_shape):
        t = torch.rand(t_shape, generator=self.generator)
        eps = torch.randn(eps_shape, generator=self.generator)
        self.log.append((stage, t, eps))
        return t, eps


@pytest.fixture(scope="module")
def engine():
    return _engine()


def test_tournament_matches_the_reference(engine):
    x = torch.as_tensor(_images())
    draws = _Logged(7)
    classify = make_classifier(
        lambda z, lam, c: engine.state.ema_model(z, lam, c), engine.schedule_fn, pred_param="eps",
        num_classes=C, trace=True, **STAGES,
    )
    preds, stages = classify(x, torch.zeros(B, dtype=torch.long), draws)

    # the reference: every (evaluation, image, class), the draws in the port's order
    P = {n: p.detach() for n, p in engine.state.ema_model.named_parameters()}
    t = torch.cat([t for _, t, _ in draws.log])  # [E, B]
    eps = torch.cat([e for _, _, e in draws.log])  # [E, B, H, W, 4]
    lam = rd.logsnr(t, "cosine", SIZE, SIZE)
    a, s = rd.alpha_sigma(lam)
    z = a[..., None, None, None] * x[None] + s[..., None, None, None] * eps
    err = torch.empty(t.shape + (C,))
    with torch.no_grad():
        for c in range(C):
            labels = torch.full((z.shape[0] * B,), c)
            pred = ref_dit.forward(P, MODEL, z.flatten(0, 1), lam.flatten(), labels)[..., :4]
            ep = rd.eps_from_pred(pred, z.flatten(0, 1), lam.flatten(), "eps")
            err[..., c] = ((ep - eps.flatten(0, 1)) ** 2).flatten(1).sum(1).reshape(t.shape)
    assert torch.equal(preds, rd.tournament(err, STAGES["evaluation_per_stage"], STAGES["n_keep_per_stage"]))
    alive = torch.ones(B, C, dtype=torch.bool)
    for stage, n in zip(stages, STAGES["evaluation_per_stage"]):
        want = torch.where(alive, err[:n].mean(dim=0), math.inf)
        torch.testing.assert_close(stage["mean"], want, rtol=1e-4, atol=0)
        alive = torch.zeros_like(alive).scatter_(1, stage["cand"], True)


def test_learned_sigma_half_is_never_read(engine):
    x = _images()
    labels = np.array([1, 4])
    den = engine.state.ema_model
    z, lam = torch.as_tensor(x), torch.zeros(B)
    seen = []
    handle = den.backbone.register_forward_hook(lambda m, a, o: seen.append(o))
    try:
        with torch.no_grad():
            out = den(z, lam, torch.as_tensor(labels))
    finally:
        handle.remove()
    assert out.shape[-1] == 4 and seen[0].shape[-1] == 8
    assert out.data_ptr() == seen[0].data_ptr() and torch.equal(out, seen[0][..., :4])  # a view, no copy

    def clean():
        loss = engine.loss(x, labels, draws=TorchTrainDraws(torch.Generator().manual_seed(2)))
        return engine.classify(x, draws=_Logged(5)), loss

    def poison(module, args, output):
        output = output.clone()
        output[..., 4:] = math.nan
        return output

    preds, loss = clean()
    handles = [m.backbone.register_forward_hook(poison) for m in (den, engine.denoiser)]
    try:
        poisoned_preds, poisoned_loss = clean()
    finally:
        for h in handles:
            h.remove()
    assert torch.equal(preds, poisoned_preds) and torch.isfinite(loss) and torch.equal(loss, poisoned_loss)

    # the Σ rows of the final projection (column % 8 ≥ 4 of each patch pixel) get no gradient
    engine.denoiser.zero_grad()
    g = TorchTrainDraws(torch.Generator().manual_seed(2))
    u, t, eps = g.loss(0, 1, B, (B, SIZE, SIZE, 4))
    engine._loss_eval(torch.as_tensor(x), torch.as_tensor(labels), u, t, eps).backward()
    grad = engine.denoiser.backbone.final_proj.weight.grad
    sigma = (torch.arange(grad.shape[0]) % 8) >= 4
    assert grad[~sigma].abs().sum() > 0 and torch.count_nonzero(grad[sigma]) == 0


@pytest.mark.parametrize("dtype, grad, taken", [
    (torch.bfloat16, False, True), (torch.bfloat16, True, False), (torch.float32, False, False),
])
def test_flash_gate_takes_d72_without_a_graph(dtype, grad, taken):
    q = torch.zeros(1, 4, 2, 72, dtype=dtype, requires_grad=grad)
    assert supports(q, q, q) is taken
    with torch.no_grad():  # nothing recorded: the graph no longer matters
        assert supports(q, q, q) is (dtype == torch.bfloat16)
    d64 = torch.zeros(1, 4, 2, 64, dtype=dtype, requires_grad=grad)
    assert supports(d64, d64, d64)  # the other head dims keep their entries both ways


def test_dit_xl_2_preset_has_the_published_parameters():
    config = ExperimentConfig(image_size=64, image_channels=4, classes=1000, mixed_precision="bf16")
    with torch.device("meta"):
        net = build_preset("dit-xl-2", config)
    cfg = net.config
    assert (cfg.num_layers, cfg.hidden_dim, cfg.num_attention_heads, cfg.attention_head_dim) == (28, 1152, 16, 72)
    assert (cfg.in_channels, cfg.out_ch, cfg.patch_size, cfg.num_classes) == (4, 8, 2, 1000)
    # the original code's count, 675,129,632 at 256 px, holds its frozen 256 x 1152 position table;
    # the port's table is a fixed buffer, as in the published model it is never trained
    assert sum(p.numel() for p in net.parameters()) == 675_129_632 - 256 * 1152
    names = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert names == {k[len("backbone."):]: v for k, v in ref_dit.param_shapes(
        dict(MODEL, num_attention_heads=16, num_layers=28), 1000).items()}
