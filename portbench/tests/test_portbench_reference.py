"""The plain reference against the port at tiny widths, on the CPU, in fp32.

The same weights (the benchmark's, from a seed) go into both; the port's
modules are called as the engine calls them.
"""

import numpy as np
import pytest
import torch

from portbench.inputs import make_weights
from portbench.reference import diffusion as rd
from portbench.reference import dit, unet
from portbench.reference.precision import Precision
from tiny import TINY_UNET, _tiny_unet

DIT_MODEL = dict(num_attention_heads=2, attention_head_dim=64, patch_size=4, in_channels=12,
                 out_channels=12, num_layers=2, mlp_ratio=4, norm_eps=1e-5)


def _config(**kw):
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    return ExperimentConfig.from_dict(dict(mixed_precision="no", **kw))


def _loaded(module, weights):
    names = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert names == {n: tuple(w.shape) for n, w in weights.items()}
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(weights[n])
    return module


@pytest.fixture
def dit_pair(monkeypatch):
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.experiments import chexpert_dit

    monkeypatch.setattr(chexpert_dit, "WIDTH", 128)
    monkeypatch.setattr(chexpert_dit, "NUM_LAYERS", 2)
    cfg = _config(image_size=16, wavelet_transform=True, patch_size=4, classes=2, encoder_type="DiT")
    w = make_weights(dit.param_shapes(DIT_MODEL, 2), 3, "cpu")
    return _loaded(Denoiser(chexpert_dit.build_backbone(cfg), None), w), w


@pytest.fixture
def unet_pair():
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder

    cfg = _config(image_size=16, classes=10, encoder_type="nn")
    w = make_weights(unet.param_shapes(TINY_UNET, 10), 4, "cpu")
    return _loaded(Denoiser(_tiny_unet(cfg), ClassEmbedder(10, 32)), w), w


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_dit_forward_matches_port(dit_pair):
    port, w = dit_pair
    z = torch.randn(3, 8, 8, 12, generator=torch.Generator().manual_seed(0))
    lam, labels = torch.tensor([-4.0, 0.3, 6.0]), torch.tensor([0, 1, 2])
    with torch.no_grad():
        assert rel(port(z, lam, labels), dit.forward(w, DIT_MODEL, z, lam, labels)) < 1e-5


def test_unet_prefix_tail_and_forward_match_port(unet_pair):
    port, w = unet_pair
    z = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    lam, labels = torch.tensor([-2.0, 5.0]), torch.tensor([3, 10])
    with torch.no_grad():
        full = unet.forward(w, TINY_UNET, z, lam, labels)
        assert rel(port(z, lam, labels), full) < 1e-5
        state = port(z, lam, None, mode="encode")
        assert rel(port(None, None, labels, mode="tail", prefix_state=state), full) < 1e-5
        h, _, _ = unet.prefix(w, TINY_UNET, z, lam)
        assert rel(state[0], h) < 1e-5


def test_haar_schedule_noising_and_eps_match_port():
    from diffusion_classifier_tpu_torch.diffusion.process import pred_to_eps
    from diffusion_classifier_tpu_torch.diffusion.schedule import alpha_sigma, make_schedule_fn
    from diffusion_classifier_tpu_torch.ops.wavelet import haar_dwt2

    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1
    assert torch.equal(rd.haar(x), haar_dwt2(x) / 2.0)
    t = torch.rand(64, generator=g)
    for schedule in ("cosine", "shifted_cosine"):
        ours = rd.logsnr(t, schedule, 64, 256)
        assert torch.allclose(ours, make_schedule_fn(schedule, 64, 256)(t), rtol=1e-5, atol=1e-5)
    lam = rd.logsnr(t[:2], "shifted_cosine", 64, 256)
    a, s = rd.alpha_sigma(lam)
    pa, ps = alpha_sigma(lam)
    assert torch.allclose(a, pa) and torch.allclose(s, ps)
    pred, z = torch.randn(2, 4, 4, 3, generator=g), torch.randn(2, 4, 4, 3, generator=g)
    assert torch.allclose(rd.eps_from_pred(pred, z, lam, "v"), pred_to_eps(pred, z, pa, ps, "v"))


def test_tournament_matches_port_classifier():
    """A denoiser whose ε error is known: the reference's staged pick is the port's."""
    from diffusion_classifier_tpu_torch.diffusion.classify import TorchDraws, make_classifier

    k, b = 5, 6
    bias = torch.rand(b, k, generator=torch.Generator().manual_seed(3))

    def apply_fn(z, lam, labels):  # an ε prediction set by the image and the class; G = 1, rows (b, c)
        image = torch.arange(z.shape[0]) // (z.shape[0] // b)
        return torch.zeros_like(z) + bias[image, labels][:, None, None, None]

    clf = make_classifier(apply_fn, lambda t: torch.zeros_like(t), pred_param="eps", num_classes=k,
                          n_stages=2, evaluation_per_stage=[2, 4], n_keep_per_stage=[3, 1], eval_group=1)
    x = torch.zeros(b, 2, 2, 1)
    got = clf(x, torch.zeros(b, dtype=torch.long), TorchDraws(torch.Generator().manual_seed(4)))
    err = torch.zeros(4, b, k)  # the same error every evaluation: |bias - eps|^2 summed; eps drawn
    draws = TorchDraws(torch.Generator().manual_seed(4))
    for e in range(4):
        _, eps = draws.noise(0, 2, e, 4, (1, b), (1, b, 2, 2, 1))
        err[e] = ((bias[:, :, None, None, None] - eps[0][:, None]) ** 2).flatten(2).sum(-1)
    want = rd.tournament(err, [2, 4], [3, 1])
    assert torch.equal(got, want)


def test_adam_and_loss_match_port_optimizer():
    from diffusion_classifier_tpu_torch.diffusion.process import weighted_mse_loss
    from diffusion_classifier_tpu_torch.engine.state import make_optimizer

    g = torch.Generator().manual_seed(5)
    params = [torch.randn(7, 3, generator=g), torch.randn(5, generator=g)]
    grads = [torch.randn(7, 3, generator=g) * 3, torch.randn(5, generator=g)]
    tx = make_optimizer(1e-3, 2, 10)
    state, ours = tx.init(params), [p.clone() for p in params]
    mu, nu = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    for step in range(3):
        port = [p.clone() for p in params]
        tx.update([q.clone() for q in grads], state, port)
        rd.adam_step(ours, [q.clone() for q in grads], mu, nu, step, rd.lr_at(step, 1e-3, 2, 10))
        params = port
        for a, b in zip(ours, port):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    pred, z, eps = (torch.randn(4, 3, 3, 2, generator=g) for _ in range(3))
    lam = torch.tensor([-3.0, 0.0, 2.0, 9.0])
    assert torch.allclose(rd.weighted_loss(pred, z, eps, lam, "v"), weighted_mse_loss(pred, z, eps, lam, "v"))


def test_fp8_control_rounds_products_only():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(6))
    w = torch.randn(16, 32, generator=torch.Generator().manual_seed(7))
    exact = Precision().linear(x, w)
    low = Precision("fp8").linear(x, w)
    err = rel(low, exact)
    assert 1e-3 < err < 0.1
    leaf = w.clone().requires_grad_(True)
    Precision("fp8").linear(x, leaf).sum().backward()
    assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0
    assert np.isfinite(err)
