"""Port parity: ``make_classifier`` against the JAX classifier on a tiny DiT.

Both sides get the same weights (flax tree → weight bridge) and the same
draws: the port's classifier takes them from :class:`JaxDraws`, which replays
the JAX key tree. Predictions must be identical; the per-stage means are
float32 sums of squared errors over 4096 elements, where the two DiT
forwards differ by ~1e-6 relative, so they are held to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxDraws, to_numpy_tree
from diffusion_classifier_tpu.diffusion.classify import auto_eval_group as jax_auto_eval_group
from diffusion_classifier_tpu.diffusion.classify import make_classifier as jax_make_classifier
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule
from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig
from diffusion_classifier_tpu_torch.diffusion.classify import (
    ROW_BYTES_PER_ELEM,
    TorchDraws,
    auto_eval_group,
    card_eval_group,
    make_classifier,
)
from diffusion_classifier_tpu_torch.diffusion.schedule import make_schedule_fn
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)

C = 3
CFG = dict(
    num_attention_heads=2, attention_head_dim=64, in_channels=4, num_layers=1,
    sample_size=32, patch_size=4, num_classes=C, attn_backend="xla",
)
B = 2
PROTOCOL = dict(
    pred_param="v", num_classes=C, n_stages=2, evaluation_per_stage=(2, 4),
    n_keep_per_stage=(2, 1),
)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, 32, 32, 4)).astype(np.float32)
    labels = np.array([2, 0], np.int32)
    jdit = JaxDiT(JaxDiTConfig(**CFG))
    params = to_numpy_tree(
        jdit.init(jax.random.PRNGKey(1), x, np.zeros(B, np.float32), labels)
    )
    tdit = DiT(DiTConfig(**CFG))
    tdit.load_state_dict(flax_to_state_dict(params, tdit))
    return jdit, params, tdit.eval(), x, labels


CASES = {
    "all_classes": dict(class_chunk=0),
    "class_chunk_1": dict(class_chunk=1, eval_group=1),
    "fast": dict(class_chunk=0, fast=True, n_fast_classes=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_classify_matches_jax_on_injected_draws(models, case):
    jdit, params, tdit, x, labels = models
    kw = CASES[case]
    rng = jax.random.PRNGKey(7)
    jfn = jax.jit(
        jax_make_classifier(
            lambda p, z, lg, lab: jdit.apply(p, z, lg, lab),
            jax_schedule("shifted_cosine", 64, 32), trace=True, **PROTOCOL, **kw,
        )
    )
    want_pred, want_stages = jfn(params, jnp.asarray(x), jnp.asarray(labels), rng)

    tfn = make_classifier(
        tdit, make_schedule_fn("shifted_cosine", 64, 32), trace=True,
        scan_unroll=(4, 2), **PROTOCOL, **kw,
    )
    got_pred, got_stages = tfn(
        torch.from_numpy(x), torch.from_numpy(labels).long(),
        JaxDraws(rng, fast=kw.get("fast", False)),
    )
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
    for got, want in zip(got_stages, want_stages):
        np.testing.assert_array_equal(got["cand"].numpy(), np.asarray(want["cand"]))
        w = np.asarray(want["mean"])
        np.testing.assert_array_equal(np.isinf(got["mean"].numpy()), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(got["mean"].numpy()[fin], w[fin], rtol=1e-4)
    if kw.get("fast"):
        # fast mode scores only the true class and one other: the third is +inf
        assert np.isinf(np.asarray(want_stages[0]["mean"])).sum(axis=1).tolist() == [1, 1]


def test_class_chunk_does_not_change_predictions(models):
    _, _, tdit, x, _ = models
    xt = torch.from_numpy(x)
    preds = []
    for chunk in (0, 1, -1):
        fn = make_classifier(
            tdit, make_schedule_fn("cosine", 64, 32), class_chunk=chunk, **PROTOCOL
        )
        g = torch.Generator().manual_seed(3)
        preds.append(fn(xt, torch.zeros(B, dtype=torch.long), TorchDraws(g)).tolist())
    assert preds[0] == preds[1] == preds[2]


def test_ties_go_to_lower_class_id():
    # a denoiser whose prediction ignores the class: all means tie, and the
    # stable sort keeps class order, as lax.top_k does
    def apply_fn(z, lg, lab):
        return torch.zeros_like(z)

    fn = make_classifier(apply_fn, make_schedule_fn("cosine", 64, 32), trace=True, **PROTOCOL)
    pred, stages = fn(torch.zeros(B, 4, 4, 1), torch.zeros(B, dtype=torch.long),
                      TorchDraws(torch.Generator().manual_seed(0)))
    assert stages[0]["cand"].tolist() == [[0, 1], [0, 1]]
    assert pred.tolist() == [0, 0]


def test_auto_eval_group_unchanged():
    # 128x128x12 DWT image: budget 8 CIFAR-equivalents
    assert auto_eval_group(4, 16, 2, img_elems=128 * 128 * 12) == 1
    assert auto_eval_group(4, 1, 2, img_elems=128 * 128 * 12) == 4
    assert auto_eval_group(16, 8, 10) == 4


def test_rejects_group_that_does_not_divide_a_stage():
    with pytest.raises(ValueError, match="eval_group"):
        make_classifier(lambda *a: None, lambda t: t, eval_group=3, **PROTOCOL)


# (n_evals, B, K, image elements): CIFAR, the CheXpert DWT and IPMSA images,
# a serving batch of 1, a stage count with many divisors
GROUP_GRID = [
    (n, b, k, e)
    for n in (1, 4, 12, 16)
    for b in (1, 8, 64)
    for k in (1, 2, 10)
    for e in (32 * 32 * 3, 128 * 128 * 12, 128 * 128 * 40)
]


@pytest.mark.parametrize("target", [512, 64, 4096])
def test_auto_eval_group_equals_jax_over_a_grid(target):
    for n, b, k, e in GROUP_GRID:
        assert auto_eval_group(n, b, k, target, e) == jax_auto_eval_group(n, b, k, target, e), (n, b, k, e)


class _GroupsSeen(TorchDraws):
    """Torch draws that record each group's size ``G`` (the first axis of ``t``)."""

    def __init__(self, seed=0):
        super().__init__(torch.Generator().manual_seed(seed))
        self.groups = []

    def noise(self, stage, n_stages, group_idx, n_groups, t_shape, eps_shape):
        self.groups.append((stage, t_shape[0], n_groups))
        return super().noise(stage, n_stages, group_idx, n_groups, t_shape, eps_shape)


@pytest.mark.parametrize("target", [None, 8, 24])
def test_cpu_and_explicit_target_group_is_jax(target):
    # on the CPU (no target: JAX's default of 512) and with an explicit
    # megabatch_target, each stage's G is the JAX package's for its candidates
    ev, keep, b, shape = (4, 12), (2, 1), 3, (16, 16, 3)
    fn = make_classifier(
        lambda z, lg, lab: torch.zeros_like(z), make_schedule_fn("cosine", 64, 8), pred_param="v",
        num_classes=C, n_stages=2, evaluation_per_stage=ev, n_keep_per_stage=keep,
        megabatch_target=target,
    )
    draws = _GroupsSeen()
    fn(torch.zeros((b,) + shape), torch.zeros(b, dtype=torch.long), draws)
    want = []
    for stage, (n, k) in enumerate(((ev[0], C), (ev[1] - ev[0], keep[0]))):
        g = jax_auto_eval_group(n, b, k, target or 512, int(np.prod(shape)))
        want += [(stage, g, n // g)] * (n // g)
    assert draws.groups == want
    if target == 8:  # a budget of 32 rows: 2 evaluations of 3 x 3 rows, then 4 of 3 x 2
        assert want == [(0, 2, 2)] * 2 + [(1, 4, 2)] * 2


def test_card_eval_group_fits_the_free_memory_share():
    row = ROW_BYTES_PER_ELEM * 3072  # a CIFAR image's megabatch row
    # 16 evaluations at B=64 x 10 classes: 640 rows an evaluation
    assert card_eval_group(16, 64, 10, 3072, free_bytes=int(640 * 16 * row / 0.5)) == 16
    assert card_eval_group(16, 64, 10, 3072, free_bytes=int(640 * 15 * row / 0.5)) == 8
    assert card_eval_group(16, 64, 10, 3072, free_bytes=int(640 * 4 * row / 0.5)) == 4
    assert card_eval_group(16, 64, 10, 3072, free_bytes=0) == 1  # never below one evaluation
    # room for 5 evaluations' rows: the largest divisor of 12 within it is 4
    assert card_eval_group(12, 64, 10, 3072, free_bytes=int(640 * 5 * row / 0.5)) == 4
