"""The port's multi-process DiT path against the JAX package's one-process run.

Real 2-rank gloo clusters on the CPU (``tests/_torch_mp.py``), one per
mode, each serving every assertion on it:

- ``data`` (``param_sharding='tp'`` on a model axis of 1: DDP) and
  ``fsdp`` (FSDP2), each with two microbatches a step: 3
  train steps of the tiny DiT of ``test_torch_train.py`` from the same
  bridged JAX weights, on the same global batches, with the JAX key tree's
  draws recorded here and replayed by the ranks; then ``evaluate`` over two
  global val batches. Held to the JAX single-process ``make_train_step``
  and ``make_classifier`` on the same global batches: losses rtol 1e-5,
  parameters and EMA rtol 1e-5 / atol 2e-6 (``assert_dit_state_close``),
  predictions and the synced Accuracy/F1 counters equal.
- ``fsdp`` also holds the global-norm clip (‖g‖ above ``max_grad_norm``):
  ‖g‖ and the clipped gradients at world 2 equal world 1's (rtol 1e-6;
  gradients atol 1e-6 of their largest magnitude), and checkpoints across
  placements: the state written at world 2 under FSDP reads back at world 1
  bit for bit, the one-process checkpoint reads back at world 2 under FSDP
  bit for bit (parameters, EMA, Adam's moments, counters), a resume in the
  same placement takes the uninterrupted run's next step exactly, and across
  world sizes within the parity tolerance. Only rank 0 writes files.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp as mp
from _torch_parity import (
    TINY_DIT,
    JaxDraws,
    JaxTrainDraws,
    assert_dit_state_close,
    jax_tiny_dit_train,
    tiny_dit_run,
)
from diffusion_classifier_tpu.diffusion.classify import make_classifier as jax_make_classifier
from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig
from diffusion_classifier_tpu_torch.diffusion.classify import auto_eval_group
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.utils.convert import flax_to_state_dict

torch.set_num_threads(1)

# both modes take two microbatches (DDP's no_sync, FSDP's gradient sync off
# for the first): one JAX reference run serves both
ACCUM = 2
MODES = {"data": dict(param_sharding="tp", accum=ACCUM), "fsdp": dict(param_sharding="fsdp", accum=ACCUM)}
CLIP_SCALE = 1e3  # the scaled loss's gradient norm is far above max_grad_norm = 1


def _denoiser_sd(flax_params) -> dict:
    bb = DiT(DiTConfig(**TINY_DIT))
    return {f"backbone.{k}": v for k, v in flax_to_state_dict(flax_params, bb).items()}


def _train_records(keys, batches, k):
    """Each step's recorded draws: the port asks per global microbatch, in order."""
    out = []
    for key, (x, _) in zip(keys, batches):
        micro = x.shape[0] // k
        shape = (micro,) + x.shape[1:]
        draws = JaxTrainDraws(key)
        out.append([("loss", (i, k, micro, shape), draws.loss(i, k, micro, shape)) for i in range(k)])
    return out


def _classify_records(key, x):
    """The port's draw requests of one classify on the global batch ``x`` (groups from the global B)."""
    cfg = mp.DIT_CONFIG
    ev = (0,) + tuple(cfg["evaluation_per_stage"])
    n_stages, b = cfg["n_stages"], x.shape[0]
    draws, out = JaxDraws(key, fast=False), []
    k = cfg["classes"]
    for stage in range(n_stages):
        n_evals = ev[stage + 1] - ev[stage]
        g = auto_eval_group(n_evals, b, k, img_elems=int(np.prod(x.shape[1:])))
        for gi in range(n_evals // g):
            args = (stage, n_stages, gi, n_evals // g, (g, b), (g, b) + x.shape[1:])
            out.append(("noise", args, draws.noise(*args)))
        k = cfg["n_keep_per_stage"][stage]
    return out


@functools.lru_cache(maxsize=1)
def _jax_classify():
    cfg = mp.DIT_CONFIG
    jdit = JaxDiT(JaxDiTConfig(**TINY_DIT, attn_backend="xla"))
    return jax.jit(jax_make_classifier(
        lambda p, z, lg, lab: jdit.apply(p, z, lg, lab),
        jax_schedule_fn("shifted_cosine", 64, 32), pred_param="v", num_classes=cfg["classes"],
        n_stages=cfg["n_stages"], evaluation_per_stage=cfg["evaluation_per_stage"],
        n_keep_per_stage=cfg["n_keep_per_stage"],
    ))


def _jax_predictions(ema_params, val_x, keys):
    fn, b = _jax_classify(), mp.DIT_CONFIG["batch_size"]
    return [
        np.asarray(fn(ema_params, jnp.asarray(val_x[i * b:(i + 1) * b]), jnp.zeros(b, jnp.int32), key))
        for i, key in enumerate(keys)
    ]


def _counters(preds, labels):
    p, y = np.concatenate(preds), labels
    return {
        "accuracy": {"correct": int((p == y).sum()), "total": len(y)},
        "f1": {"tp": int(((p == 1) & (y == 1)).sum()), "fp": int(((p == 1) & (y == 0)).sum()),
               "fn": int(((p == 0) & (y == 1)).sum())},
    }


@pytest.fixture(scope="module")
def inputs():
    params, batches, keys = tiny_dit_run()
    rng = np.random.default_rng(11)
    val_x = rng.uniform(-1, 1, (8, 32, 32, 4)).astype(np.float32)
    val_y = rng.integers(0, 3, 8).astype(np.int32)
    val_keys = list(jax.random.split(jax.random.PRNGKey(100), 2))
    b = mp.DIT_CONFIG["batch_size"]
    clip_draws = JaxTrainDraws(jax.random.PRNGKey(3)).loss(0, 1, b, (b, 32, 32, 4))
    return dict(
        weights=_denoiser_sd(params), batches=batches, keys=keys, val_x=val_x, val_y=val_y,
        val_keys=val_keys, clip_draws=clip_draws, clip_scale=CLIP_SCALE,
        val_draws=[_classify_records(k, val_x[i * b:(i + 1) * b]) for i, k in enumerate(val_keys)],
    )


@pytest.fixture(scope="module")
def one_process(inputs, tmp_path_factory):
    """The port at world 1: 2 steps, a checkpoint, the 3rd step; and the clip."""
    tmp = tmp_path_factory.mktemp("w1")
    records = _train_records(inputs["keys"], inputs["batches"], ACCUM)
    engine = mp.dit_engine(tmp, gradient_accumulation_steps=ACCUM)
    mp.load_weights(engine, inputs["weights"])
    mp.train(engine, inputs["batches"], records, last=2)
    engine.save_checkpoint(0)
    loss3 = mp.train(engine, inputs["batches"], records, first=2)
    params3, _ = mp.full_state(engine)
    clip = mp.clip_run(mp.dit_engine(tmp), inputs)
    return dict(checkpoint=str(tmp / "exp" / "checkpoints"), loss3=loss3, params3=params3, clip=clip)


@pytest.fixture(scope="module")
def clusters(inputs, one_process, tmp_path_factory):
    """Both modes' clusters, run side by side while the JAX references compile here."""
    started = {}
    try:
        for mode, kw in MODES.items():
            workdir = tmp_path_factory.mktemp(f"dit_{mode}")
            inp = dict(inputs, **kw, w1_checkpoint=one_process["checkpoint"],
                       train_draws=_train_records(inputs["keys"], inputs["batches"], kw["accum"]))
            torch.save(inp, workdir / "inputs.pt")
            started[mode] = (workdir, mp.spawn("dit", workdir))
        losses, params, ema = jax_tiny_dit_train(ACCUM)
        reference = dict(losses=losses, params=params, ema=ema,
                         preds=_jax_predictions(ema, inputs["val_x"], inputs["val_keys"]))
        done = {mode: (mode, workdir, mp.collect(procs, workdir)) for mode, (workdir, procs) in started.items()}
    finally:
        for _, procs in started.values():
            mp.finish(procs, timeout=1)
    return done, reference


@pytest.fixture(scope="module")
def reference(clusters):
    return clusters[1]


@pytest.fixture(scope="module")
def fsdp_cluster(clusters):
    return clusters[0]["fsdp"]


@pytest.fixture(params=list(MODES))
def cluster(request, clusters):
    return clusters[0][request.param]


def test_placement_follows_param_sharding(cluster):
    mode, _, outs = cluster
    for out in outs:
        placed = out["placed"]
        if mode == "fsdp":  # every parameter and its EMA are DTensor shards
            assert placed["fsdp"] and not placed["ddp"]
            assert placed["dtensors"] == placed["ema_dtensors"] > 0
        else:
            assert placed["ddp"] and not placed["fsdp"] and placed["dtensors"] == 0


def test_train_steps_match_jax_one_process(cluster, reference):
    _, _, outs = cluster
    want_losses, want_params, want_ema = (reference[k] for k in ("losses", "params", "ema"))
    bb = DiT(DiTConfig(**TINY_DIT))
    for out in outs:  # every rank returns the global batch's loss
        np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-5)
    for got, want in ((outs[0]["params"], want_params), (outs[0]["ema"], want_ema)):
        want_sd = flax_to_state_dict(want, bb)
        assert_dit_state_close({k[len("backbone."):]: v for k, v in got.items()}, want_sd)
    for name, value in outs[0]["params"].items():  # rank 1 gathers the same whole state
        assert torch.equal(value, outs[1]["params"][name]), name


def test_evaluate_predictions_and_synced_counters_match_jax(cluster, inputs, reference):
    _, _, outs = cluster
    want = reference["preds"]
    # each rank classified its rows of each global batch
    got = [np.concatenate([outs[0]["preds"][i], outs[1]["preds"][i]]) for i in range(len(want))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    counters = _counters(want, inputs["val_y"])
    assert outs[0]["counters"] == outs[1]["counters"] == counters


def test_clip_under_fsdp_uses_the_whole_gradient_norm(fsdp_cluster, one_process):
    _, _, outs = fsdp_cluster
    want_norm, want_grads = one_process["clip"]
    assert want_norm > 10.0  # the clip acts
    for out in outs:
        norm, grads = out["clip"]
        assert norm == pytest.approx(want_norm, rel=1e-6)
        for name, g in grads.items():
            w = want_grads[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=name)


def _load(folder):
    train = torch.load(os.path.join(folder, "train_state.pt"), weights_only=True)
    return train, torch.load(os.path.join(folder, "ema_params.pt"), weights_only=True)


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_fsdp_checkpoint_from_world_2_loads_at_world_1(fsdp_cluster, inputs, tmp_path):
    _, workdir, outs = fsdp_cluster
    assert outs[0]["writes"] and not outs[1]["writes"]  # rank 0 alone wrote
    folder = str(workdir / "exp" / "checkpoints")
    train, ema = _load(folder)
    engine = mp.dit_engine(tmp_path, seed=9, gradient_accumulation_steps=ACCUM)
    mp.load_weights(engine, inputs["weights"])
    engine.load_checkpoint(folder)
    st = engine.state
    _assert_equal(st.model.state_dict(), train["params"])
    _assert_equal(st.ema_model.state_dict(), ema)
    for got, want in zip(st.opt_state.mu + st.opt_state.nu, train["opt_state"]["mu"] + train["opt_state"]["nu"]):
        assert torch.equal(got, want)
    assert (st.step, st.ema_counter, st.opt_state.count) == (2, 2, 2)
    # the next step at world 1 against the uninterrupted world-2 run's
    records = _train_records(inputs["keys"], inputs["batches"], ACCUM)
    loss3 = mp.train(engine, inputs["batches"], records, first=2)
    np.testing.assert_allclose(loss3, outs[0]["losses"][2:], rtol=1e-5)
    for name, value in st.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), outs[0]["params"][name].numpy(), rtol=1e-5, atol=2e-6)


def test_one_process_checkpoint_loads_at_world_2_fsdp(fsdp_cluster, one_process):
    _, _, outs = fsdp_cluster
    train, ema = _load(one_process["checkpoint"])
    for out in outs:
        loaded = out["w1_loaded"]
        _assert_equal(loaded["params"], train["params"])
        _assert_equal(loaded["ema"], ema)
        for got, want in zip(loaded["mu"] + loaded["nu"], train["opt_state"]["mu"] + train["opt_state"]["nu"]):
            assert torch.equal(got, want)
        assert loaded["counters"] == (2, 2, 2)
        # the next step at world 2 against the uninterrupted one-process run's
        np.testing.assert_allclose(out["w1_resumed_losses"], one_process["loss3"], rtol=1e-5)
        for name, value in out["w1_resumed_params"].items():
            np.testing.assert_allclose(
                value.numpy(), one_process["params3"][name].numpy(), rtol=1e-5, atol=2e-6
            )


def test_fsdp_resume_takes_the_uninterrupted_step_exactly(fsdp_cluster):
    _, _, outs = fsdp_cluster
    for out in outs:
        assert out["resumed_losses"] == out["losses"][2:]
        _assert_equal(out["resumed_params"], out["params"])
