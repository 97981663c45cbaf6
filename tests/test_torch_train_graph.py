"""The train step's CUDA graph (``engine/steps.py``): its route, its host logic on the CPU, its replay on the card.

CPU tests:

1. ``Optimizer.apply`` at a learning rate and bias corrections held in a
   float32 device tensor gives the bits of ``Optimizer.update`` at the
   Python floats, for fp32 and bf16 moments, inside and past the warmup.
2. The route rule: a CPU batch, ``debug_nans`` and several data ranks each
   take the eager step and count ``train.eager``.
3. The graph route's host logic (warm-up, capture, the per-step scalars,
   the static copies, the loss's clone, one graph a batch shape, a state
   with other tensors captured anew) with a stand-in for the CUDA graph
   whose replay runs the captured step's ops again: 12 steps, across the
   warmup and an EMA update, give the eager step's bits in losses,
   parameters, moments and EMA, with one and two microbatches and fp32 and
   bf16 moments. The route's device test is set aside for it.

Tests marked ``gpu`` skip without a CUDA device: the real graph against the
eager step (``debug_nans`` on, which runs the same arithmetic eagerly) on a
small UNet with remat off and on and on a small DiT through the flash
backward, bit for bit with cuDNN held to deterministic algorithms; then a
second batch shape and a replaced optimizer state. This file imports
neither jax nor the JAX package, so the card's machine runs it without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph.py
"""

import copy
import types

import numpy as np
import pytest
import torch

from diffusion_classifier_tpu_torch.engine import DiffusionClassifier, state, steps
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
from diffusion_classifier_tpu_torch.ops import flash_attention as fa
from diffusion_classifier_tpu_torch.parallel.sharding import Placement
from diffusion_classifier_tpu_torch.utils import profiling
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
STEPS = 12  # across the learning-rate warmup and the EMA update at call 10

CONFIG = dict(
    data_path="synthetic", image_size=8, image_channels=3, classes=4, encoder_type="DiT",
    mixed_precision="no", batch_size=4, evaluation_per_stage=[1], evaluation_batches=0,
    learning_rate=1e-3, lr_warmup_steps=5, ema_warmup=5, ema_update_freq=10, seed=3,
)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _dit(size, heads, head_dim, dtype=torch.float32):
    return DiT(DiTConfig(num_attention_heads=heads, attention_head_dim=head_dim, in_channels=3,
                         out_channels=3, num_layers=2, sample_size=size, patch_size=2, num_classes=4),
               dtype=dtype)


def _unet(size, remat, dtype=torch.bfloat16):
    return UNetCondition2D(UNetConfig(
        sample_size=size, in_channels=3, out_channels=3, layers_per_block=1,
        block_out_channels=(32, 32, 64, 64),
        down_block_types=("DownBlock2D", "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D", "UpBlock2D"),
        encoder_hid_dim=32, encoder_hid_dim_type="text_proj", cross_attention_dim=32,
        attention_head_dim=2, norm_num_groups=8, remat=remat,
    ), dtype=dtype)


def _engine(backbone, device, **overrides):
    config = ExperimentConfig.from_dict(dict(CONFIG, **overrides))
    eng = DiffusionClassifier(backbone, config, device=device)
    eng.init_params()
    eng._build_train_state(total_steps=40)
    return eng


def _batches(n, b, size, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
             "prompt": rng.integers(0, 4, b).astype(np.int64)} for _ in range(n)]


def _train_state(eng) -> dict:
    st = eng.state
    return {"params": [p.detach() for p in st.params()], "mu": st.opt_state.mu,
            "nu": st.opt_state.nu, "ema": st.ema_params()}


def _assert_same_bits(a: dict, b: dict) -> None:
    for key in a:
        for i, (x, y) in enumerate(zip(a[key], b[key], strict=True)):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=lambda m: f"{key}[{i}]: {m}")


def _stand_in_capture(self, entry, st, inputs):
    """The CPU's stand-in for ``TrainStep._capture``: its replay runs the captured step's ops again.

    It holds the state as it was at the capture (a shallow copy), as a graph
    holds the tensors it was captured on.
    """
    held = copy.copy(st)
    entry.inputs = [torch.empty_like(v) for v in inputs]
    entry.hyper = torch.empty(3, dtype=torch.float32)
    entry.loss = torch.empty(())
    entry.graph = types.SimpleNamespace(
        replay=lambda: entry.loss.copy_(self._update(held, entry.inputs, entry.hyper)))
    profiling.count("train.graph.captures")


@pytest.fixture
def stand_in(monkeypatch):
    """The graph route on the CPU: the route's device test set aside, the stand-in graph captured."""
    route = steps.graph_route
    monkeypatch.setattr(steps, "graph_route",
                        lambda st, x, debug_nans: route(st, types.SimpleNamespace(is_cuda=True), debug_nans))
    monkeypatch.setattr(steps.TrainStep, "_capture", _stand_in_capture)


# --- 1. the per-step scalars as device tensors ------------------------------------------


@pytest.mark.parametrize("count", [0, 3, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_scalars_give_the_float_bits(count, dtype):
    tx = state.Optimizer(state.cosine_warmup_schedule(3e-3, 5, 20), state_dtype=dtype)
    gen = torch.Generator().manual_seed(count)
    shapes = [(7, 5), (5,), (3, 3, 2, 4)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [torch.randn(s, generator=gen) * 0.3 for s in shapes]
    runs = []
    for scalars in (False, True):
        p = [t.clone() for t in params]
        st = tx.init(p)
        st.count = count
        for m, n, g in zip(st.mu, st.nu, grads):
            m.copy_(g * 0.5)
            n.copy_(g * g * 0.25)
        if scalars:
            hyper = torch.tensor(tx.hyper(st.count), dtype=torch.float32)
            tx.apply([g.clone() for g in grads], st, p, *hyper.unbind())
            st.count += 1
        else:
            tx.update([g.clone() for g in grads], st, p)
        runs.append({"params": p, "mu": st.mu, "nu": st.nu, "count": [torch.tensor(st.count)]})
    assert tx.hyper(count)[0] == tx.schedule(count)
    _assert_same_bits(*runs)


# --- 2. the route rule -------------------------------------------------------------------


class _Axis:
    """A mesh axis of ``n`` ranks, this process rank 0 (no process group)."""

    def __init__(self, n):
        self.n = n

    def get_group(self):
        return None

    def get_local_rank(self):
        return 0

    def size(self):
        return self.n


CARD = types.SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case,want", [
    ("cpu_batch", False), ("debug_nans", False), ("data_ranks", False), ("one_card", True),
])
def test_route_rule(case, want):
    eng = _engine(_dit(8, 2, 16), "cpu")
    st = eng.state
    if case == "data_ranks":
        st.placement = Placement(st.model, {"data": _Axis(2), "model": _Axis(1)})
    x = torch.zeros(4, 8, 8, 3) if case == "cpu_batch" else CARD
    assert steps.graph_route(st, x, debug_nans=case == "debug_nans") is want


@pytest.mark.parametrize("case", ["cpu_batch", "debug_nans", "data_ranks"])
def test_steps_off_the_route_run_eagerly(monkeypatch, case, request):
    if case != "cpu_batch":
        request.getfixturevalue("stand_in")  # so that a wrong route would capture
    eng = _engine(_dit(8, 2, 16), "cpu", debug_nans=case == "debug_nans")
    if case == "data_ranks":
        eng.state.placement = Placement(eng.state.model, {"data": _Axis(2), "model": _Axis(1)})
        monkeypatch.setattr(torch.distributed, "all_reduce", lambda value, group=None: None)  # a lone rank
    for batch in _batches(4, 4, 8):
        assert torch.isfinite(eng.train_step(batch))
    c = profiling.counters()
    assert c.get("train.eager") == 4 and "train.graph.captures" not in c and "train.graph.replays" not in c


# --- 3. the graph route's host logic, with a stand-in graph ------------------------------


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("state_dtype", ["fp32", "bf16"])
def test_stand_in_replay_gives_the_eager_bits(stand_in, accum, state_dtype):
    kw = dict(gradient_accumulation_steps=accum, optimizer_state_dtype=state_dtype)
    graphed = _engine(_dit(8, 2, 16), "cpu", **kw)
    eager = _engine(_dit(8, 2, 16), "cpu", debug_nans=True, **kw)
    losses = {"graphed": [], "eager": []}
    for batch in _batches(STEPS, 4, 8):
        for name, eng in (("graphed", graphed), ("eager", eager)):
            losses[name].append(eng.train_step(batch))
    _assert_same_bits(losses, {"graphed": losses["eager"], "eager": losses["eager"]})
    _assert_same_bits(_train_state(graphed), _train_state(eager))
    assert graphed.state.opt_state.count == eager.state.opt_state.count == STEPS
    assert graphed.state.step == graphed.state.ema_counter == STEPS
    c = profiling.counters()
    assert (c["train.eager"], c["train.graph.captures"], c["train.graph.replays"]) == (
        steps.WARMUP_STEPS + STEPS, 1, STEPS - steps.WARMUP_STEPS)
    assert c["train.microbatches"] == 2 * STEPS * accum


def test_stand_in_one_graph_a_shape_and_a_new_state_captured_anew(stand_in):
    graphed = _engine(_dit(8, 2, 16), "cpu")
    eager = _engine(_dit(8, 2, 16), "cpu", debug_nans=True)

    def run(batches):
        for batch in batches:
            torch.testing.assert_close(graphed.train_step(batch), eager.train_step(batch), rtol=0, atol=0)
        _assert_same_bits(_train_state(graphed), _train_state(eager))
        c = profiling.counters()
        return c.get("train.graph.captures", 0), c.get("train.graph.replays", 0)

    assert run(_batches(4, 4, 8)) == (1, 2)
    assert run(_batches(4, 2, 8, seed=1)) == (2, 4)  # a second shape: its own graph
    assert run(_batches(3, 4, 8, seed=2)) == (2, 7)  # the first shape's graph again
    assert run(_batches(3, 6, 8, seed=3)) == (2, 7)  # a third shape runs eagerly
    assert len(graphed._train_step.graphs) == steps.MAX_GRAPHS
    for eng in (graphed, eager):  # new moment tensors: the graphs must not be replayed on the old
        eng.state.opt_state = eng._train_step.tx.init(eng.state.params())
    assert run(_batches(4, 4, 8, seed=4)) == (3, 9)
    assert len(graphed._train_step.graphs) == 1


# --- on the card: the real graph -------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's graph is captured on the card")
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


CARD_MODELS = {
    "unet": lambda: _unet(16, remat=False),
    "unet_remat": lambda: _unet(16, remat=True),
    "dit_flash": lambda: _dit(16, 2, 64, torch.bfloat16),
}
CARD_CONFIG = dict(image_size=16, batch_size=8, mixed_precision="bf16")


def _card_engine(model, cuda, **overrides):
    kw = dict(CARD_CONFIG, encoder_type="DiT" if model.startswith("dit") else "nn", **overrides)
    return _engine(CARD_MODELS[model](), cuda, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(CARD_MODELS))
def test_graph_gives_the_eager_bits(cuda, model):
    graphed, eager = _card_engine(model, cuda), _card_engine(model, cuda, debug_nans=True)
    batches = _batches(STEPS, 8, 16)
    fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    want = [eager.train_step(b) for b in batches]
    assert fa.FLASH_FWD.launches > fwd and fa.FLASH_BWD.launches > bwd, "the step ran no flash kernel"
    profiling.reset_counters()
    got = [graphed.train_step(b) for b in batches]
    torch.cuda.synchronize()
    c = profiling.counters()
    assert (c["train.eager"], c["train.graph.captures"], c["train.graph.replays"]) == (
        steps.WARMUP_STEPS, 1, STEPS - steps.WARMUP_STEPS)
    _assert_same_bits({"losses": got}, {"losses": want})
    _assert_same_bits(_train_state(graphed), _train_state(eager))
    assert graphed.state.opt_state.count == STEPS


@pytest.mark.gpu
def test_graph_a_new_shape_and_a_new_state_capture_anew(cuda):
    graphed, eager = _card_engine("unet", cuda), _card_engine("unet", cuda, debug_nans=True)

    def run(batches):
        got = [graphed.train_step(b) for b in batches]
        want = [eager.train_step(b) for b in batches]
        _assert_same_bits({"losses": got}, {"losses": want})
        _assert_same_bits(_train_state(graphed), _train_state(eager))
        return profiling.counters().get("train.graph.captures", 0)

    assert run(_batches(4, 8, 16)) == 1
    assert run(_batches(4, 4, 16, seed=1)) == 2
    assert run(_batches(2, 8, 16, seed=2)) == 2
    for eng in (graphed, eager):
        eng.state.opt_state = eng._train_step.tx.init(eng.state.params())
    assert run(_batches(4, 8, 16, seed=3)) == 3
