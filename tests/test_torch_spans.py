"""The port's spans and counters (``utils/profiling.py``) on the CPU, at tiny widths.

Spans off: ``span()`` is one shared no-op and a profiler sees no ``dc.``
range. Under ``profiling.trace()`` a DiT classify (two stages, the Haar
transform, the attention kernels' route), a UNet classify with its shared
prefix (encode and tail, the plain attention route) and a train step of two
microbatches each give the span tree of the layers, read back from the
Chrome trace by how the ranges nest in time. The denoiser's counters equal
what a forward hook on the EMA denoiser counts in the same call.
"""

import json

import numpy as np
import pytest
import torch

from diffusion_classifier_tpu_torch.engine import DiffusionClassifier
from diffusion_classifier_tpu_torch.models.dit import DiT, DiTConfig
from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig
from diffusion_classifier_tpu_torch.ops.attention import attention
from diffusion_classifier_tpu_torch.utils import profiling
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)

C = 3
# 16 px, one channel → Haar 8x8x4 → patch 2: 16 tokens, 2 heads x 32 (the kernels' route)
DIT = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=4, out_channels=4, num_layers=2,
    sample_size=8, patch_size=2, num_classes=C, attn_backend="auto",
)
DIT_CONFIG = dict(
    data_path="synthetic", image_size=16, image_channels=1, wavelet_transform=True, classes=C,
    encoder_type="DiT", mixed_precision="no", batch_size=4, n_stages=2,
    evaluation_per_stage=[2, 4], n_keep_per_stage=[2, 1], seed=3,
    gradient_accumulation_steps=2, lr_warmup_steps=1,
)
# 8 px, levels (16, 32), a cross-attention level of 2 heads x 16 (the plain route), 8 groups
UNET = dict(
    sample_size=8, in_channels=3, out_channels=3, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
    attention_head_dim=2, cross_attention_dim=16, encoder_hid_dim=16,
    encoder_hid_dim_type="text_proj", norm_num_groups=8,
)
UNET_CONFIG = dict(
    data_path="synthetic", image_size=8, image_channels=3, classes=C, encoder_type="nn",
    mixed_precision="no", batch_size=2, evaluation_per_stage=[2], seed=4,
)

# a span's innermost enclosing span, by layer
PARENTS = {
    "classify": {None},
    "train_step": {None},
    "upload": {"classify", "train_step"},
    "haar": {"classify", "train_step"},
    "tournament.stage": {"classify"},
    "tournament.auto_group": {"tournament.stage"},
    "tournament.group": {"tournament.stage"},
    "tournament.select": {"tournament.stage"},
    "denoiser.full": {"tournament.group", "train.forward_backward"},
    "denoiser.encode": {"tournament.group"},
    "denoiser.tail": {"tournament.group"},
    "norm.layer": {"denoiser.full", "denoiser.encode", "denoiser.tail"},
    "norm.group": {"denoiser.full", "denoiser.encode", "denoiser.tail"},
    "attention.flash": {"denoiser.full"},
    "attention.plain": {"denoiser.encode", "denoiser.tail"},
    "train.draws": {"train_step"},
    "train.forward_backward": {"train_step"},
    "train.optimizer": {"train_step"},
    "train.ema": {"train_step"},
}


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _dit_engine():
    engine = DiffusionClassifier(DiT(DiTConfig(**DIT)), ExperimentConfig.from_dict(DIT_CONFIG), device="cpu")
    engine.init_params()
    return engine


def _unet_engine():
    engine = DiffusionClassifier(
        UNetCondition2D(UNetConfig(**UNET)), ExperimentConfig.from_dict(UNET_CONFIG), device="cpu"
    )
    engine.init_params()
    return engine


def _images(n, size, channels, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, channels)).astype(np.float32)


def _dit_classify():
    engine = _dit_engine()
    return engine, lambda: engine.classify(_images(2, 16, 1))


def _unet_classify():
    engine = _unet_engine()
    return engine, lambda: engine.classify(_images(2, 8, 3))


def _dit_train_step():
    engine = _dit_engine()
    engine._build_train_state(total_steps=4)
    batch = {"images": _images(4, 16, 1), "prompt": np.array([0, 1, 2, 1])}
    return engine, lambda: engine.train_step(batch)


def _dc_spans(path):
    """``[(name without the call number, start, end, full name)]`` of the trace's ``dc.`` ranges, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [
        (e["name"][3:].split("#")[0], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("dc.")
    ]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's innermost enclosing span, by time: ``[(name, parent name or None)]``."""
    out = []
    for i, (name, s, e, _) in enumerate(spans):
        parent = None
        for pname, ps, pe, _ in reversed(spans[:i]):
            if ps <= s and e <= pe:
                parent = pname
                break
        out.append((name, parent))
    return out


def test_spans_off_are_one_shared_noop_and_record_nothing():
    from torch.profiler import ProfilerActivity, profile

    assert profiling.span("classify") is profiling.span("norm.group", 3)
    engine, run = _dit_classify()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = [e.name for e in prof.events()]
    assert any(n.startswith("aten::") for n in names)
    assert not [n for n in names if n.startswith("dc.")]


def test_spans_switch_on_inside_their_block_only():
    off = profiling.span("x")
    with profiling.spans():
        with profiling.spans():
            assert profiling.span("x") is not off
        assert profiling.span("x") is not off  # the outer block still has them on
    assert profiling.span("x") is off
    with pytest.raises(RuntimeError):
        with profiling.spans():
            raise RuntimeError("inside")
    assert profiling.span("x") is off


@pytest.mark.parametrize(
    "build, expected",
    [
        (_dit_classify, {"classify", "upload", "haar", "tournament.stage", "tournament.auto_group",
                         "tournament.group", "tournament.select", "denoiser.full", "norm.layer",
                         "attention.flash"}),
        (_unet_classify, {"classify", "upload", "tournament.stage", "tournament.auto_group",
                          "tournament.group", "tournament.select", "denoiser.encode", "denoiser.tail",
                          "norm.group", "norm.layer", "attention.plain"}),
        (_dit_train_step, {"train_step", "upload", "haar", "train.draws", "train.forward_backward",
                           "denoiser.full", "norm.layer", "attention.flash", "train.optimizer", "train.ema"}),
    ],
    ids=["dit_classify", "unet_prefix_classify", "train_step"],
)
def test_trace_shows_the_span_tree_of_the_layers(tmp_path, build, expected):
    engine, run = build()
    with profiling.trace(str(tmp_path)) as prof:
        run()
    spans = _dc_spans(prof.trace_path)
    assert {name for name, *_ in spans} == expected
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)
    tops = [full for name, _, _, full in spans if name in ("classify", "train_step")]
    assert len(tops) == 1
    # the top span is numbered by its call's counter
    counter = "train.steps" if "train_step" in expected else "classify.calls"
    assert tops[0].split("#")[1] == str(profiling.counters()[counter]) == "1"
    assert profiling.span("x") is profiling.span("y")  # off again after the block


@pytest.mark.parametrize("build", [_dit_classify, _unet_classify], ids=["dit_full", "unet_encode_tail"])
def test_denoiser_counters_equal_a_forward_hook(build):
    engine, run = build()
    hooked = {}

    def hook(module, args, kwargs, output):
        key = (kwargs.get("mode", "full"), (output[0] if isinstance(output, tuple) else output).shape[0])
        hooked[key] = hooked.get(key, 0) + 1

    handle = engine.state.ema_model.register_forward_hook(hook, with_kwargs=True)
    try:
        run()
        run()
    finally:
        handle.remove()
    got = profiling.counters()
    modes = {mode for mode, _ in hooked}
    assert modes == ({"full"} if build is _dit_classify else {"encode", "tail"})
    for mode in modes:
        assert got[f"denoiser.forwards.{mode}"] == sum(n for (m, _), n in hooked.items() if m == mode)
        assert got[f"denoiser.rows.{mode}"] == sum(r * n for (m, r), n in hooked.items() if m == mode)
    assert not {k for k in got if k.startswith("denoiser.")} - {
        f"denoiser.{kind}.{mode}" for kind in ("forwards", "rows") for mode in modes
    }


@pytest.mark.parametrize(
    "build, expected",
    [
        # 2 images of 16x16x1 float32; stage 1: 2 evaluations of 3 classes, stage 2: 2 more of the kept 2
        (_dit_classify, {"classify.calls": 1, "classify.images": 2, "upload.bytes": 2 * 16 * 16 * 4,
                         "tournament.stages": 2}),
        (_dit_train_step, {"train.steps": 1, "train.microbatches": 2, "upload.bytes": 4 * 16 * 16 * 4,
                           "denoiser.forwards.full": 2, "denoiser.rows.full": 4,
                           "norm.layer.plain": 2 * (2 * DIT["num_layers"] + 1), "norm.layer.kernel": None}),
    ],
    ids=["classify", "train_step"],
)
def test_call_counters(build, expected):
    engine, run = build()
    run()
    got = profiling.counters()
    assert {k: got.get(k) for k in expected} == expected
    if "tournament.stages" in expected:
        assert got["tournament.groups"] >= 2  # at least one group a stage
        assert got["attention.flash"] == DIT["num_layers"] * got["denoiser.forwards.full"]
        # a norm before each block's attention and MLP, and the final layer's: the plain
        # version on the CPU
        assert got["norm.layer.plain"] == (2 * DIT["num_layers"] + 1) * got["denoiser.forwards.full"]
        assert "norm.layer.kernel" not in got


@pytest.mark.parametrize("backend, route", [("auto", "flash"), ("pallas", "flash"), ("xla", "plain")])
def test_attention_counters_follow_the_route(backend, route):
    q, k, v = torch.randn(3, 2, 5, 2, 32).unbind(0)
    attention(q, k, v, backend=backend)
    attention(q[..., :16], k[..., :16], v[..., :16], backend=backend)  # D=16: outside the kernels' gate
    got = profiling.counters()
    assert got == ({"attention.flash": 1, "attention.flash.d32": 1, "attention.plain": 1} if route == "flash"
                   else {"attention.plain": 2})


def test_count_returns_the_total_and_reset_clears():
    assert profiling.count("a") == 1
    assert profiling.count("a", 4) == 5
    snapshot = profiling.counters()
    snapshot["a"] = 0  # a copy: the counter is untouched
    assert profiling.counters() == {"a": 5}
    profiling.reset_counters()
    assert profiling.counters() == {}
    assert profiling.count("a") == 1
