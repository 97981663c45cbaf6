"""Port parity for the ResNet baseline: the backbone, its BatchNorm, the classifier engine and its scripts.

1. ResNet-18 and ResNet-50 at a tiny input (2 × 64 × 64 × 10, the IPMSA
   experiment's 10 channels), the same seeded weights and statistics
   through the bridge (``params`` and ``batch_stats``): logits within 1e-5
   of JAX in eval mode (running statistics) and in train mode (batch
   statistics), and the running statistics after that train forward
   within 1e-6 (flax momentum 0.99, the biased variance: not
   ``nn.BatchNorm2d``'s).
2. Two train steps of the classifier engine (ResNet-18, 4 × 64 × 64) against the
   JAX engine's own step (``Classifier._build_train_step``): the losses at
   rtol 1e-5, the running statistics at 1e-6, the parameters as below.
3. ``pretrained_path``: a seeded ``.npz`` in torchvision's names loads as
   the JAX loader loads it, with the fresh stem for 10 channels; a bundle of
   another variant raises.
4. ``experiments/ipmsa-classifier/train_torch.py`` then
   ``inference_torch.py`` on an MRI tree, on the CPU.

The two train steps: Adam's step is about lr·sign(g) for every element, and
a ReLU input within fp32 noise of 0 takes the other side in one package
(each package's fp32 forward lies ~1e-5 from exact arithmetic), which
moves the early layers' gradients by ~0.5% and so the sign-like update of
many of their elements. The head, after the last ReLU, is held at rtol 1e-5
/ atol 2e-6; every other tensor's update (parameter after − before) at
relative L2 5e-2 (measured up to 3.5e-2 in layers 1-2 where a flip
occurred, where a gradient fault moves it by O(1)). ResNet-50's train-mode
logits (batch statistics over 2 × 2 × 2 values a channel at layer 4) are
held at atol 1e-3: measured 3.7e-4 apart, where the port's fp32 lies 5e-5
from its own fp64 run and JAX's 2.2e-4; its running statistics at 1e-5
(measured 4.4e-6 relative in layer 3's variances, 2.6e-6 absolute in
layer 4's means).
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import seeded_params, write_ipmsa_tree
from diffusion_classifier_tpu.engine.classifier import BackboneWithHead as JaxBackboneWithHead
from diffusion_classifier_tpu.engine.classifier import Classifier as JaxClassifier
from diffusion_classifier_tpu.models.resnet import ResNet2D as JaxResNet
from diffusion_classifier_tpu.models.resnet import load_pretrained_resnet as jax_load_pretrained
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from diffusion_classifier_tpu_torch.engine.classifier import BackboneWithHead, Classifier
from diffusion_classifier_tpu_torch.experiments import ipmsa_classifier
from diffusion_classifier_tpu_torch.models.resnet import RESNET_VARIANTS, ResNet2D, load_pretrained_resnet
from diffusion_classifier_tpu_torch.utils import convert
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, CH = 2, 10
VARIANTS = ("resnet18", "resnet50")


@functools.lru_cache(maxsize=None)
def _shapes(variant, in_ch=CH):
    """The JAX ``BackboneWithHead``'s variable shapes (``jax.eval_shape`` of its init; the input's size changes none)."""
    model = JaxBackboneWithHead(JaxResNet(variant=variant, in_channels=in_ch), C)
    x = jax.ShapeDtypeStruct((1, 32, 32, in_ch), jnp.float32)
    return jax.eval_shape(lambda k, a: model.init(k, a, train=False), jax.random.PRNGKey(0), x)


def _variables(variant, seed, in_ch=CH, head=True):
    """Seeded params (``seeded_params``) and running statistics: means N(0, 0.1²), variances in [0.5, 2].

    ``head=False``: the bare ResNet's, the ``backbone`` subtrees of the JAX tree.
    """
    shapes = _shapes(variant, in_ch)
    if not head:
        shapes = {k: v["backbone"] for k, v in shapes.items()}
    variables = seeded_params(shapes, seed)
    rng = np.random.default_rng(seed + 1)

    def stat(path, s):
        if str(path[-1].key) == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return 0.1 * rng.standard_normal(s.shape).astype(np.float32)

    return {**variables, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def _stats(state_dict):
    return {k: v for k, v in state_dict.items() if "running_" in k}


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    variant = request.param
    x = np.random.default_rng(0).standard_normal((2, 64, 64, CH)).astype(np.float32)
    jmodel = JaxBackboneWithHead(JaxResNet(variant=variant, in_channels=CH), C)
    variables = _variables(variant, seed=1)
    port = BackboneWithHead(ResNet2D(variant, in_channels=CH), C)
    port.load_state_dict(convert.flax_to_state_dict(variables, port))
    return variant, jmodel, variables, port, x


def test_full_trees_convert_exactly(pair):
    variant, jmodel, variables, port, _ = pair
    n_params = len(jax.tree.leaves(variables["params"]))
    n_stats = len(jax.tree.leaves(variables["batch_stats"]))
    # conv, BN scale and bias per conv; the head's kernel and bias; mean and var per BN
    convs = {"resnet18": 20, "resnet50": 53}[variant]
    assert (n_params, n_stats) == (3 * convs + 2, 2 * convs)
    assert len(port.state_dict()) == n_params + n_stats
    assert port.backbone.output_dim == RESNET_VARIANTS[variant][2]


def test_forward_eval_and_train_match_jax(pair):
    variant, jmodel, variables, port, x = pair
    def apply(**kw):
        fn = jax.jit(functools.partial(jmodel.apply, **kw))
        return fn.lower(variables, x).compile(compiler_options={"xla_backend_optimization_level": 0})(variables, x)

    want_eval = np.asarray(apply(train=False))
    want_train, updates = apply(train=True, mutable=("batch_stats",))
    with torch.no_grad():
        got_eval = port(torch.from_numpy(x), train=False)
        got_train = port(torch.from_numpy(x), train=True)
    assert got_eval.dtype == torch.float32
    np.testing.assert_allclose(got_eval.numpy(), want_eval, rtol=1e-5, atol=1e-5)
    atol = 1e-5 if variant == "resnet18" else 1e-3
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), rtol=1e-5, atol=atol)
    want_stats = _stats(convert.flax_to_state_dict(
        {"params": variables["params"], "batch_stats": updates["batch_stats"]}, port))
    stat_tol = 1e-6 if variant == "resnet18" else 1e-5
    for name, value in _stats(port.state_dict()).items():
        np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(), rtol=stat_tol, atol=stat_tol,
                                   err_msg=name)
    # restore the fixture's statistics for the other tests
    port.load_state_dict(convert.flax_to_state_dict(variables, port))


def _config(tmp_path=".", **kw):
    base = dict(classes=C, image_size=32, image_channels=CH, learning_rate=1e-3, lr_warmup_steps=1,
                mixed_precision="no", project_root=str(tmp_path), experiment_dir="clf")
    return dict(base, **kw)


def test_two_classifier_train_steps_match_jax():
    rng = np.random.default_rng(3)
    batches = [{"images": rng.standard_normal((4, 64, 64, CH)).astype(np.float32),
                "prompt": rng.integers(0, C, 4).astype(np.int32)} for _ in range(2)]
    variables = _variables("resnet18", seed=6)
    jax_engine = JaxClassifier(JaxResNet(variant="resnet18", in_channels=CH), JaxExperimentConfig(**_config()))
    jax_engine.variables = jax.tree.map(jnp.asarray, variables)
    jax_engine._build_train_step(total_steps=2)
    args = (jax_engine.variables["params"], jax_engine.variables["batch_stats"], jax_engine._opt_state)
    step = jax_engine._step.lower(*args, batches[0]["images"], batches[0]["prompt"]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    want_losses = []
    for b in batches:
        params, stats, jax_engine._opt_state, loss = step(
            jax_engine.variables["params"], jax_engine.variables["batch_stats"], jax_engine._opt_state,
            jnp.asarray(b["images"]), jnp.asarray(b["prompt"]))
        jax_engine.variables = {"params": params, "batch_stats": stats}
        want_losses.append(float(loss))

    engine = Classifier(ResNet2D("resnet18", in_channels=CH), ExperimentConfig(**_config()), device="cpu")
    engine.model.load_state_dict(convert.flax_to_state_dict(variables, engine.model))
    engine._initialised = True
    engine._build_train_step(total_steps=2)
    losses = [engine.train_step(b).item() for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, jax_engine.variables), engine.model)
    init = convert.flax_to_state_dict(variables, engine.model)
    for name, value in engine.model.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            got, ref = value.numpy(), want[name].numpy()
            if name.startswith("head."):
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6, err_msg=name)
            else:  # the update each package made, in relative L2
                du, dw = got - init[name].numpy(), ref - init[name].numpy()
                rel = np.linalg.norm(du - dw) / np.linalg.norm(dw)
                assert rel <= 5e-2, (name, rel)


def _torchvision_bundle(path, variant, in_ch, seed):
    """A seeded ``.npz`` under torchvision's ``state_dict`` names for ``variant``."""
    block, stages, _ = RESNET_VARIANTS[variant]
    rng = np.random.default_rng(seed)
    arrs = {}

    def bn(prefix, c):
        arrs.update({f"{prefix}.weight": rng.standard_normal(c), f"{prefix}.bias": rng.standard_normal(c),
                     f"{prefix}.running_mean": rng.standard_normal(c),
                     f"{prefix}.running_var": rng.uniform(0.5, 2, c)})
        arrs[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)

    arrs["conv1.weight"] = rng.standard_normal((64, in_ch, 7, 7))
    bn("bn1", 64)
    prev, exp = 64, 1 if block == "basic" else 4
    kernels = (3, 3) if block == "basic" else (1, 3, 1)
    for s, blocks in enumerate(stages, start=1):
        c = 64 * 2 ** (s - 1)
        for i in range(blocks):
            p, cin = f"layer{s}.{i}", prev if i == 0 else c * exp
            for j, k in enumerate(kernels, start=1):
                cout = c * exp if j == len(kernels) else c
                arrs[f"{p}.conv{j}.weight"] = rng.standard_normal((cout, cin if j == 1 else c, k, k))
                bn(f"{p}.bn{j}", cout)
            if i == 0 and (s > 1 or exp > 1):
                arrs[f"{p}.downsample.0.weight"] = rng.standard_normal((c * exp, prev, 1, 1))
                bn(f"{p}.downsample.1", c * exp)
        prev = c * exp
    arrs["fc.weight"] = rng.standard_normal((1000, prev))
    arrs["fc.bias"] = rng.standard_normal(1000)
    np.savez(path, **{k: np.asarray(v, np.float32) if v.dtype == np.float64 else v for k, v in arrs.items()})


@pytest.mark.parametrize("variant,in_ch", [("resnet18", 3), ("resnet50", CH)])
def test_pretrained_npz_loads_as_jax_loads_it(tmp_path, variant, in_ch):
    path = str(tmp_path / f"{variant}.npz")
    _torchvision_bundle(path, variant, in_ch, seed=4)
    variables = _variables(variant, seed=5, in_ch=in_ch, head=False)
    variables = {**variables, "batch_stats": jax.tree.map(np.zeros_like, variables["batch_stats"])}
    want = jax_load_pretrained(variables, path, in_channels=in_ch)
    port = ResNet2D(variant, in_channels=in_ch)
    port.load_state_dict(convert.flax_to_state_dict(variables, port))  # the same fresh stem
    load_pretrained_resnet(port, path, in_channels=in_ch)
    want_sd = convert.flax_to_state_dict(want, port)
    for name, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want_sd[name].numpy(), err_msg=name)
    stem = np.load(path)["conv1.weight"]
    assert np.array_equal(port.conv1.weight.detach().numpy(), stem) == (in_ch == 3)
    other = "resnet50" if variant == "resnet18" else "resnet18"
    with pytest.raises((KeyError, ValueError)):
        load_pretrained_resnet(ResNet2D(other, in_channels=in_ch), path, in_channels=in_ch)


def test_pretrained_without_path_warns():
    model = ResNet2D("resnet18", pretrained=True, in_channels=3)
    with pytest.warns(UserWarning, match="pretrained=True without pretrained_path"):
        model(torch.zeros(1, 32, 32, 3))


# --- the entry points on an MRI tree ------------------------------------------------


def _script(name):
    path = os.path.join(REPO, "experiments", "ipmsa-classifier", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ipmsa_classifier_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_then_inference_torch_on_an_mri_tree(tmp_path, monkeypatch):
    exp = tmp_path / "exp"
    write_ipmsa_tree(tmp_path / "volumes", exp / "split", counts=(8, 4, 4), lz4=True)
    monkeypatch.setenv("DATA_PATH", str(tmp_path / "volumes"))
    config = _config(tmp_path, data_path="volumes", experiment_dir="exp", slices=3, image_channels=6,
                     variant="resnet18", batch_size=4, num_workers=2, num_epochs=2, eval_period=1,
                     evaluation_batches=0, use_comet=True)
    monkeypatch.setenv("TRAINING_CONFIG", json.dumps(config))
    engine = _script("train_torch").main(["--device", "cpu"])
    assert isinstance(engine, Classifier) and engine._opt_state.count == 4
    events = [json.loads(line) for line in (exp / "track.jsonl").read_text().splitlines()]
    names = {e.get("name") for e in events}
    assert {"train_loss", "val_loss", "val_accuracy", "val_f1"} <= names
    assert (exp / "checkpoints" / "classifier_state.pt").is_file()
    with open(exp / "checkpoints" / "experiment_state.json") as f:
        assert json.load(f)["epoch"] == 2

    monkeypatch.setenv("INFERENCE_CONFIG", json.dumps(dict(config, use_comet=False)))
    val_loss, metric_output = _script("inference_torch").main(["--device", "cpu"])
    assert np.isfinite(val_loss)
    assert [sorted(d) for d in metric_output] == [["accuracy"], ["f1"], ["precision"], ["recall"]]
    assert all(0.0 <= v <= 1.0 for d in metric_output for v in d.values())
    # the checkpoint carries the running statistics the train forwards moved
    loaded = ipmsa_classifier.build_engine(ExperimentConfig(**config), device="cpu")
    loaded.init_params()
    loaded.load_checkpoint(str(exp / "checkpoints"))
    assert torch.equal(loaded.model.backbone.bn1.running_var, engine.model.backbone.bn1.running_var)
    assert not torch.equal(loaded.model.backbone.bn1.running_var, torch.ones(64))
