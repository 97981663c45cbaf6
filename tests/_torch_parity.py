"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The tests hand the same numpy inputs to a JAX function and its port, with
the same weights (the flax tree converted by the port's weight bridge) and
the same random draws (made by JAX, replayed through :class:`JaxDraws` for
classification and :class:`JaxTrainDraws` for the train step).
"""

import jax
import numpy as np
import torch

from diffusion_classifier_tpu_torch.experiments import chexpert_unet as _port_chexpert_unet


# __graft_entry__.py's tiny flagship UNet: 8 px, levels (16, 32), the second
# a cross-attention level (2 heads x 16, 16 tokens), 8 groups; its up path
# takes both the split-halves and the concat resnet skips
TINY_UNET = dict(
    sample_size=8, in_channels=3, out_channels=3, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
    attention_head_dim=2, cross_attention_dim=16, encoder_hid_dim=16,
    encoder_hid_dim_type="text_proj", norm_num_groups=8,
)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_params(init_fn, *args, seed: int = 0):
    """A flax tree of ``init_fn(*args)``'s shapes (``jax.eval_shape``: nothing compiles), seeded values.

    Kernels and embeddings ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1²),
    biases ~ N(0, 0.1²): nonzero biases, unlike flax's init, so the bias
    paths are compared too.
    """
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("scale"):
            return 1.0 + 0.1 * z
        if name.endswith("bias"):
            return 0.1 * z
        return z / np.sqrt(np.prod(s.shape[:-1]))

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class JaxDraws:
    """Replays ``diffusion/classify.py``'s JAX key tree as a port ``Draws`` provider.

    ``classify(params, x, labels, rng)``: in fast mode ``rng, k_sel =
    split(rng)`` and the selection is ``randint(k_sel, shape, 0, C-1)``
    (`:267-273`); then ``stage_rngs = split(rng, n_stages)`` (`:287`), per
    stage ``keys = split(stage_rng, n_groups)`` (`:167`), per group
    ``k_t, k_eps = split(key)``, ``t = uniform(k_t, [G, B])`` and
    ``ε = normal(k_eps, [G, *x.shape])`` (`:178-183`).
    """

    def __init__(self, rng, fast: bool):
        self.k_sel = None
        if fast:
            rng, self.k_sel = jax.random.split(rng)
        self.rng = rng

    def fast_select(self, shape, high):
        sel = jax.random.randint(self.k_sel, shape, 0, high)
        return torch.from_numpy(np.asarray(sel).astype(np.int64))

    def noise(self, stage, n_stages, group_idx, n_groups, t_shape, eps_shape):
        stage_rng = jax.random.split(self.rng, n_stages)[stage]
        key = jax.random.split(stage_rng, n_groups)[group_idx]
        k_t, k_eps = jax.random.split(key)
        t = jax.random.uniform(k_t, t_shape)
        eps = jax.random.normal(k_eps, eps_shape, dtype=jax.numpy.float32)
        return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


class JaxTrainDraws:
    """Replays ``engine/steps.py``'s JAX key tree as a port ``TrainDraws`` provider.

    ``train_step(state, x, labels, rng)``: with ``k`` microbatches the step
    takes ``split(rng, k)[i]`` for microbatch ``i`` (`:89`), else ``rng``
    itself; the loss splits its key as ``r_drop, r_t, r_noise = split(key,
    3)`` (`:47`) and draws ``u = uniform(r_drop, [b])``, ``t = uniform(r_t,
    [b])``, ``ε = normal(r_noise, x.shape)``.
    """

    def __init__(self, rng):
        self.rng = rng

    def loss(self, micro, n_micro, batch, x_shape):
        key = self.rng if n_micro == 1 else jax.random.split(self.rng, n_micro)[micro]
        r_drop, r_t, r_noise = jax.random.split(key, 3)
        u = jax.random.uniform(r_drop, (batch,))
        t = jax.random.uniform(r_t, (batch,))
        eps = jax.random.normal(r_noise, x_shape, dtype=jax.numpy.float32)
        return tuple(torch.from_numpy(np.array(a)) for a in (u, t, eps))


class JaxSampleDraws:
    """Replays ``diffusion/sampler.py``'s JAX key tree as a port ``SampleDraws`` provider.

    ``sample(params, x, labels, rng, from_t)``: ``k_init, k_loop =
    split(rng)`` (`:62`); the start is ``normal(k_init, x.shape)``, or the
    same draw as ``diffuse``'s ε when ``from_t < 1`` (`:63-68`); each noisy
    step takes ``key, sub = split(key)`` from ``k_loop`` on and draws
    ``normal(sub, shape)`` (`:95-96`). Steps must be asked for in order.
    """

    def __init__(self, rng):
        self.k_init, self.key = jax.random.split(rng)

    def init(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.k_init, shape)))

    def step(self, index, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- data-format trees ----------------------------------------------------------

CHEXPERT_COLUMNS = [
    "Path", "Sex", "Age", "Frontal/Lateral", "AP/PA", "No Finding",
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity", "Lung Lesion", "Edema",
    "Consolidation", "Pneumonia", "Atelectasis", "Pneumothorax", "Pleural Effusion",
    "Pleural Other", "Fracture", "Support Devices",
]


def _write_csv(path, header, rows):
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def _save_image(path, rng, size, mode="RGB", fmt=None):
    import os

    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    w, h = size
    if mode == "I;16":
        Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16)).save(path)  # 16-bit grey
    else:
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(
            path, format=fmt, quality=90
        )


def write_chexpert_tree(root, n_each=12, size=(40, 48), seed=0):
    """A CheXpert tree: ``train.csv`` in CheXpert's columns and a JPEG per frontal study-1 row.

    ``n_each`` effusion and ``n_each + 3`` no-finding rows pass the filter
    (so the balancing drops three), with one row for each clause that drops
    one: a lateral view, a second study, -1 in either column, both
    positive, both empty. Returns ``root`` as a string.
    """
    import os

    rng = np.random.default_rng(seed)
    root = str(root)
    rows = []

    def row(i, effusion, no_finding, view="view1_frontal", study="study1"):
        values = dict.fromkeys(CHEXPERT_COLUMNS, "")
        values.update({
            "Path": f"CheXpert-v1.0-small/train/patient{i:05d}/{study}/{view}.jpg",
            "Sex": "Female" if i % 2 else "Male", "Age": str(40 + i % 50),
            "Frontal/Lateral": "Lateral" if "lateral" in view else "Frontal", "AP/PA": "AP",
            "No Finding": no_finding, "Pleural Effusion": effusion,
        })
        rows.append([values[c] for c in CHEXPERT_COLUMNS])

    i = 0
    for k in range(n_each):
        row(i, "1.0", "" if k % 2 else "0.0")
        i += 1
    for k in range(n_each + 3):
        row(i, "" if k % 3 else "0.0", "1.0")
        i += 1
    for effusion, no_finding, view, study in (
        ("1.0", "", "view2_lateral", "study1"), ("1.0", "", "view1_frontal", "study2"),
        ("-1.0", "1.0", "view1_frontal", "study1"), ("1.0", "-1.0", "view1_frontal", "study1"),
        ("1.0", "1.0", "view1_frontal", "study1"), ("", "", "view1_frontal", "study1"),
    ):
        row(i, effusion, no_finding, view, study)
        i += 1
    order = rng.permutation(len(rows))
    os.makedirs(root, exist_ok=True)
    _write_csv(os.path.join(root, "train.csv"), CHEXPERT_COLUMNS, [rows[j] for j in order])
    for r in rows:
        path = r[0]
        if "study1/view1_frontal" in path:
            _save_image(os.path.join(root, *path.split("/")[1:]), rng, size)
    return root


def write_mimic_tree(root, n=10, size=(48, 40), seed=1):
    """``mimic_pa_metadata.csv`` (labels 0, 1, empty, -1) and its JPEGs under ``files/``."""
    import os

    rng = np.random.default_rng(seed)
    root = str(root)
    labels = ["0.0", "1.0", "", "-1.0", "1.0"]
    rows = [(f"mimic-cxr/files/p1{i}/s{i}/img{i}.jpg", labels[i % 5]) for i in range(n)]
    os.makedirs(root, exist_ok=True)
    _write_csv(os.path.join(root, "mimic_pa_metadata.csv"), ["image_path", "Pleural Effusion"], rows)
    for path, _ in rows:
        _save_image(os.path.join(root, *path.split("/")[2:]), rng, size)
    return root


def write_padchest_tree(root, n=10, size=(36, 44), seed=2):
    """``padchest-v1.csv`` (labels 0, 1, empty, -1) and 16-bit grey PNGs."""
    import os

    rng = np.random.default_rng(seed)
    root = str(root)
    labels = ["0", "1", "", "-1"]
    rows = [(f"img_{i}.png", labels[i % 4]) for i in range(n)]
    os.makedirs(root, exist_ok=True)
    _write_csv(os.path.join(root, "padchest-v1.csv"), ["ImageID", "PleuralEffusion"], rows)
    for name, _ in rows:
        _save_image(os.path.join(root, name), rng, size, mode="I;16")
    return root


def write_isic_tree(root, n=25, size=(44, 36), seed=3):
    """``train_balanced.csv`` (``image_name``, ``target``) and ``images/<name>.jpg``."""
    import os

    rng = np.random.default_rng(seed)
    root = str(root)
    names = [f"ISIC_{i:07d}" for i in range(n)]
    os.makedirs(root, exist_ok=True)
    _write_csv(os.path.join(root, "train_balanced.csv"), ["image_name", "target"],
               [(name, i % 2) for i, name in enumerate(names)])
    for name in names:
        _save_image(os.path.join(root, "images", f"{name}.jpg"), rng, size, fmt="JPEG")
    return root


def assert_same_batches(got, want):
    """Two iterables of loader batches: the same keys, dtypes and values, bit for bit."""
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)


# --- the CheXpert UNet at a narrow width ----------------------------------------

# the experiment's levels, blocks and 8 heads, narrow: D=12 at level 2. 8
# groups keep 4 channels a GroupNorm group at level 0, as the full width has
# 8: with one channel a group the norm cancels the conv biases before it, and
# their gradients, zero in exact arithmetic, are float noise that Adam's
# first step scales to ±lr
CHEXPERT_UNET_NARROW = dict(
    block_out_channels=(32, 64, 96), encoder_hid_dim=16, cross_attention_dim=16, norm_num_groups=8,
)


def jax_chexpert_unet_common():
    """``experiments/chexpert-unet/common.py`` of the JAX package, loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", "chexpert-unet", "common.py")
    spec = importlib.util.spec_from_file_location("jax_chexpert_unet_common", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the experiment's own builder, kept before a test monkeypatches it with narrow_chexpert_unet
_PORT_CHEXPERT_UNET = _port_chexpert_unet.build_backbone


def narrow_chexpert_unet(config):
    """The port experiment's backbone for ``config``, at :data:`CHEXPERT_UNET_NARROW`'s widths."""
    import dataclasses

    from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D

    with torch.device("meta"):
        full = _PORT_CHEXPERT_UNET(config)
    return UNetCondition2D(dataclasses.replace(full.config, **CHEXPERT_UNET_NARROW), full.dtype)
