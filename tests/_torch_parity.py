"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The tests hand the same numpy inputs to a JAX function and its port, with
the same weights (the flax tree converted by the port's weight bridge) and
the same random draws (made by JAX, replayed through :class:`JaxDraws` for
classification and :class:`JaxTrainDraws` for the train step).
"""

import functools

import jax
import numpy as np
import torch

from diffusion_classifier_tpu_torch.experiments import chexpert_unet as _port_chexpert_unet
from diffusion_classifier_tpu_torch.experiments import ipmsa as _port_ipmsa
from diffusion_classifier_tpu_torch.experiments import ipmsa_dit as _port_ipmsa_dit


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


# tests/test_t5_encoder.py's narrow t5 UNet (8 px, 1 channel, levels (16,
# 32), 2 heads, 8 groups) with encoder_hid_dim 24 where its T5 table is 16
# wide: the context's width must come from the table (flax infers it), not
# from encoder_hid_dim
T5_UNET = dict(
    sample_size=8, in_channels=1, out_channels=1, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
    attention_head_dim=2, cross_attention_dim=16, encoder_hid_dim=24,
    encoder_hid_dim_type="text_proj", norm_num_groups=8,
)
T5_CLASSES = 3
T5_TABLE_SHAPE = (T5_CLASSES + 1, 6, 16)  # 3 classes + the null row, 6 tokens of width 16


def seeded_t5_table(seed: int = 0) -> np.ndarray:
    """A ``[4, 6, 16]`` float32 class table of unit-scale values (a T5 output's scale)."""
    return np.random.default_rng(seed).standard_normal(T5_TABLE_SHAPE).astype(np.float32)


def t5_denoisers(table, hid_type="text_proj"):
    """``(JAX denoiser, port denoiser)`` of :data:`T5_UNET` over ``table``, fp32, ``encoder_hid_dim_type=hid_type``."""
    import jax.numpy as jnp

    from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
    from diffusion_classifier_tpu.models.encoders import make_encoder as jax_make_encoder
    from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
    from diffusion_classifier_tpu.models.unet import UNetConfig as JaxUNetConfig
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.models.encoders import make_encoder
    from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D, UNetConfig

    cfg = dict(T5_UNET, encoder_hid_dim_type=hid_type)
    jenc, _ = jax_make_encoder("t5", num_classes=T5_CLASSES, t5_table=jnp.asarray(table))
    tenc, _ = make_encoder("t5", num_classes=T5_CLASSES, t5_table=table)
    _, s, d = table.shape
    jden = JaxDenoiser(backbone=JaxUNet(JaxUNetConfig(**cfg)), encoder=jenc)
    port = Denoiser(UNetCondition2D(UNetConfig(**cfg), context_tokens=s, context_dim=d), tenc)
    return jden, port


def write_cifar_batches(root, n_train, n_test, classes=10):
    """``cifar-10-batches-py`` under ``root``: five train batches of ``n_train`` images, a test batch of ``n_test``.

    uint8 ``data`` rows of 3 × 32 × 32 channel-major bytes and labels below
    ``classes``, in byte-keyed pickled dicts, as the download holds them.
    """
    import pickle

    root.mkdir(parents=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for seed, name in enumerate(names):
        n = n_test if name == "test_batch" else n_train
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        with open(root / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": list(rng.integers(0, classes, n))}, f)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_params(init_fn, *args, seed: int = 0):
    """A flax tree of ``init_fn(*args)``'s shapes (``jax.eval_shape``: nothing compiles), seeded values.

    Kernels and embeddings ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1²),
    biases ~ N(0, 0.1²): nonzero biases, unlike flax's init, so the bias
    paths are compared too.
    """
    return seeded_params(jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args), seed)


def seeded_params(shapes, seed: int = 0):
    """:func:`random_params`' values for a tree of shapes (``jax.ShapeDtypeStruct`` leaves)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("scale"):
            return 1.0 + 0.1 * z
        if name.endswith("bias"):
            return 0.1 * z
        return z / np.sqrt(np.prod(s.shape[:-1]))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# 2 layers, 2 heads x 32 (width 64), 32 px at patch 4: 64 tokens
TINY_DIT = dict(
    num_attention_heads=2, attention_head_dim=32, in_channels=4, num_layers=2,
    sample_size=32, patch_size=4, num_classes=3,
)
TINY_DIT_TRAIN = dict(
    lr=1e-3, warmup=2, total=3, ema=dict(beta=0.9999, update_after_step=1, update_every=1)
)


@functools.lru_cache(maxsize=1)
def tiny_dit_run():
    """``(flax params, 3 batches of (x [4, 32, 32, 4], y [4]), 3 step keys)`` for :data:`TINY_DIT`."""
    from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
    from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig

    rng = np.random.default_rng(5)
    batches = [
        (rng.uniform(-1, 1, (4, 32, 32, 4)).astype(np.float32), rng.integers(0, 3, 4).astype(np.int32))
        for _ in range(3)
    ]
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    x0, y0 = batches[0]
    init = jax.jit(JaxDiT(JaxDiTConfig(**TINY_DIT)).init)
    params = to_numpy_tree(init(jax.random.PRNGKey(0), x0, np.zeros(4, np.float32), y0))
    return params, batches, keys


@functools.lru_cache(maxsize=2)
def jax_tiny_dit_train(k: int):
    """The JAX package's three train steps on :func:`tiny_dit_run` with ``k`` microbatches.

    XLA attention (the Pallas backward is held to the port's in
    test_torch_ops). Returns ``(losses, params, ema_params)``.
    """
    import jax.numpy as jnp

    from diffusion_classifier_tpu.diffusion.schedule import make_schedule_fn as jax_schedule_fn
    from diffusion_classifier_tpu.engine import state as jax_state
    from diffusion_classifier_tpu.engine import steps as jax_steps
    from diffusion_classifier_tpu.models.dit import DiT as JaxDiT
    from diffusion_classifier_tpu.models.dit import DiTConfig as JaxDiTConfig

    params, batches, keys = tiny_dit_run()
    train = TINY_DIT_TRAIN
    dit = JaxDiT(JaxDiTConfig(**TINY_DIT, attn_backend="xla"))
    schedule = jax_schedule_fn("shifted_cosine", 64, 32)
    loss_fn = jax_steps.make_loss_fn(
        lambda p, z, lg, lab: dit.apply(p, z, lg, lab), schedule, pred_param="v", null_token=3
    )
    tx = jax_state.make_optimizer(train["lr"], train["warmup"], train["total"])
    step = jax_steps.make_train_step(
        loss_fn, tx, jax_state.EmaConfig(**train["ema"]), grad_accum_steps=k, donate=False
    )
    st = jax_state.init_train_state(params, tx)
    losses = []
    for (x, y), key in zip(batches, keys):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y), key)
        losses.append(float(loss))
    return losses, to_numpy_tree(st.params), to_numpy_tree(st.ema_params)


# fp32 on both sides; they differ in summation order (matmuls, attention,
# the global norm) and in where float32 rounds Adam's and the EMA's scalars.
# Held to rtol 1e-5 / atol 2e-6. One exception: the key third of each qkv
# bias has a gradient that is zero in exact arithmetic (softmax ignores a
# shift shared by all keys), so both sides hold rounding noise there, which
# Adam's normalisation turns into steps of size ~lr and arbitrary sign;
# those entries are held to 2·lr.
def assert_dit_state_close(got: dict, want: dict, lr: float = TINY_DIT_TRAIN["lr"]) -> None:
    """A trained tiny DiT's state dict against the JAX run's, bridged to the same names."""
    for name, value in got.items():
        got_np, want_np = np.asarray(value), np.asarray(want[name])
        if name.endswith("qkv.bias"):
            width = got_np.shape[0] // 3
            key = slice(width, 2 * width)
            np.testing.assert_allclose(got_np[key], want_np[key], rtol=0, atol=2 * lr)
            got_np, want_np = np.delete(got_np, key), np.delete(want_np, key)
        np.testing.assert_allclose(got_np, want_np, rtol=1e-5, atol=2e-6, err_msg=name)


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


# --- IPMSA: lz4 frames without the lz4 wheel, MRI volume trees ------------------

LZ4_MAGIC = 0x184D2204


def lz4_frame(blocks, content_size=None) -> bytes:
    """An LZ4 frame of ``(payload, compressed)`` blocks, as ``tests/test_lz4.py`` builds them.

    FLG 0x40 (version 1, independent blocks), BD 0x40 (64 KB blocks), an
    optional 8-byte content size, an unchecked header checksum, each block
    with its size word (high bit: stored), then the end mark.
    """
    import struct

    out = [struct.pack("<I", LZ4_MAGIC), bytes([0x40 | (0x08 if content_size is not None else 0), 0x40])]
    if content_size is not None:
        out.append(struct.pack("<Q", content_size))
    out.append(b"\x00")
    for payload, compressed in blocks:
        out.append(struct.pack("<I", len(payload) | (0 if compressed else 0x80000000)))
        out.append(payload)
    out.append(struct.pack("<I", 0))
    return b"".join(out)


def lz4_sequence(literals: bytes, match_offset: int, match_len: int) -> bytes:
    """One compressed-block sequence: up to 14 literals, then a match of 4-18 bytes."""
    import struct

    assert 4 <= match_len <= 18 and len(literals) < 15
    return bytes([(len(literals) << 4) | (match_len - 4)]) + literals + struct.pack("<H", match_offset)


def lz4_literal_block(data: bytes) -> bytes:
    """A compressed block that is one sequence of literals and no match (a valid last sequence)."""
    n = len(data) - 15
    if n < 0:
        return bytes([len(data) << 4]) + data
    return bytes([0xF0]) + b"\xff" * (n // 255) + bytes([n % 255]) + data


def npy_lz4_bytes(arr: np.ndarray) -> bytes:
    """``arr`` as a `.npy.lz4` file: its `.npy` bytes in 64 KB blocks, stored and compressed in turn."""
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    data = buf.getvalue()
    chunks = [data[i: i + 65536] for i in range(0, len(data), 65536)]
    blocks = [(lz4_literal_block(c), True) if i % 2 else (c, False) for i, c in enumerate(chunks)]
    return lz4_frame(blocks, content_size=len(data))


# the experiment's own builder, kept before a test monkeypatches it with narrow_ipmsa_unet
_PORT_IPMSA_UNET = _port_ipmsa.build_backbone

# the volume layout the LORIS transforms expect: [t, D, H, W] per channel,
# stacked over the index's timepoints. FLAIR, CT2F and the brain MASK at
# W000/W048/W096; NEWT2 (new lesions) at W048/W096, padded at the front to 3
# by PadTimepoints; AGE a clinical value
IPMSA_TIMEPOINTS = ("W000", "W048", "W096")


def write_ipmsa_tree(data_root, split_dir, *, counts=(8, 4, 4), shape=(7, 28, 24), lz4=False,
                     seed=0, blocklist=None):
    """MRI volumes under ``data_root/<trial>/<patient>/`` and the three split pickles in ``split_dir``.

    ``counts`` samples in the train, val and test splits, ``shape`` (D, H, W)
    per volume, every other sample active (new T2 lesions in the centre
    slab at W048 or W096). Index entries name the files without their
    extension (``.npy``, or ``.npy.lz4`` with ``lz4``), as the trial's index
    does. With ``blocklist``, also writes a blocklist there whose one line
    names the first train sample's (trial, patient). Returns the split
    pickles' paths ``(train, val, test)``.
    """
    import os
    import pickle

    rng = np.random.default_rng(seed)
    data_root, split_dir = str(data_root), str(split_dir)
    os.makedirs(split_dir, exist_ok=True)
    d, h, w = shape
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape), indexing="ij")
    brain = ((zz / 1.2) ** 2 + yy**2 + xx**2 < 0.8).astype(np.float32)
    template = {
        "FLAIR": [["MRI_AND_LABEL", "FLAIR", tp] for tp in IPMSA_TIMEPOINTS],
        "CT2F": [["MRI_AND_LABEL", "CT2F", tp] for tp in IPMSA_TIMEPOINTS],
        "NEWT2": [["MRI_AND_LABEL", "NEWT2", tp] for tp in IPMSA_TIMEPOINTS[1:]],
        "MASK": [["MRI_AND_LABEL", "MASK", tp] for tp in IPMSA_TIMEPOINTS],
        "AGE": [["CLINICAL", "AGE"]],
    }
    ext = ".npy.lz4" if lz4 else ".npy"
    paths, n = [], 0
    for split, count in zip(("train", "val", "test"), counts):
        entries = {}
        for i in range(count):
            trial, patient = f"trial{n % 3}", f"patient{n:04d}"
            rel_dir = os.path.join(trial, patient)
            os.makedirs(os.path.join(data_root, rel_dir), exist_ok=True)
            entry = {"MRI_AND_LABEL": {}, "CLINICAL": {"AGE": float(30 + n)}}
            active = n % 2 == 0
            for key in ("FLAIR", "CT2F", "NEWT2", "MASK"):
                entry["MRI_AND_LABEL"][key] = {}
                for t, tp in enumerate(IPMSA_TIMEPOINTS):
                    if key == "NEWT2" and t == 0:
                        continue
                    if key == "FLAIR":
                        vol = (rng.random(shape) * 40 + 60 * (1 + zz)) * brain
                    elif key == "MASK":
                        vol = brain
                    else:
                        vol = ((rng.random(shape) > 0.97) * brain).astype(np.float32)
                        if key == "NEWT2":
                            vol[:] = 0.0
                            if active and t == 1 + n % 4 // 2:
                                vol[d // 2, h // 2 - 1: h // 2 + 1, w // 2: w // 2 + 2] = 1.0
                    rel = os.path.join(rel_dir, f"{key.lower()}_{tp}")
                    vol = vol.astype(np.float32)
                    with open(os.path.join(data_root, rel + ext), "wb") as f:
                        if lz4:
                            f.write(npy_lz4_bytes(vol))
                        else:
                            np.save(f, vol)
                    entry["MRI_AND_LABEL"][key][tp] = rel
            entries[f"{split}{i:03d}"] = entry
            n += 1
        path = os.path.join(split_dir, f"{split}_dataset_filtered.pkl")
        with open(path, "wb") as f:
            pickle.dump({"dataset_dict": entries, "item_template": template}, f)
        paths.append(path)
    if blocklist is not None:
        first = os.path.join(data_root, "trial0", "patient0000", "flair_W000" + ext)
        parts = first.split("/")  # (trial, patient) are absolute-path parts 3 and 4
        with open(blocklist, "w") as f:
            f.write(f"x/{parts[3]}/{parts[4]}/rest\n")
    return tuple(paths)


def jax_experiment_common(experiment: str):
    """``experiments/<experiment>/common.py`` of the JAX package, loaded by path."""
    import importlib.util
    import os

    folder = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", experiment)
    spec = importlib.util.spec_from_file_location(f"jax_{experiment.replace('-', '_')}_common",
                                                  os.path.join(folder, "common.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- the IPMSA UNet at a narrow width ---------------------------------------------

# the experiment's five levels and block types, narrow and one resnet (and
# transformer) a level for the CPU's time, with one head a level so that
# level 3 runs D=64 (the flash kernels' plain version on the CPU) and level 4
# and the mid block D=96 (the route outside the gate), as the full width's 8
# heads do; 8 groups as the CheXpert UNet's narrow width
IPMSA_UNET_NARROW = dict(
    block_out_channels=(32, 32, 32, 64, 96), layers_per_block=1, encoder_hid_dim=16,
    cross_attention_dim=16, norm_num_groups=8, attention_head_dim=1,
)


def narrow_ipmsa_unet(config):
    """The port IPMSA experiment's backbone for ``config``, at :data:`IPMSA_UNET_NARROW`'s widths."""
    import dataclasses

    from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D

    with torch.device("meta"):
        full = _PORT_IPMSA_UNET(config)
    return UNetCondition2D(dataclasses.replace(full.config, **IPMSA_UNET_NARROW), full.dtype)


# the IPMSA DiT narrowed for the CPU: 2 layers of 2 heads x 32 (the
# experiment's: 12 layers of 6 x 64)
IPMSA_DIT_NARROW = dict(num_attention_heads=2, attention_head_dim=32, num_layers=2)
_PORT_IPMSA_DIT = _port_ipmsa_dit.build_backbone


def narrow_ipmsa_dit(config):
    """The port IPMSA DiT experiment's backbone for ``config``, at :data:`IPMSA_DIT_NARROW`."""
    import dataclasses

    from diffusion_classifier_tpu_torch.models.dit import DiT

    with torch.device("meta"):
        full = _PORT_IPMSA_DIT(config)
    return DiT(dataclasses.replace(full.config, **IPMSA_DIT_NARROW), full.dtype)


# the IPMSA experiments' data: 5 slices of FLAIR and CT2F (10 channels) at 256 px through the Haar DWT
IPMSA_CONFIG = dict(image_size=256, image_channels=10, slices=5, wavelet_transform=True, classes=2,
                    encoder_type="nn", mixed_precision="no")
# the narrow net's data: 32 px, 3 slices: 16 x 16 x 24 after the DWT
IPMSA_NARROW_DATA = dict(image_size=32, image_channels=6, slices=3)


@functools.lru_cache(maxsize=1)
def narrow_ipmsa_pair():
    """``(jax_denoiser, params, (x, logsnr, labels))`` at :data:`IPMSA_UNET_NARROW` on 16 x 16 x 24 inputs.

    The JAX experiment's backbone at the narrow widths, a 16-wide class
    embedder, seeded weights (``random_params``); labels include the null
    token. Built once a process (tracing the flax init takes seconds): the
    callers only read it.
    """
    import dataclasses

    from diffusion_classifier_tpu.engine.denoiser import Denoiser as JaxDenoiser
    from diffusion_classifier_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
    from diffusion_classifier_tpu.models.unet import UNetCondition2D as JaxUNet
    from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig

    c = IPMSA_CONFIG["classes"]
    net = jax_experiment_common("ipmsa").build_backbone(
        JaxExperimentConfig(**dict(IPMSA_CONFIG, **IPMSA_NARROW_DATA)))
    jden = JaxDenoiser(
        backbone=JaxUNet(dataclasses.replace(net.config, **IPMSA_UNET_NARROW)),
        encoder=JaxClassEmbedder(c, 16),
    )
    rng = np.random.default_rng(31)
    x = rng.uniform(-1, 1, (4, 16, 16, 24)).astype(np.float32)
    lg = rng.uniform(-5, 5, 4).astype(np.float32)
    y = np.array([0, 1, c, 1], np.int32)
    return jden, random_params(jden.init, x, lg, y, seed=32), (x, lg, y)


def narrow_ipmsa_port(params, dtype=torch.float32):
    """The port's narrow IPMSA denoiser in ``dtype`` with the flax ``params`` bridged."""
    from diffusion_classifier_tpu_torch.engine.denoiser import Denoiser
    from diffusion_classifier_tpu_torch.models.encoders import ClassEmbedder
    from diffusion_classifier_tpu_torch.models.unet import UNetCondition2D
    from diffusion_classifier_tpu_torch.utils import convert
    from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

    cfg = narrow_ipmsa_unet(ExperimentConfig(**dict(IPMSA_CONFIG, **IPMSA_NARROW_DATA))).config
    model = Denoiser(UNetCondition2D(cfg, dtype), ClassEmbedder(IPMSA_CONFIG["classes"], 16, dtype))
    model.load_state_dict(convert.flax_to_state_dict(params, model))
    return model.to(dtype)
