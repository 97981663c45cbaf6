"""Port parity for the IPMSA data path: the lz4 decoder, the LORIS transforms, the dataset and the loader.

1. The port's build of ``native/lz4dec.cpp`` decodes the handcrafted
   frames of ``tests/test_lz4.py`` (stored, compressed with overlapping
   matches, several blocks, a content size) as the JAX package's decoder
   does, and both raise on a malformed frame.
2. Every ``LORISTransforms`` step, and the experiments' pipeline
   (``make_default_transform``, with and without ``cf_label``), on seeded
   volumes: bit-exact against JAX (the same numpy and scipy calls).
3. ``IPMSADataset`` and ``IPMSADataLoader`` on MRI trees written under
   ``tmp_path`` (``_torch_parity.write_ipmsa_tree``): batches bit-exact
   against the JAX loader at 0 and 2 workers, from ``.npy`` and from
   ``.npy.lz4``, over two epochs of the three splits; the per-sample pickle
   cache writes the JAX cache's bytes; ``remove_condition`` drops and
   re-pickles as JAX does.
"""

import os
import pickle

import numpy as np
import pytest

from _torch_parity import (
    assert_same_batches,
    lz4_frame,
    lz4_literal_block,
    lz4_sequence,
    write_ipmsa_tree,
)
from diffusion_classifier_tpu.data import ipmsa as jax_ipmsa
from diffusion_classifier_tpu.utils import lz4io as jax_lz4io
from diffusion_classifier_tpu_torch.data import ipmsa
from diffusion_classifier_tpu_torch.utils import lz4io

T, JT = ipmsa.LORISTransforms, jax_ipmsa.LORISTransforms
K = ipmsa.MRIImageKeys

FRAMES = {
    "stored": (lz4_frame([(bytes(range(256)) * 10, False)]), bytes(range(256)) * 10),
    "match": (lz4_frame([(lz4_sequence(b"0123456789", 10, 10), True)]), b"0123456789" * 2),
    "overlapping_rle": (lz4_frame([(lz4_sequence(b"a", 1, 18), True)]), b"a" * 19),
    "content_size": (lz4_frame([(b"x" * 100000, False)], content_size=100000), b"x" * 100000),
    "blocks": (lz4_frame([(b"hello ", False), (lz4_sequence(b"world", 5, 5), True)]), b"hello worldworld"),
    "literals": (lz4_frame([(lz4_literal_block(b"y" * 300), True)]), b"y" * 300),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_lz4_decoder_matches_the_jax_decoder(name):
    frame, want = FRAMES[name]
    assert lz4io.decompress(frame) == want == jax_lz4io.decompress(frame)


def test_lz4_malformed_frame_raises_in_both():
    for module in (lz4io, jax_lz4io):
        with pytest.raises(ValueError):
            module.decompress(b"\x00\x00\x00\x00garbage")
    truncated = FRAMES["match"][0][:-6]  # the block runs past the end of the frame
    for module in (lz4io, jax_lz4io):
        with pytest.raises(ValueError):
            module.decompress(truncated)


def test_lz4_library_is_built_under_build():
    path = lz4io.library_path()
    assert lz4io.native_available() and os.path.isfile(path)
    assert os.sep + os.path.join("build", "torch_native") + os.sep in path


# --- the transforms -------------------------------------------------------------


def _volumes(seed=0, t=3, shape=(7, 12, 10)):
    rng = np.random.default_rng(seed)
    return {
        K.FLAIR: (rng.random((t, *shape)) * 80).astype(np.float32),
        K.CT2F: (rng.random((t, *shape)) > 0.8).astype(np.float32) * 2.5,
        K.NEWT2: (rng.random((t - 1, *shape)) > 0.9).astype(np.float32),
        K.GAD: (rng.random((1, *shape)) > 0.95).astype(np.float32) * 3,
        K.MASK: (rng.random((t, *shape)) > 0.2).astype(np.float32),
        "AGE": [42.0],
    }


def _copy(vols):
    return {k: v.copy() if isinstance(v, np.ndarray) else list(v) for k, v in vols.items()}


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


# each step alone, and the chain so far: bit-exact, since both run the same numpy and scipy calls
STEPS = [
    ("PadTimepoints", (), ()),
    ("GetSlice", (3,), (3,)),
    ("Denoise", (), ()),
    ("BinarizeLabel", (), ()),
    ("Resize", (), ()),
    ("ToTensor", (), ()),
    ("BlurLabel3D", (), ()),
    ("NormalizeTensor", (), ()),
]


def test_loris_transforms_step_by_step_match_jax():
    got, want = _volumes(), _volumes()
    for name, args, jargs in STEPS:
        got = getattr(T, name)(*args)(got)
        want = getattr(JT, name)(*jargs)(want)
        _assert_same(got, want)
    assert got[K.FLAIR].shape == (3, 3, 16, 16)


@pytest.mark.parametrize(
    "name,args",
    [("GetSlice", (1,)), ("GetSlice", (5,)), ("Normalize", ()), ("Normalize", (1,)),
     ("BlurLabel3D", (1.5, 3))],
)
def test_loris_transform_variants_match_jax(name, args):
    vols = T.PadTimepoints()(_volumes(seed=1))
    _assert_same(getattr(T, name)(*args)(_copy(vols)), getattr(JT, name)(*args)(_copy(vols)))


def test_blur_label_2d_matches_jax():
    vols = T.GetSlice(3)(T.PadTimepoints()(_volumes(seed=2)))
    _assert_same(T.BlurLabel2D(depth=3)(_copy(vols)), JT.BlurLabel2D(depth=3)(_copy(vols)))


@pytest.mark.parametrize("cf_label", [None, 0, 1])
def test_default_transform_matches_jax(cf_label):
    for seed in range(3):
        item = {"output": _volumes(seed=seed), "idx": {"trial_id": "t", "patient_id": "p"}}
        got = ipmsa.make_default_transform(3, True, cf_label=cf_label)(
            {"output": _copy(item["output"]), "idx": item["idx"]})
        want = jax_ipmsa.make_default_transform(3, True, cf_label=cf_label)(
            {"output": _copy(item["output"]), "idx": item["idx"]})
        _assert_same(got, want)
        assert got["images"].shape == (16, 16, 6) and got["prompt"].dtype == np.int32


# --- the dataset and the loader on MRI trees --------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["npy", "npy_lz4"])
def tree(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("ipmsa_lz4" if request.param else "ipmsa_npy")
    splits = write_ipmsa_tree(root / "volumes", root / "split", lz4=request.param,
                              blocklist=root / "blocklist.txt")
    return root, splits


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(tree, workers, monkeypatch):
    root, splits = tree
    monkeypatch.setenv("DATA_PATH", str(root / "volumes"))
    kw = dict(slurm=False, batch_size=4, num_workers=workers, seed=5)
    for cf_label in (None, 1):
        got = ipmsa.IPMSADataLoader(*splits, ipmsa.make_default_transform(3, cf_label=cf_label), **kw)
        want = jax_ipmsa.IPMSADataLoader(
            *splits, jax_ipmsa.make_default_transform(3, cf_label=cf_label), **kw)
        for get in ("get_train_loader", "get_val_loader", "get_test_loader"):
            for _ in range(2):  # two epochs: the train split reshuffles
                assert_same_batches(getattr(got, get)(), getattr(want, get)())
        labels = np.concatenate([b["prompt"] for b in got.get_train_loader()])
        if cf_label is None:
            assert 0 < labels.sum() < len(labels)  # both labels occur: the label path is exercised
        else:
            assert (labels == cf_label).all()


def test_dataset_cache_and_remove_condition_match_jax(tree, tmp_path, monkeypatch):
    root, splits = tree
    monkeypatch.setenv("DATA_PATH", str(root / "volumes"))
    caches = [tmp_path / "port", tmp_path / "jax"]
    datasets = []
    for module, cache in zip((ipmsa, jax_ipmsa), caches):
        ds = module.IPMSADataset(splits[0], cache_dir=str(cache))
        ds.set_transform(module.make_default_transform(3))
        datasets.append(ds)
    port, jax_ds = datasets
    assert port.sample_keys == jax_ds.sample_keys and port._manifest == jax_ds._manifest
    for i in range(len(port)):
        first = port[i]
        _assert_same(first, jax_ds[i])
        name = f"{port.sample_keys[i]}.pkl"
        # the port's cache holds the JAX cache's bytes, so the two formats are one
        assert (caches[0] / name).read_bytes() == (caches[1] / name).read_bytes()
        _assert_same(port[i], first)  # the second read comes from the cache
    # a cached item is what a read returns, transform or not (no decode)
    port.transform = None
    cached = pickle.loads((caches[0] / f"{port.sample_keys[0]}.pkl").read_bytes())
    assert sorted(cached) == ["images", "prompt"]
    _assert_same(port[0], cached)

    outs = []
    for module, name in ((ipmsa, "port"), (jax_ipmsa, "jax")):
        ds = module.IPMSADataset(splits[0])
        n = len(ds)
        ds.remove_condition(str(root / "blocklist.txt"), name=name)
        with open(splits[0].replace(".pkl", f"_{name}.pkl"), "rb") as f:
            outs.append((n - len(ds), pickle.load(f)))
    assert outs[0] == outs[1]
    assert outs[0][0] >= 1 and outs[0][1]["sample_keys"] == [
        k for k in outs[0][1]["dataset_dict"]]
