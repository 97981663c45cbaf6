"""The port's CheXpert data path against the JAX package's.

1. The four CSV readers (CheXpert, MIMIC, PadChest, ISIC) on random CSV
   files (hypothesis, few examples): the same paths and labels in the same
   order as the JAX loaders' pandas filters, every split.
2. CheXpert loader batches on a data-format tree written under
   ``tmp_path`` (JPEGs, ``train.csv`` in CheXpert's columns): bit-identical
   to the JAX loader's for 0 and 2 workers, with and without
   ``fast_decode`` and the decode cache, over two train epochs and the
   valid and test splits; the cache serves the second epoch without a
   decode and shares the JAX cache's keys.
3. The prefetcher's contract (a loader error re-raises on the consumer, an
   early exit stops the worker) and the process slice from
   ``torch.distributed``.
4. Both CheXpert experiments' ``build_data`` read the tree.
"""

import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from _torch_parity import (
    CHEXPERT_COLUMNS,
    _write_csv,
    assert_same_batches,
    write_chexpert_tree,
)
from diffusion_classifier_tpu.data import chexpert as jax_chexpert
from diffusion_classifier_tpu.data.decode_cache import DecodeCache as JaxDecodeCache
from diffusion_classifier_tpu.data.isic import ISICDataset as JaxISICDataset
from diffusion_classifier_tpu.data.mimic import MimicOodDataset as JaxMimicDataset
from diffusion_classifier_tpu.data.padchest import PadChestDataset as JaxPadChestDataset
from diffusion_classifier_tpu_torch.data import chexpert, loader
from diffusion_classifier_tpu_torch.data.decode_cache import DecodeCache
from diffusion_classifier_tpu_torch.data.isic import ISICDataset
from diffusion_classifier_tpu_torch.data.mimic import MimicOodDataset
from diffusion_classifier_tpu_torch.data.padchest import PadChestDataset
from diffusion_classifier_tpu_torch.experiments import chexpert_dit, chexpert_unet
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)

# --- 1. CSV readers ---------------------------------------------------------------

LABEL = st.sampled_from(["", "0", "1", "-1", "0.0", "1.0", "-1.0", "NaN"])
PATH = st.sampled_from(["study1/view1_frontal.jpg", "study1/view2_lateral.jpg", "study2/view1_frontal.jpg"])
SPLITS = ("train", "valid", "test")


def _chexpert_csv(folder, rows):
    cells = []
    for i, (path, effusion, no_finding) in enumerate(rows):
        values = dict.fromkeys(CHEXPERT_COLUMNS, "")
        values.update({"Path": f"CheXpert-v1.0-small/train/patient{i:05d}/{path}",
                       "Pleural Effusion": effusion, "No Finding": no_finding})
        cells.append([values[c] for c in CHEXPERT_COLUMNS])
    _write_csv(os.path.join(folder, "train.csv"), CHEXPERT_COLUMNS, cells)
    return [(chexpert.CheXpertDataset(folder, s), jax_chexpert.CheXpertDataset(folder, s)) for s in SPLITS]


def _mimic_csv(folder, rows):
    cells = [(f"mimic/files/p{i}/{path}", effusion) for i, (path, effusion, _) in enumerate(rows)]
    _write_csv(os.path.join(folder, "mimic_pa_metadata.csv"), ["image_path", "Pleural Effusion"], cells)
    return [(MimicOodDataset(folder), JaxMimicDataset(folder))]


def _padchest_csv(folder, rows):
    cells = [(f"im{i}.png", effusion) for i, (_, effusion, _) in enumerate(rows)]
    _write_csv(os.path.join(folder, "padchest-v1.csv"), ["ImageID", "PleuralEffusion"], cells)
    return [(PadChestDataset(folder), JaxPadChestDataset(folder))]


def _isic_csv(folder, rows):
    # ISIC's CSV is pre-balanced: every target is 0 or 1
    cells = [(f"ISIC_{i:07d}", int(effusion in ("1", "1.0"))) for i, (_, effusion, _) in enumerate(rows)]
    _write_csv(os.path.join(folder, "train_balanced.csv"), ["image_name", "target"], cells)
    return [(ISICDataset(folder, s), JaxISICDataset(folder, s)) for s in SPLITS]


READERS = {"chexpert": _chexpert_csv, "mimic": _mimic_csv, "padchest": _padchest_csv, "isic": _isic_csv}


@pytest.mark.parametrize("reader", list(READERS))
@settings(max_examples=12, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(rows=st.lists(st.tuples(PATH, LABEL, LABEL), min_size=0, max_size=40))
def test_csv_readers_match_pandas(reader, rows):
    with tempfile.TemporaryDirectory() as folder:
        for port, ref in READERS[reader](folder, rows):
            got = getattr(port, "names", getattr(port, "paths", None))
            want = getattr(ref, "names", getattr(ref, "paths", None))
            assert got == want
            assert port.labels.tolist() == ref.labels.tolist()


def test_csv_reader_keeps_pandas_sampling_and_split_on_a_tree(tmp_path):
    root = write_chexpert_tree(tmp_path / "chexpert")
    paths, labels = chexpert.load_chexpert_rows(os.path.join(root, "train.csv"))
    frame = jax_chexpert._load_frame(os.path.join(root, "train.csv"))
    assert paths == frame["Path"].tolist()
    assert labels.tolist() == frame["Pleural Effusion"].astype(int).tolist()
    # 12 of each label survive the filter and the balancing
    assert len(paths) == 24 and labels.sum() == 12
    lengths = [len(chexpert.CheXpertDataset(root, s)) for s in SPLITS]
    assert lengths == [19, 2, 2]  # int(24 * 0.8); int(24 * 0.2) // 2 twice


# --- 2. loader batches ------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 40 rows after the filter (32 train, 4 valid, 4 test); 64 x 80 sources,
    # which fast_decode drafts at 1/4 scale for 16 px
    return write_chexpert_tree(tmp_path_factory.mktemp("chexpert"), n_each=20, size=(64, 80))


def _loaders(root, workers, fast, cache_dir):
    """The port's and the JAX loader, each with a cache directory of its own when ``cache_dir``."""
    kw = dict(batch_size=4, num_workers=workers, image_size=16, seed=3, fast_decode=fast)
    return (chexpert.CheXpertDataLoader(True, root, decode_cache_dir=cache_dir, **kw),
            jax_chexpert.CheXpertDataLoader(
                True, root, decode_cache_dir=cache_dir and cache_dir + "-jax", **kw))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("mode", ["decode", "fast", "cache", "fast+cache"])
def test_loader_batches_match_jax(tree, tmp_path, monkeypatch, workers, mode):
    decodes = []
    real = loader.decode_image
    monkeypatch.setattr(loader, "decode_image", lambda *a, **k: decodes.append(a[0]) or real(*a, **k))
    cache_dir = str(tmp_path / "cache") if "cache" in mode else None
    port, ref = _loaders(tree, workers, "fast" in mode, cache_dir)
    for epoch in range(2):  # the shuffle advances every epoch
        decodes.clear()
        assert_same_batches(port.get_train_loader(), ref.get_train_loader())
        # the cache serves the second epoch: no decode
        want = 32 if (epoch == 0 or cache_dir is None) else 0
        assert len(decodes) == want
    for get in ("get_val_loader", "get_test_loader"):
        assert_same_batches(getattr(port, get)(), getattr(ref, get)())
    batch = next(iter(port.get_train_loader()))
    assert batch["images"].shape == (4, 16, 16, 3) and batch["prompt"].dtype == np.int32
    assert batch["images"].min() >= -1.0 and batch["images"].max() <= 1.0
    if cache_dir is not None:
        path = port.train_dataset.file_path(0)
        got = DecodeCache(cache_dir, 16, fast="fast" in mode)._entry_path(path)
        assert got == JaxDecodeCache(cache_dir, 16, fast="fast" in mode)._entry_path(path)
        assert os.path.isfile(got)


def test_batches_do_not_depend_on_the_worker_count(tree):
    serial, _ = _loaders(tree, 0, False, None)
    pooled, _ = _loaders(tree, 4, False, None)
    assert_same_batches(pooled.get_train_loader(), serial.get_train_loader())


def test_cf_label_replaces_every_label(tree):
    data = chexpert.CheXpertDataLoader(True, tree, cf_label=1, batch_size=4, num_workers=0, image_size=16)
    assert all((b["prompt"] == 1).all() for b in data.get_train_loader())
    mistakes = data.test_dataset.mistake_paths(np.zeros(2, np.int64))
    want = [os.path.join(*p.split("/")[1:]) for p, y in zip(data.test_dataset.paths, data.test_dataset.labels) if y]
    assert mistakes == want


# --- 3. prefetcher and process slice ----------------------------------------------


class _Batches:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.made = n, fail_at, 0

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise OSError(f"cannot decode batch {i}")
            self.made += 1
            yield {"i": i}


def test_prefetcher_reraises_a_loader_error_on_the_consumer():
    got = []
    with pytest.raises(OSError, match="cannot decode batch 2"):
        for batch in loader.Prefetcher(_Batches(5, fail_at=2)):
            got.append(batch["i"])
    assert got == [0, 1]


def test_prefetcher_stops_its_thread_when_the_consumer_leaves():
    before = threading.active_count()
    source = _Batches(1000)
    for i, _ in enumerate(loader.Prefetcher(source, depth=2)):
        if i == 1:
            break
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert source.made <= 2 + 2 + 1  # consumed, queued, one in the worker's hand


def test_process_slice_reads_torch_distributed(monkeypatch):
    assert loader._process_slice(8) == slice(0, 8)
    assert loader._process_slice(8, 1, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="both"):
        loader._process_slice(8, 1, None)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert loader._process_slice(8) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        loader._process_slice(5)


# --- 4. the experiments read the tree ---------------------------------------------


@pytest.mark.parametrize("experiment", [chexpert_dit, chexpert_unet])
def test_build_data_reads_a_chexpert_tree(tree, experiment):
    config = ExperimentConfig(data_path=tree, image_size=16, classes=2, batch_size=4,
                              num_workers=0, wavelet_transform=True, encoder_type="nn")
    data = experiment.build_data(config)
    assert isinstance(data, chexpert.CheXpertDataLoader)
    assert len(data.get_train_loader()) == 32 // 4
    assert next(iter(data.get_train_loader()))["images"].shape == (4, 16, 16, 3)
