"""IPMSA (MS clinical-trial MRI) data — the port's copy of ``data/ipmsa.py``.

numpy only, as the JAX module. Pickle-index-driven volume loading with a
per-sample pickle cache, blocklist filtering, and the ``LORISTransforms``
preprocessing library:

- volumes are `.npy` / `.npy.lz4`; lz4 frames decode through the port's
  build of the repository's native decoder (:mod:`..utils.lz4io`);
- volume roots come from ``$TMPDIR`` (slurm) or ``$DATA_PATH``;
- every channel file is resolved at construction (a missing or ambiguous
  file fails there, not mid-epoch), and ``__getitem__`` only decodes;
- the per-sample pickle cache keeps the JAX module's name and format
  (``<cache_dir>/<sample key>.pkl``, the transformed item pickled): the
  parity tests show the port writes the same bytes for the same sample;
- ``remove_condition`` drops blocklisted (trial, patient) samples and
  re-pickles the index;
- ``LORISTransforms``: PadTimepoints, GetSlice (centre slab), Denoise
  (brain-mask multiply), BinarizeLabel, Resize (pad to a power of two with
  the volume's minimum), Normalize / NormalizeTensor (4-sigma clip and
  FLAIR-referenced min-max), BlurLabel2D / BlurLabel3D (Gaussian label
  smoothing; 3D through ``scipy.ndimage.convolve``), ToTensor.

Batches come from :class:`IPMSADataLoader` on the port's generic loader
(:func:`.loader.iter_item_batches` on a thread pool, a
:class:`.loader.Prefetcher` thread); they are the same for any worker
count, and the JAX loader's for the same seed. The per-item transform is
:func:`make_default_transform`, the experiments' pipeline.
"""

from __future__ import annotations

import os
import pickle
import threading
from glob import glob
from typing import Callable, Optional

import numpy as np

from ..utils.lz4io import load_npy_lz4
from .loader import Prefetcher, _process_slice, iter_item_batches

__all__ = [
    "MRIImageKeys",
    "ClinicalKeys",
    "load_image",
    "IPMSADataset",
    "IPMSADataLoader",
    "LORISTransforms",
    "inverse_trial_mapping",
    "make_default_transform",
    "trial_mapping",
]


class MRIImageKeys:
    FLAIR = "FLAIR"
    GAD = "GAD"
    CT2F = "CT2F"
    NEWT2 = "NEWT2"
    MASK = "MASK"
    CLINICAL = "CLINICAL"
    BRAIN_VOL = "BRAIN"


class ClinicalKeys:
    AGE = "AGE"
    EDSS = "EDSS"
    TRIAL_ARM = "TRIAL_ARM"
    SEX = "SEX"
    GAD_COUNT = "LESION_GAD_CONSENSUS_COUNT"
    T2_VOL = "LESION_T2_VOL"


_CLINICAL_VALUES = tuple(
    v for k, v in ClinicalKeys.__dict__.items() if not k.startswith("_")
)


trial_mapping = {
    "placebo": 0,
    "laquinimod": 0,
    "interferon beta-1a": 1,
    "dimethyl fumarate": 1,
    "ocrelizumab": 2,
}
inverse_trial_mapping = {0: "NE", 1: "ME", 2: "HE"}


def _leaf(mapping: dict, key_path) -> object:
    """Follow ``key_path`` through nested index dicts to a leaf value.

    A key genuinely absent from this sample raises ``KeyError`` (tolerated
    by :meth:`IPMSADataset._resolve_sample` as a missing channel). A
    MALFORMED template path — empty, or stopping at an inner node — raises
    ``ValueError`` so it fails loudly at init, mirroring the reference's
    plain ``Exception``s that its ``except KeyError`` never swallows
    (`dataset/ipmsa.py:34-43,122-123`).
    """
    if not key_path:
        raise ValueError("empty channel key path in item_template")
    node = mapping
    for k in key_path:
        node = node[k]
    if isinstance(node, dict):
        raise ValueError(
            f"channel key path {list(key_path)} lands on an inner node"
        )
    return node


def load_image(path: str) -> np.ndarray:
    """Decode one volume: plain ``.npy`` or lz4-framed ``.npy.lz4``."""
    if path.endswith(".npy.lz4"):
        return load_npy_lz4(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise ValueError(f"Unsupported volume format: {path!r} (.npy/.npy.lz4)")


def _match_one(prefix: str) -> str:
    """The single on-disk file whose name starts with ``prefix``.

    The index stores extension-less relative paths; the real file may carry
    ``.npy`` or ``.npy.lz4``, so resolution is a one-match glob.
    """
    matches = glob(f"{prefix}*")
    if len(matches) != 1:
        raise FileNotFoundError(
            f"expected exactly one file matching {prefix}*, "
            f"found {len(matches)}"
        )
    return matches[0]


def _trial_patient_ids(volume_path: str) -> dict:
    """(trial_id, patient_id) from ABSOLUTE path components 3 and 4.

    The blocklist format and the reference's id derivation both assume a
    ``/<a>/<b>/<trial>/<patient>/...`` volume layout.
    """
    parts = volume_path.split("/")
    return {"trial_id": parts[3], "patient_id": parts[4]}


class IPMSADataset:
    """Pickle-index dataset of multi-channel MRI volumes (reference `:67-243`).

    The index pickle holds ``dataset_dict`` (per-sample nested path dicts)
    and ``item_template`` (output channel → key paths into a sample's dict).
    All channel files are resolved to absolute paths ONCE at construction —
    resolution doubles as startup validation (a missing/ambiguous file fails
    fast here, not mid-epoch) — and ``__getitem__`` only decodes.
    """

    def __init__(
        self,
        index_path: str,
        slurm: bool = False,
        num_samples: Optional[int] = None,
        cache_dir: Optional[str] = None,
    ):
        self.index_path = index_path
        self.cache_dir = cache_dir

        with open(index_path, "rb") as f:
            index = pickle.load(f)
        self.dataset_dict = index["dataset_dict"]
        self.item_template = index["item_template"]

        # volume roots come from the environment: $TMPDIR on slurm nodes
        # (data staged to local scratch), $DATA_PATH otherwise
        root = os.environ["TMPDIR"] if slurm else os.environ["DATA_PATH"]
        if not os.path.isdir(root):
            raise NotADirectoryError(f"volume root {root!r} does not exist")
        self.rootdir_dict = {"MRI_AND_LABEL": root, "CLINICAL": root}

        self.sample_keys = list(self.dataset_dict)
        if num_samples is not None:
            self.sample_keys = self.sample_keys[:num_samples]

        self.transform: Optional[Callable] = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

        self._manifest = {
            key: self._resolve_sample(self.dataset_dict[key])
            for key in self.sample_keys
        }

    def _resolve_sample(self, entry: dict) -> dict:
        """One sample's ``item_key → [absolute file path, ...]`` manifest.

        Clinical channels resolve to raw values instead of paths. A key path
        absent from this sample's entry is tolerated (channel missing for
        this sample); a present-but-unmatchable file is an error.
        """
        resolved = {}
        for item_key, channel_key_paths in self.item_template.items():
            if item_key in _CLINICAL_VALUES:
                resolved[item_key] = [
                    _leaf(entry, kp) for kp in channel_key_paths
                ]
                continue
            paths = []
            for key_path in channel_key_paths:
                # leaf lookup FIRST (reference `:118-123` order): a missing
                # key skips the channel before the root is ever consulted,
                # and _leaf's malformed-template ValueErrors escape
                try:
                    rel = _leaf(entry, key_path)
                except KeyError:
                    continue
                root = self.rootdir_dict.get(key_path[0])
                if root is None:
                    raise KeyError(
                        f"item_template root {key_path[0]!r} has no "
                        f"configured directory (have {list(self.rootdir_dict)})"
                    )
                paths.append(_match_one(os.path.join(root, rel)))
            resolved[item_key] = paths
        return resolved

    def __len__(self):
        return len(self.sample_keys)

    def set_transform(self, transform: Callable):
        self.transform = transform

    def resolved_paths(self, idx: int) -> dict:
        """The resolved file manifest of sample ``idx``."""
        return self._manifest[self.sample_keys[idx]]

    def _cache_path(self, idx):
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{self.sample_keys[idx]}.pkl")

    def _decode(self, idx: int) -> dict:
        """Decode every channel of sample ``idx`` from its manifest."""
        manifest = self._manifest[self.sample_keys[idx]]
        return {
            item_key: (
                vals
                if item_key in _CLINICAL_VALUES
                else np.stack([load_image(p) for p in vals])
            )
            for item_key, vals in manifest.items()
        }

    def _sample_ids(self, idx: int) -> dict:
        manifest = self._manifest[self.sample_keys[idx]]
        first_channel = next(
            v for k, v in manifest.items() if k not in _CLINICAL_VALUES
        )
        return _trial_patient_ids(first_channel[0])

    def __getitem__(self, idx):
        cache_path = self._cache_path(idx)
        if cache_path and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                return pickle.load(f)

        output = self._decode(idx)
        if self.transform is None:
            return output

        preprocessed = self.transform(
            {"output": output, "idx": self._sample_ids(idx)}
        )
        if cache_path:
            # atomic publish: concurrent decode workers (num_workers > 0) or
            # peer ranks sharing cache_dir must never read a torn pickle
            tmp = f"{cache_path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(preprocessed, f)
            os.replace(tmp, cache_path)
        return preprocessed

    def remove_condition(self, block_list: str, name: str = "filtered"):
        """Drop blocklisted (trial, patient) samples and re-pickle (`:201-243`).

        Blocklist lines are ``<x>/<trial>/<patient>/...``; matching uses the
        manifest resolved at init (no volume re-scan).
        """
        with open(block_list) as f:
            blocked = set()
            for line in f:
                parts = line.strip().split("/")
                blocked.add((parts[1], parts[2]))

        keep, dropped = [], set()
        for idx, key in enumerate(self.sample_keys):
            ids = self._sample_ids(idx)
            if (ids["trial_id"], ids["patient_id"]) in blocked:
                print(f"Sample {idx} is inactive")
                dropped.add(key)
            else:
                keep.append(key)

        self.sample_keys = keep
        # Remove ONLY the blocked keys: when this dataset was built with a
        # num_samples subset, index entries outside the subset must survive
        # into the re-pickled file (the reference filters by inactive
        # position and likewise keeps unscanned entries, `:231-232`).
        self.dataset_dict = {
            k: v for k, v in self.dataset_dict.items() if k not in dropped
        }
        output_path = self.index_path.replace(".pkl", f"_{name}.pkl")
        with open(output_path, "wb") as f:
            pickle.dump(
                {
                    "rootdir_dict": self.rootdir_dict,
                    "dataset_dict": self.dataset_dict,
                    "item_template": self.item_template,
                    "sample_keys": self.sample_keys,
                },
                f,
            )


# ---------------------------------------------------------------------------
# LORISTransforms: numpy ports of the reference MRI preprocessing pipeline.


def _is_clinical(key: str) -> bool:
    return key in _CLINICAL_VALUES


class LORISTransforms:
    class PadTimepoints:
        """Zero-pad every volume's leading (timepoint) axis to the max (`:268-291`)."""

        def __call__(self, MRI_image):
            max_tp = max(
                MRI_image[k].shape[0]
                for k in MRI_image
                if not _is_clinical(k)
            )
            for k in MRI_image:
                if _is_clinical(k):
                    continue
                pad = max_tp - MRI_image[k].shape[0]
                MRI_image[k] = np.pad(
                    MRI_image[k],
                    ((pad, 0), (0, 0), (0, 0), (0, 0)),
                    mode="constant",
                    constant_values=0,
                )
            return MRI_image

    class GetSlice:
        """Center slab of `slices` axial slices from [t, D, H, W] (`:293-321`)."""

        def __init__(self, slices: int):
            assert slices % 2 != 0, "Number of slices must be odd!"
            self.slices = slices // 2

        def __call__(self, MRI_image):
            for k in MRI_image:
                if _is_clinical(k):
                    continue
                center = MRI_image[k].shape[1] // 2
                if self.slices == 0:
                    MRI_image[k] = np.expand_dims(
                        MRI_image[k][:, center, :, :], axis=-3
                    )
                else:
                    MRI_image[k] = MRI_image[k][
                        :, center - self.slices : center + self.slices + 1, :, :
                    ]
            return MRI_image

    class Denoise:
        """Multiply every channel by the BEAST brain mask (`:323-340`)."""

        def __call__(self, MRI_image):
            for k in MRI_image:
                if _is_clinical(k):
                    continue
                MRI_image[k] = MRI_image[k] * MRI_image[MRIImageKeys.MASK]
            return MRI_image

    class BinarizeLabel:
        """Binarize CT2F/NEWT2/GAD label volumes (`:342-357`)."""

        def __call__(self, MRI_image):
            for k in MRI_image:
                if k in (
                    MRIImageKeys.CT2F,
                    MRIImageKeys.NEWT2,
                    MRIImageKeys.GAD,
                ):
                    MRI_image[k] = (MRI_image[k] > 0).astype(np.float32)
            return MRI_image

    class Resize:
        """Pad [t, D, H, W] spatial dims to the next power of 2, mode='minimum' (`:359-381`)."""

        def __call__(self, MRI_image):
            for k in MRI_image:
                if _is_clinical(k):
                    continue
                w, h = MRI_image[k].shape[2], MRI_image[k].shape[3]
                next_p2 = 2 ** ((max(w, h) - 1).bit_length())
                pad_w, pad_h = next_p2 - w, next_p2 - h
                MRI_image[k] = np.pad(
                    MRI_image[k],
                    (
                        (0, 0),
                        (0, 0),
                        (pad_w // 2, pad_w // 2),
                        (pad_h // 2, pad_h // 2),
                    ),
                    mode="minimum",
                )
            return MRI_image

    class Normalize:
        """4σ clip + FLAIR-referenced min-max to [-1, 1] (`:383-425`).

        ``ddof`` selects the std estimator for the 4σ clip: the reference's
        numpy variant uses the population std (ddof=0, `:398`), while its
        torch ``NormalizeTensor`` — the variant the ipmsa experiments
        actually run (`experiments/ipmsa/train.py:127`) — uses torch's
        default UNBIASED std (ddof=1, `:447`). The two differ by a factor
        √(N/(N−1)) on the clip bounds.
        """

        def __init__(self, ddof: int = 0):
            self.ddof = ddof

        def __call__(self, MRI_image):
            for k in MRI_image:
                if _is_clinical(k):
                    continue
                MRI = MRI_image[k]
                if k == MRIImageKeys.FLAIR:
                    mean = np.mean(MRI, axis=(-2, -1), keepdims=True)
                    std = np.std(MRI, axis=(-2, -1), keepdims=True, ddof=self.ddof)
                    MRI = np.clip(MRI, mean - 4 * std, mean + 4 * std)
                    ref = MRI[0]
                    MRI = (MRI - ref.min()) / (ref.max() - ref.min() + 1e-12)
                    MRI = np.clip(MRI, 0, 1)
                MRI_image[k] = (MRI - 0.5) / 0.5
            return MRI_image

    class NormalizeTensor(Normalize):
        """The reference's torch variant (`:427-461`): unbiased std clip."""

        def __init__(self):
            super().__init__(ddof=1)

    class BlurLabel2D:
        """Blur NEWT2/CT2F with a 5×5 binomial × depth-gaussian kernel (`:464-541`).

        Input label volumes are [t, D, H, W]; the D axis is collapsed through
        the z-weighted kernel exactly as the reference's ``F.conv2d`` with a
        (1, depth, 5, 5) weight. Pads spatially with −1 first (`:536-540`).
        """

        def __init__(self, depth: int = 1):
            self.depth = depth

        def _kernel(self) -> np.ndarray:
            kxy = np.array(
                [
                    [1, 4, 6, 4, 1],
                    [4, 16, 24, 16, 4],
                    [6, 24, 36, 24, 6],
                    [4, 16, 24, 16, 4],
                    [1, 4, 6, 4, 1],
                ],
                np.float32,
            )
            kz = np.linspace(-(self.depth // 2), self.depth // 2, self.depth)
            kz = np.exp(-(kz**2) / 2.0)
            k3 = np.stack([kxy * s for s in kz], axis=0)
            return (k3 / k3.sum()).astype(np.float32)

        def _conv(self, vol: np.ndarray, k3: np.ndarray) -> np.ndarray:
            # vol [t, D, H, W] with D == depth; correlate and sum over D.
            t, d, h, w = vol.shape
            padded = np.pad(
                vol,
                ((0, 0), (0, 0), (2, 2), (2, 2)),
                mode="constant",
                constant_values=-1,
            )
            win = np.lib.stride_tricks.sliding_window_view(
                padded, (5, 5), axis=(2, 3)
            )  # [t, D, H, W, 5, 5]
            out = np.einsum("tdhwij,dij->thw", win, k3)
            return out[:, None, :, :].astype(np.float32)

        def __call__(self, MRI_image):
            k3 = self._kernel()
            for key in (MRIImageKeys.NEWT2, MRIImageKeys.CT2F):
                MRI_image[key] = self._conv(MRI_image[key], k3)
            return MRI_image

    class BlurLabel3D:
        """Blur NEWT2/CT2F with an isotropic 3D Gaussian (`:512-558`)."""

        def __init__(self, sigma: float = 1, kernel_size: int = 5):
            self.sigma = sigma
            self.kernel_size = kernel_size

        def _kernel(self) -> np.ndarray:
            r = (self.kernel_size - 1) // 2
            g = np.mgrid[-r : r + 1, -r : r + 1, -r : r + 1]
            sq = (g**2).sum(axis=0)
            k = np.exp(-sq / (2 * self.sigma**2))
            return (k / k.sum()).astype(np.float32)

        def __call__(self, MRI_image):
            from scipy.ndimage import convolve

            k = self._kernel()
            for key in (MRIImageKeys.NEWT2, MRIImageKeys.CT2F):
                vol = MRI_image[key]  # [t, D, H, W]
                out = np.stack(
                    [convolve(v, k, mode="constant", cval=0.0) for v in vol]
                )
                MRI_image[key] = out.astype(np.float32)
            return MRI_image

    class ToTensor:
        """Array materialization (numpy passthrough; reference `:560-576`)."""

        def __call__(self, MRI_image):
            for k in MRI_image:
                if _is_clinical(k):
                    continue
                MRI_image[k] = np.asarray(MRI_image[k])
            return MRI_image


class _IPMSABatcher:
    """Batch per-item transform outputs {'images', 'prompt', ...} dicts.

    ``batch_size`` is GLOBAL (loader.py contract): under multiple processes
    each decodes and yields only its contiguous per-rank slice of a batch.
    """

    def __init__(
        self, dataset, batch_size, shuffle, seed,
        num_workers=0, process_index=None, process_count=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self._rng = np.random.default_rng(seed)
        self._proc = (process_index, process_count)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        rows = _process_slice(self.batch_size, *self._proc)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        # decode only this process's slice of each global batch
        idx_batches = (
            order[i * self.batch_size : (i + 1) * self.batch_size][rows]
            for i in range(len(self))
        )
        for items in iter_item_batches(
            idx_batches, self.dataset.__getitem__, self.num_workers
        ):
            batch = {}
            for key in items[0]:
                vals = [it[key] for it in items]
                if isinstance(vals[0], np.ndarray):
                    batch[key] = np.stack(vals)
                else:
                    batch[key] = np.asarray(vals)
            yield batch


class IPMSADataLoader:
    """Train/val/test loaders over pickle indices (reference `:578-631`)."""

    def __init__(
        self,
        train_data_path: str,
        val_data_path: str,
        test_data_path: str,
        collate_fn: Callable,
        slurm: bool = False,
        batch_size: int = 64,
        num_workers: int = 4,
        cache_dir: Optional[str] = None,
        *,
        seed: int = 0,
    ):
        def make(path, shuffle):
            ds = IPMSADataset(path, slurm=slurm, cache_dir=cache_dir)
            ds.set_transform(collate_fn)
            return ds, Prefetcher(
                _IPMSABatcher(
                    ds, batch_size, shuffle, seed, num_workers=num_workers
                )
            )

        self.train_dataset, self.train_loader = make(train_data_path, True)
        self.val_dataset, self.val_loader = make(val_data_path, False)
        self.test_dataset, self.test_loader = make(test_data_path, False)

    def get_train_loader(self):
        return self.train_loader

    def get_val_loader(self):
        return self.val_loader

    def get_test_loader(self):
        return self.test_loader


def make_default_transform(
    slices: int,
    wavelet_transform: bool = False,
    cf_label: Optional[int] = None,
):
    """Per-item preprocessing + future-activity label derivation.

    The pipeline the three ipmsa experiments build inline
    (`experiments/ipmsa/train.py:119-165`): PadTimepoints → GetSlice →
    Denoise → BinarizeLabel → Resize → BlurLabel3D → Normalize; the input
    image packs the W000 FLAIR + CT2F slabs channel-last [H, W, 2·slices];
    the label is "any new-T2 lesions at W048/W096". ``cf_label`` forces the
    prompt for counterfactual explanation (`explain.py:173`).

    Note: the DWT is NOT applied here — the engine applies it on the device
    when ``wavelet_transform`` is set; the flag is accepted for parity.
    """
    del wavelet_transform
    T = LORISTransforms
    steps = [
        T.PadTimepoints(),
        T.GetSlice(slices=slices),
        T.Denoise(),
        T.BinarizeLabel(),
        T.Resize(),
        T.ToTensor(),
        T.BlurLabel3D(sigma=1, kernel_size=5),
        T.NormalizeTensor(),  # the experiments' variant: unbiased-std clip
    ]

    def transform(item):
        x = item["output"]
        for step in steps:
            x = step(x)

        # [t, D, H, W] → channel-last slabs, FLAIR ‖ CT2F at W000
        flair_w000 = np.transpose(x[MRIImageKeys.FLAIR][0], (1, 2, 0))
        ct2f_w000 = np.transpose(x[MRIImageKeys.CT2F][0], (1, 2, 0))
        images = np.concatenate([flair_w000, ct2f_w000], axis=-1).astype(
            np.float32
        )

        # Activity: any new-T2 lesions at W048 (index 1) or W096 (index 2)
        newt2_w048 = x[MRIImageKeys.NEWT2][1] / 2 + 0.5
        newt2_w096 = x[MRIImageKeys.NEWT2][2] / 2 + 0.5
        newt2 = np.clip(newt2_w048 + newt2_w096, 0, 1)
        active_label = bool(np.sum(newt2) > 0)

        prompt = int(cf_label) if cf_label is not None else int(active_label)
        return {"images": images, "prompt": np.int32(prompt)}

    return transform
