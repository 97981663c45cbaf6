"""Sample plotters for ``plot_function`` — the port's copy of ``utils/plotters.py``.

``cifar_plotter`` writes the first sample as a PNG; ``make_chexpert_plotter``
writes one figure per batch, reassembling the image from its Haar
coefficients (the port's :func:`~..ops.wavelet.haar_idwt2`) when the
config's ``wavelet_transform`` is on; ``make_ipmsa_plotter`` draws the centre
FLAIR slice of the first two samples a batch with the CT2F lesion slab over
it in green. Both take NHWC samples in [-1, 1]
(tensors or arrays) and return the last path written. matplotlib is
imported inside the plotters only, so nothing else depends on it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.wavelet import haar_idwt2

__all__ = ["cifar_plotter", "make_chexpert_plotter", "make_ipmsa_plotter"]


def _to_unit(img: np.ndarray) -> np.ndarray:
    return np.clip((img + 1.0) / 2.0, 0.0, 1.0)


def cifar_plotter(output_dir, batches, samples, epoch, process_idx):
    """Save the first generated sample as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    image = _to_unit(np.asarray(samples[0][0], np.float32))
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    os.makedirs(output_dir, exist_ok=True)
    image_path = os.path.join(output_dir, f"sample_{epoch}_{process_idx}.png")
    plt.imsave(image_path, image)
    return image_path


def make_chexpert_plotter(config):
    """Per-batch dump of the first sample, with the inverse DWT when ``wavelet_transform`` is on."""

    def plotter(output_dir, batches, samples, epoch, process_idx):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        image_path = None
        for batch, sample in zip(batches, samples):
            prompts = np.asarray(batch["prompt"])
            item = torch.as_tensor(np.asarray(sample[0], np.float32))
            if config.wavelet_transform:
                item = haar_idwt2(item * 2.0)
            img = _to_unit(item.numpy())
            activity = "active" if prompts[0] else "inactive"
            fig, axs = plt.subplots(1, 1, figsize=(5, 5))
            axs.imshow(img if img.shape[-1] != 1 else img[..., 0], cmap="gray")
            axs.axis("off")
            fig.suptitle(f"Patient status: {activity}", fontsize=16)
            plt.tight_layout()
            patient_path = os.path.join(output_dir, activity)
            os.makedirs(patient_path, exist_ok=True)
            image_path = os.path.join(
                patient_path, f"epoch_{epoch}_sample_0_process_{process_idx}.png"
            )
            plt.savefig(image_path, dpi=150)
            plt.close(fig)
        return image_path

    return plotter


def make_ipmsa_plotter(config):
    """Centre-slice FLAIR with a thresholded green CT2F lesion overlay, two samples a batch.

    Samples are ``[B, H, W, 2·slices]``, the FLAIR slab then the CT2F slab,
    channel-last (``data/ipmsa.py::make_default_transform``); the centre
    slice of each slab is drawn, the overlay shown where the lesion map
    exceeds 0.15. With ``wavelet_transform`` the sample is reassembled from
    its Haar coefficients first.
    """
    alpha_threshold = 0.15

    def plotter(output_dir, batches, samples, epoch, process_idx):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.colors as mcolors
        import matplotlib.pyplot as plt

        green_cmap = mcolors.LinearSegmentedColormap.from_list("green_cmap", ["white", "green"])
        image_path = None
        for batch, sample in zip(batches, samples):
            prompts = np.asarray(batch["prompt"])
            for j in range(min(2, len(prompts))):
                item = torch.as_tensor(np.asarray(sample[j], np.float32))
                if config.wavelet_transform:
                    item = haar_idwt2(item * 2.0)
                item = item.numpy()
                slices = max(1, item.shape[-1] // 2)
                offset = slices // 2
                flair_pred = item[..., offset]
                ct2f_pred = _to_unit(item[..., min(offset + slices, item.shape[-1] - 1)])
                activity = "active" if prompts[j] else "inactive"
                fig, axs = plt.subplots(1, 1, figsize=(5, 5))
                alpha = (ct2f_pred > alpha_threshold).astype(np.float32)
                axs.imshow(flair_pred, cmap="gray")
                axs.imshow(ct2f_pred, cmap=green_cmap, alpha=alpha)
                axs.axis("off")
                fig.suptitle(f"Patient status: {activity}", fontsize=16)
                plt.tight_layout()
                patient_path = os.path.join(output_dir, activity)
                os.makedirs(patient_path, exist_ok=True)
                image_path = os.path.join(
                    patient_path, f"epoch_{epoch}_sample_{j}_process_{process_idx}.png"
                )
                plt.savefig(image_path, dpi=150)
                plt.close(fig)
        return image_path

    return plotter
