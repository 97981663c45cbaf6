"""The port's architecture presets against the JAX package's.

For every preset, the port's module, built on the ``meta`` device (no
memory for the 1024-wide presets), has exactly the parameter names and
shapes that the weight bridge maps from the JAX preset's parameter tree
(``jax.eval_shape``: nothing is initialised). The presets cover 5- and
6-level UNets and per-level ``layers_per_block`` tuples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_classifier_tpu.models.presets import DIT_PRESETS as JAX_DIT_PRESETS
from diffusion_classifier_tpu.models.presets import UNET_PRESETS as JAX_UNET_PRESETS
from diffusion_classifier_tpu.models.presets import build_preset as jax_build_preset
from diffusion_classifier_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from diffusion_classifier_tpu_torch.models.presets import DIT_PRESETS, UNET_PRESETS, build_preset
from diffusion_classifier_tpu_torch.utils import convert
from diffusion_classifier_tpu_torch.utils.config import ExperimentConfig

CONFIG = dict(image_size=64, image_channels=3, classes=2, patch_size=2, mixed_precision="bf16")


def _jax_tree_shapes(name):
    net = jax_build_preset(name, JaxExperimentConfig(**CONFIG))
    cfg = net.config
    x = jax.ShapeDtypeStruct((1, cfg.sample_size, cfg.sample_size, cfg.in_channels), jnp.float32)
    lg = jax.ShapeDtypeStruct((1,), jnp.float32)
    if name in JAX_DIT_PRESETS:
        cond = jax.ShapeDtypeStruct((1,), jnp.int32)
    else:  # one context token: the class embedder's
        cond = jax.ShapeDtypeStruct((1, 1, cfg.encoder_hid_dim), jnp.float32)
    return jax.eval_shape(net.init, jax.random.PRNGKey(0), x, lg, cond)


#: the port's presets the JAX package has none of (tests/test_torch_dit_xl.py holds them)
PORT_ONLY = {"dit-xl-2"}


def test_port_has_the_jax_presets():
    assert sorted(UNET_PRESETS) == sorted(JAX_UNET_PRESETS)
    assert sorted(set(DIT_PRESETS) - PORT_ONLY) == sorted(JAX_DIT_PRESETS)


@pytest.mark.parametrize("name", sorted(UNET_PRESETS) + sorted(set(DIT_PRESETS) - PORT_ONLY))
def test_preset_has_the_bridged_jax_tree(name):
    shapes = _jax_tree_shapes(name)
    with torch.device("meta"):
        port = build_preset(name, ExperimentConfig(**CONFIG))
    assert port.dtype == torch.bfloat16  # the compute dtype; parameters stay float32
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {v.dtype for v in port.state_dict().values()} == {torch.float32}
    got = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = tuple(str(p.key) for p in path)
        torch_name = convert._torch_name(keys)
        zeros = np.broadcast_to(np.float32(0), leaf.shape)  # no memory
        ndim = len(want.get(torch_name, ()))
        got[torch_name] = tuple(convert._convert_leaf(keys[-1], zeros, ndim).shape)
    assert got == want


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        build_preset("resnet-9000", ExperimentConfig())
