"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

The tests hand the same numpy inputs to a JAX function and its port, with
the same weights (the flax tree converted by the port's weight bridge) and
the same random draws (made by JAX, replayed through :class:`JaxDraws` for
classification and :class:`JaxTrainDraws` for the train step).
"""

import jax
import numpy as np
import torch


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
