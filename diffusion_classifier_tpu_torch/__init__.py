"""diffusion_classifier_tpu_torch — the PyTorch/CUDA port of diffusion_classifier_tpu.

The JAX package beside it stays the reference: every module here is the
counterpart of one JAX module, held to it by the parity tests in
``tests/test_torch_*.py``. Ported so far: ELBO classification, CFG sampling
and training with the DiT backbone (``experiments/chexpert-dit``), and ELBO
classification and CFG sampling with the CIFAR-10 UNet, its condition-free
prefix shared across classes and across the CFG pair
(``experiments/cifar10``). Attention runs through hand-written CUDA
flash-attention kernels, forward and backward (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``).

Public functions keep the JAX package's layouts at their boundary (NHWC
images, ``[B, S, H, D]`` attention) so the parity tests compare like with
like. This package never imports ``jax``, nor anything of the JAX package.
"""

__version__ = "0.1.0"
