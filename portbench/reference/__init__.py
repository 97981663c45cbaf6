"""The plain reference: fp32 PyTorch, functional, importing nothing of the program.

``dit`` and ``unet`` are the two denoisers, ``diffusion`` the arithmetic
around them, ``precision`` the fp32 products (TF32 off) and the fp8 control.
A configuration file names its denoiser under ``"reference"``.
"""
