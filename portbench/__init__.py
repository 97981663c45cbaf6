"""The benchmark of the PyTorch/CUDA port (``diffusion_classifier_tpu_torch``) on one H100.

``run.py`` runs one cell once (``core.py``); cells, configurations, modes,
metrics, counts and the plain reference are files found by name here.
Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
