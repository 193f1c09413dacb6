"""mmidet_tpu_torch: the PyTorch/CUDA port of mmidet_tpu for NVIDIA Hopper.

The JAX package ``mmidet_tpu`` is the reference this package is held
against; nothing here imports it or JAX.  Modules mirror its layout
(``nn/``, ``models/``, ``ops/``, ``data/``, ``deploy/``); the hand-written
CUDA kernels live in ``csrc/`` and are built at first use
(``kernels.py``).
"""
