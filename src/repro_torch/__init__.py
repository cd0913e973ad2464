"""PyTorch/CUDA port of the accelerator path of ``repro`` (the JAX package).

Same sub-package layout as ``repro`` (``repro.models.layers`` corresponds to
``repro_torch.models.layers``).  Imports ``torch`` only: nothing of JAX and
nothing of ``repro``.  Run with ``PYTHONPATH=src``.
"""
