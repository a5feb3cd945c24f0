"""PyTorch/CUDA port of the Spartus reproduction (``src/repro`` is the
JAX/Pallas reference it is checked against).

The package mirrors the reference layout file for file: ``repro/X/Y.py``
has its port at ``repro_torch/X/Y.py``.  It imports ``torch``, ``numpy``
and the standard library only — never ``jax`` and never ``repro``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA on a machine without a card raises
instead of falling back.  On a CUDA tensor the hot-path ops launch the
hand-written kernels in ``kernels/csrc/``; on a CPU tensor they run the
kernels' plain PyTorch versions.
"""
