"""Hand-written CUDA kernels for the Spartus compute hot-spots (port of
``repro/kernels``, whose Pallas TPU kernels they replace).

delta_encode    — DPE: thresholded delta + reference update (Fig. 6)
stsp_spmv       — MAC arrays: spatio-temporal sparse MxV over CBCSC (Fig. 2/9)
lstm_pointwise  — HPE: fused gate nonlinearities + cell update (Fig. 8)
dense_mirror    — the dense-mirror route's product, batch-invariant (the
                  port's own kernel, in place of an XLA dot)
capacity_clip   — the dense route's fired count and capacity clip (the
                  port's own kernel, in place of XLA's top_k under a cond)

The CUDA sources are in ``csrc/`` and are built at first use
(``_build.py``).  Each kernel module keeps its plain PyTorch version from
``ref.py`` beside the kernel and a launch count on its wrapper; ``ops.py``
holds the public wrappers the engines call.
"""
from repro_torch.kernels import ops, ref
