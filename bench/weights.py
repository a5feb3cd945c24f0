"""CBTD's column-balanced magnitude prune (Alg. 1 of the Spartus paper at
alpha = 1), the benchmark's own copy, shared by the model families'
seeded weights (``bench/families/``)."""
from __future__ import annotations

import torch


def cbtd_keep_mask(w: torch.Tensor, gamma: float, m: int) -> torch.Tensor:
    """Keep mask of ``w [R, Q]``: per subcolumn (rows r with r % m = pe)
    the ``S - floor(S gamma)`` largest |w|, ties to the lower row."""
    r, q = w.shape
    if r % m:
        raise ValueError(f"{r} rows do not split into {m} PEs")
    s = r // m
    sub = w.abs().reshape(s, m, q).permute(1, 0, 2)           # [M, S, Q]
    order = torch.argsort(sub, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)           # 0 = smallest
    keep = rank >= int(s * gamma)
    return keep.permute(1, 0, 2).reshape(r, q)
