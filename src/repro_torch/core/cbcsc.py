"""Column-Balanced Compressed Sparse Column (CBCSC) — Alg. 3 / Fig. 3;
port of ``repro/core/cbcsc.py``.

Encodes a CBTD-pruned matrix ``W [H, Q]`` into:
  * ``val  [Q, M, BLEN]`` — nonzero values, PE-aligned (PE i owns rows
    ``r % M == i``; local index ``k = r // M``),
  * ``lidx [Q, M, BLEN]`` — local index k of each value inside its
    subcolumn (0 <= k < S, S = H/M),
  * ``blen`` — nonzeros per subcolumn: ``ceil(H/M * (1-gamma))``.

Both sorts here are stable, as ``jnp.argsort`` is: the clip keeps the
same survivors and the arrays come out bit-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class CBCSC:
    val: torch.Tensor    # [Q, M, BLEN]
    lidx: torch.Tensor   # [Q, M, BLEN] int32 (int8 in the quantized pack)
    valid: torch.Tensor  # [Q, M, BLEN] bool (False = padding)
    h: int               # original column height
    m: int               # number of PEs
    blen: int            # burst length

    @property
    def q(self) -> int:
        return self.val.shape[0]

    @property
    def s(self) -> int:
        """Subcolumn length H/M."""
        return self.h // self.m

    def to(self, device) -> "CBCSC":
        return dataclasses.replace(self, val=self.val.to(device),
                                   lidx=self.lidx.to(device),
                                   valid=self.valid.to(device))


def blen_for(h: int, m: int, gamma: float) -> int:
    """Alg. 3: BLEN = ceil(H/M * (1 - gamma))."""
    return math.ceil((h // m) * (1.0 - gamma))


def cbcsc_encode(w: torch.Tensor, m: int, blen: int | None = None,
                 on_overflow: str = "raise") -> CBCSC:
    """Encode a (column-balanced) sparse matrix.  A subcolumn holding more
    than ``blen`` nonzeros is rejected (``"raise"``) or clipped to its
    ``blen`` largest magnitudes (``"clip"``).  ``blen=None`` uses the max
    subcolumn occupancy (always lossless)."""
    if on_overflow not in ("raise", "clip"):
        raise ValueError(f"on_overflow must be 'raise' or 'clip', got "
                         f"{on_overflow!r}")
    h, q = w.shape
    if h % m:
        raise ValueError(f"H={h} not divisible by M={m}")
    s = h // m
    sub = w.reshape(s, m, q).permute(2, 1, 0)          # [Q, M, S]
    nz = sub != 0
    max_occ = int(nz.sum(dim=-1).max())
    if blen is None:
        blen = max(max_occ, 1)
    elif max_occ > blen:
        if on_overflow == "raise":
            raise ValueError(
                f"subcolumn occupancy {max_occ} exceeds BLEN={blen}; "
                "matrix is not column-balanced to the promised sparsity")
        # keep the blen largest |w| per subcolumn (ties toward lower k)
        mag = torch.where(nz, sub.abs(), torch.full_like(sub, -math.inf))
        top = torch.argsort(-mag, dim=-1, stable=True)[..., :blen]
        keep = torch.zeros_like(nz).scatter_(-1, top, True)
        nz = nz & keep
        sub = sub * keep.to(sub.dtype)
    # stable sort brings nonzero positions first, preserving k order:
    order = torch.argsort((~nz).to(torch.uint8), dim=-1,
                          stable=True)[..., :blen]
    val = torch.gather(sub, -1, order)
    valid = torch.gather(nz, -1, order)
    val = val * valid.to(val.dtype)
    lidx = torch.where(valid, order, torch.zeros_like(order)).to(torch.int32)
    return CBCSC(val=val.contiguous(), lidx=lidx.contiguous(),
                 valid=valid.contiguous(), h=h, m=m, blen=blen)


def cbcsc_decode(enc: CBCSC, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Exact inverse of cbcsc_encode (up to the original zeros)."""
    dtype = dtype or enc.val.dtype
    q, m, blen = enc.val.shape
    vals = enc.val.to(dtype) * enc.valid.to(dtype)
    sub = torch.zeros((q, m, enc.s), dtype=dtype, device=enc.val.device)
    # padding entries carry lidx 0 and value 0: adding 0 is exact
    sub.scatter_add_(-1, enc.lidx.long(), vals)
    return sub.permute(2, 1, 0).reshape(enc.h, q)
