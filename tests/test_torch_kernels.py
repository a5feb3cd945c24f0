"""Port parity, kernels: the plain PyTorch versions behind every CUDA
kernel against the JAX package's Pallas kernels (run in interpret mode, as
tests/test_kernels.py runs them) and against its XLA ops.

Tolerances: 1e-6 for the elementwise kernels, 1e-5 for the SpMV against
the Pallas kernels (another fp32 summation order), exact for fired counts,
NZI lists (tie order included), the pool's frame/logit bookkeeping and the
plain scatter against the list-order sum the CUDA SpMV keeps.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apply_cbtd, blen_for, cbcsc_decode, cbcsc_encode
from repro.kernels import ops as jops
from repro.kernels.delta_encode import delta_encode_pallas
from repro.kernels.lstm_pointwise import lstm_pointwise_pallas
from repro.kernels.stsp_spmv import (
    stsp_spmv_pallas,
    stsp_spmv_scatter_batch_pallas,
)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import delta_encode as tde
from repro_torch.kernels import lstm_pointwise as tlp
from repro_torch.kernels import stsp_spmv as tsp

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- delta_encode ----------------------------------------------------------------


@pytest.mark.parametrize("f", [1024, 2048])
@pytest.mark.parametrize("theta", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("act_bits", [None, 16])
def test_delta_encode_plain_vs_pallas(f, theta, act_bits):
    rng = np.random.default_rng(f + int(theta * 10))
    x = rng.standard_normal(f).astype(np.float32)
    xh = (x + rng.standard_normal(f) * 0.2).astype(np.float32)
    d, xo, nnz = delta_encode_pallas(jnp.asarray(x), jnp.asarray(xh), theta,
                                     interpret=True, act_bits=act_bits)
    td, txo, tnnz = tde.delta_encode(_t(x)[None], _t(xh)[None], theta,
                                     act_bits)
    np.testing.assert_allclose(np.asarray(d), td[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(xo), txo[0].numpy(), atol=1e-6)
    assert int(jnp.sum(nnz)) == int(tnnz[0])


@pytest.mark.parametrize("act_bits", [None, 16])
def test_delta_encode_batch_ragged_vs_reference_ops(act_bits):
    """[B, F] with F=1147 (no padding contract) == the reference's vmapped
    Pallas wrapper, exactly."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 1147)).astype(np.float32)
    xh = (x + rng.standard_normal((5, 1147)) * 0.3).astype(np.float32)
    kw = {} if act_bits is None else {"act_bits": act_bits}
    jd, jx, jn = jops.delta_encode_batch(jnp.asarray(x), jnp.asarray(xh), 0.3,
                                         use_pallas=True, **kw)
    td, tx, tn = ops.delta_encode_batch(_t(x), _t(xh), 0.3, **kw)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    assert tn.dtype == torch.int32


# -- lstm_pointwise --------------------------------------------------------------


@pytest.mark.parametrize("h", [512, 1024])
@pytest.mark.parametrize("amp", [1.0, 6.0])
def test_lstm_pointwise_plain_vs_pallas(h, amp):
    rng = np.random.default_rng(h)
    dm = (rng.standard_normal((4, h)) * amp).astype(np.float32)
    c = rng.standard_normal(h).astype(np.float32)
    jh, jc = lstm_pointwise_pallas(jnp.asarray(dm), jnp.asarray(c),
                                   interpret=True)
    th, tc = tlp.lstm_pointwise(_t(dm)[None], _t(c)[None])
    np.testing.assert_allclose(np.asarray(jh), th[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc), tc[0].numpy(), atol=1e-6)


def test_lstm_pointwise_batch_vs_reference_ops():
    rng = np.random.default_rng(11)
    dm = rng.standard_normal((3, 4, 700)).astype(np.float32)
    c = rng.standard_normal((3, 700)).astype(np.float32)
    jh, jc = jops.lstm_pointwise_batch(jnp.asarray(dm), jnp.asarray(c),
                                       use_pallas=True)
    th, tc = ops.lstm_pointwise_batch(_t(dm), _t(c))
    np.testing.assert_allclose(np.asarray(jh), th.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), atol=1e-6)


# -- stsp_spmv -------------------------------------------------------------------


def _cbcsc_case(seed, h, q, m, gamma):
    w = apply_cbtd(jax.random.normal(jax.random.key(seed), (h, q)) + 0.01,
                   gamma, m, 1.0)
    return w, cbcsc_encode(w, m, blen=blen_for(h, m, gamma))


def _int8_payload(enc):
    """The quantized pack's storage: int8 codes, int8 lidx, pow2 scale."""
    scale = float(2.0 ** np.ceil(np.log2(np.abs(np.asarray(enc.val)).max()
                                         / 127)))
    val8 = np.round(np.asarray(enc.val) / scale).astype(np.int8)
    return val8, np.asarray(enc.lidx).astype(np.int8), scale


@pytest.mark.parametrize("case", ["random", "padding", "duplicates", "int8"])
def test_stsp_spmv_plain_vs_pallas(case):
    w, enc = _cbcsc_case(7, 128, 64, 16, 0.75)
    val, lidx = np.asarray(enc.val), np.asarray(enc.lidx)
    rng = np.random.default_rng(1)
    idx = rng.permutation(64)[:12].astype(np.int32)
    ds = rng.standard_normal(12).astype(np.float32)
    if case == "padding":
        idx[8:], ds[8:] = 0, 0.0                 # padded tail points at col 0
        ds[3] = 0.0                              # and one padded entry mid-list
    elif case == "duplicates":
        idx[5] = idx[2]
    elif case == "int8":
        val, lidx, _ = _int8_payload(enc)
    y = stsp_spmv_pallas(jnp.asarray(val), jnp.asarray(lidx), jnp.asarray(idx),
                         jnp.asarray(ds), s=enc.s, interpret=True)
    ty = tsp.stsp_spmv(_t(val), _t(lidx), _t(idx), _t(ds), s=enc.s)
    np.testing.assert_allclose(np.asarray(y), ty.numpy(), atol=1e-5)
    # the one-hot spec and the pool's scatter formulation agree
    np.testing.assert_allclose(
        ref.stsp_spmv_scatter_ref(_t(val), _t(lidx), _t(idx), _t(ds),
                                  enc.s).numpy(), ty.numpy(), atol=1e-5)


# (h, q, m, gamma, k, b): s = h/m in {4, 8, 16, 32}, blen in {1..16}
BATCH_SWEEP = [
    (32, 16, 8, 0.75, 4, 1),
    (64, 32, 8, 0.75, 8, 3),
    (128, 96, 16, 0.9, 16, 4),
    (256, 128, 16, 0.9375, 24, 5),
    (256, 128, 8, 0.5, 32, 2),
]


@pytest.mark.parametrize("h,q,m,gamma,k,b", BATCH_SWEEP)
@pytest.mark.parametrize("int8", [False, True])
def test_scatter_batch_plain_vs_pallas(h, q, m, gamma, k, b, int8):
    _, enc = _cbcsc_case(h + q + b, h, q, m, gamma)
    rng = np.random.default_rng(h + b)
    idx = np.stack([rng.permutation(q)[:k] for _ in range(b)]).astype(np.int32)
    ds = rng.standard_normal((b, k)).astype(np.float32)
    idx[:, -1], ds[:, -1] = 0, 0.0               # a padded entry per slot
    if k > 2:
        idx[0, 1] = idx[0, 0]                    # a duplicate column
    val, lidx = np.asarray(enc.val), np.asarray(enc.lidx)
    if int8:
        val, lidx, _ = _int8_payload(enc)
    y = stsp_spmv_scatter_batch_pallas(jnp.asarray(val), jnp.asarray(lidx),
                                       jnp.asarray(idx), jnp.asarray(ds),
                                       s=enc.s, interpret=True)
    ty = tsp.stsp_spmv_scatter_batch(_t(val), _t(lidx), _t(idx), _t(ds),
                                     s=enc.s)
    np.testing.assert_allclose(np.asarray(y), ty.numpy(), atol=1e-5)


@pytest.mark.parametrize("scale", [None, 2.0 ** -6])
def test_stsp_spmv_batch_routes_vs_reference_ops(scale):
    """The public pool entry (the scatter route) with the epilogue scale,
    and the dense-gather route, against the reference's XLA path."""
    w, enc = _cbcsc_case(5, 64, 32, 8, 0.75)
    rng = np.random.default_rng(2)
    idx = np.stack([rng.permutation(32)[:8] for _ in range(3)]).astype(np.int32)
    ds = rng.standard_normal((3, 8)).astype(np.float32)
    sc = None if scale is None else np.float32(scale)
    jy = jops.stsp_spmv_batch(enc.val, enc.lidx, jnp.asarray(idx),
                              jnp.asarray(ds), s=enc.s,
                              scale=None if sc is None else jnp.asarray(sc))
    tsc = None if sc is None else _t(sc)
    ty = ops.stsp_spmv_batch(_t(enc.val), _t(enc.lidx), _t(idx), _t(ds),
                             s=enc.s, scale=tsc)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), atol=1e-5)
    w_dense = np.asarray(cbcsc_decode(enc, jnp.float32))
    jg = jops.delta_spmv_dense_gather_batch(jnp.asarray(w_dense),
                                            jnp.asarray(idx), jnp.asarray(ds))
    tg = ops.delta_spmv_dense_gather_batch(_t(w_dense), _t(idx), _t(ds))
    np.testing.assert_allclose(np.asarray(jg), tg.numpy(), atol=1e-5)


def _list_order_scatter(val, lidx, idx, ds, s):
    """The CUDA SpMV's order contract spelled out: every output row sums
    its terms over the list in order (k, then j), each product and each
    sum rounded to float32, skipping padding and out-of-range entries."""
    q, m, blen = val.shape
    y = np.zeros((idx.shape[0], s * m), np.float32)
    for b, k in np.ndindex(*idx.shape):
        d, col = np.float32(ds[b, k]), int(idx[b, k])
        if d == 0 or not 0 <= col < q:
            continue
        for pe, j in np.ndindex(m, blen):
            l = int(lidx[col, pe, j])
            if 0 <= l < s:
                term = np.float32(d * np.float32(val[col, pe, j]))
                y[b, l * m + pe] = np.float32(y[b, l * m + pe] + term)
    return y


@pytest.mark.parametrize("case", ["cancellation", "random", "random-int8"])
def test_scatter_batch_plain_sums_in_list_order(case):
    """The plain scatter (the card kernel's exact yardstick) adds each
    row's terms in list order, bit for bit."""
    if case == "cancellation":
        # row (l=1, pe=0) gets 1e8, then 1, then -1e8: in list order the 1
        # is lost to rounding (0); any other order keeps it (1)
        val = np.zeros((2, 2, 2), np.float32)
        lidx = np.zeros((2, 2, 2), np.int32)
        val[0, 0], lidx[0, 0] = [1e8, 1.0], [1, 1]
        val[1, 0], lidx[1, 0] = [-1e8, 0.5], [1, 0]
        val[:, 1] = [[3.0, -2.0], [0.25, 7.0]]
        idx, ds = np.array([[0, 1]], np.int32), np.ones((1, 2), np.float32)
        s = 2
    else:
        _, enc = _cbcsc_case(9, 128, 96, 16, 0.75)
        val, lidx = np.asarray(enc.val), np.asarray(enc.lidx)
        if case == "random-int8":
            val, lidx, _ = _int8_payload(enc)
        rng = np.random.default_rng(4)
        idx = np.stack([rng.permutation(96)[:20] for _ in range(3)])
        idx = idx.astype(np.int32)
        ds = rng.standard_normal((3, 20)).astype(np.float32)
        idx[:, -3:], ds[:, -3:] = 0, 0.0        # padded tail
        ds[1, 4] = 0.0                          # padding mid-list
        idx[0, 1] = idx[0, 0]                   # a duplicate column
        s = enc.s
    want = _list_order_scatter(val, lidx, idx, ds, s)
    got = ref.stsp_spmv_scatter_batch_ref(_t(val), _t(lidx), _t(idx), _t(ds),
                                          s).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "cancellation":
        assert got[0, 1 * 2 + 0] == 0.0


# -- CTRL and the dense-mirror route ---------------------------------------------


def _tied_delta(seed, b, f, frac=0.5):
    """Sparse deltas with many equal magnitudes (tie order matters)."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.array([-0.5, -0.25, 0.25, 0.5, 1.0], np.float32),
                      size=(b, f))
    return np.where(rng.random((b, f)) < frac, vals, 0.0).astype(np.float32)


@pytest.mark.parametrize("capacity", [4, 16, 40, 200])
def test_select_active_columns_bit_equal_with_ties(capacity):
    delta = _tied_delta(capacity, 6, 64)
    ji, jv, jd = jops.select_active_columns_batch(jnp.asarray(delta), capacity)
    ti, tv, td = ops.select_active_columns_batch(_t(delta), capacity)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert ti.dtype == torch.int32
    si, sv, sd = ops.select_active_columns(_t(delta[2]), capacity)
    np.testing.assert_array_equal(si.numpy(), ti[2].numpy())
    assert int(sd) == int(td[2])


@pytest.mark.parametrize("capacity", [6, 20, 64])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_topk_batch_vs_reference(capacity, int8):
    rng = np.random.default_rng(capacity)
    wt = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    scale = None
    if int8:
        scale = np.float32(2.0 ** -8)
        wt = np.clip(np.round(wt / scale), -127, 127).astype(np.int8)
    delta = _tied_delta(capacity + 1, 5, 64, frac=0.4)
    jy, jd = jops.delta_spmv_dense_topk_batch(
        jnp.asarray(wt), jnp.asarray(delta), capacity,
        scale=None if scale is None else jnp.asarray(scale))
    ty, td = ops.delta_spmv_dense_topk_batch(
        _t(wt), _t(delta), capacity, scale=None if scale is None else
        _t(scale))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    if capacity == 6:
        assert int(td.max()) > 0       # the clip really engaged


def _clip_case(name):
    """(delta [B, 64], capacity) of one clip case: rows at, under and over
    the capacity, ties across the keep boundary, zero and -0.0 rows, and
    capacities at and past Q."""
    q, k = 64, 16
    rng = np.random.default_rng(len(name))
    delta = np.zeros((4, q), np.float32)

    def fire(row, n, vals):
        cols = rng.permutation(q)[:n]
        delta[row, cols] = vals[:n]

    normal = (rng.standard_normal(2 * q) * 0.5).astype(np.float32)
    if name in ("under", "at", "over"):
        n = {"under": k - 1, "at": k, "over": k + 1}[name]
        for row in range(4):
            fire(row, n, rng.permutation(normal))
    elif name == "ties":
        # 10 magnitudes above the threshold, then 12 at it: 6 ties kept
        for row in range(4):
            vals = np.concatenate([1.0 + rng.random(10),
                                   np.full(12, 0.5)]).astype(np.float32)
            fire(row, 22, vals * rng.choice([-1.0, 1.0], 22))
    elif name == "zeros":
        # row 0 all zero; rows 1-3 hold -0.0 among k + 3 fired entries
        for row in range(1, 4):
            fire(row, k + 3, rng.permutation(normal))
            delta[row, delta[row] == 0] = -0.0
    else:                           # "k=Q", "k>Q": nothing to clip
        for row in range(4):
            fire(row, 40, rng.permutation(normal))
        return delta, q if name == "k=Q" else q + 5
    return delta, k


@pytest.mark.parametrize("name", ["under", "at", "over", "ties", "zeros",
                                  "k=Q", "k>Q"])
def test_capacity_clip_plain_vs_reference(name):
    """The clip's plain version (the kernel's CPU half) against the
    reference's dense route through an identity mirror, whose product is
    the clipped deltas themselves: the same kept set, ties toward the
    lower index, and the same n_dropped."""
    from repro_torch.kernels import capacity_clip as cc

    delta, capacity = _clip_case(name)
    q = delta.shape[1]
    jy, jd = jops.delta_spmv_dense_topk_batch(
        jnp.eye(q, dtype=jnp.float32), jnp.asarray(delta), capacity)
    before = cc.KERNEL.launches
    x = _t(delta)
    ds, nd = cc.capacity_clip(x, capacity)
    assert cc.KERNEL.launches == before
    np.testing.assert_array_equal(np.asarray(jy), ds.numpy())
    np.testing.assert_array_equal(np.asarray(jd), nd.numpy())
    assert nd.dtype == torch.int32
    fired = (delta != 0).sum(1)
    kept = (ds.numpy() != 0).sum(1)
    np.testing.assert_array_equal(kept, np.minimum(fired, capacity))
    if name == "over":
        assert (nd.numpy() == 1).all()
    if name == "ties":
        assert (np.abs(ds.numpy()) == 0.5).sum(1).tolist() == [6] * 4
    if capacity >= q:                     # delta itself, nothing dropped
        assert ds is x and (nd.numpy() == 0).all()


def test_dense_mirror_gemm_is_batch_invariant():
    """A session's SpMV result does not depend on how many rows share the
    product (the reason the mirror product is a kernel of its own that
    accumulates in float64)."""
    rng = np.random.default_rng(0)
    wt = _t((rng.standard_normal((300, 96)) * 0.3).astype(np.float32))
    delta = _t(_tied_delta(4, 16, 300, frac=0.6) * 3)
    y16, _ = ops.delta_spmv_dense_topk_batch(wt, delta, 300)
    for b in (1, 2, 5):
        yb, _ = ops.delta_spmv_dense_topk_batch(wt, delta[:b], 300)
        assert torch.equal(yb, y16[:b])


def test_spmv_route_heuristic_matches():
    for s, gamma in [(8, 0.9375), (16, 0.9375), (64, 0.9375), (32, 0.75),
                     (4, 0.5)]:
        assert (ops.spmv_use_dense_gather(s, gamma)
                == jops.spmv_use_dense_gather(s, gamma))


# -- pool bookkeeping ------------------------------------------------------------


def test_gather_bank_rows_bit_equal():
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((3, 8, 5)).astype(np.float32)
    cursor = np.array([0, 7, 12], np.int32)           # 12 clamps to 7
    np.testing.assert_array_equal(
        np.asarray(jops.gather_frames(jnp.asarray(frames),
                                      jnp.asarray(cursor))),
        ops.gather_frames(_t(frames), _t(cursor)).numpy())
    buf = rng.standard_normal((3, 10, 4)).astype(np.float32)
    rows = rng.standard_normal((3, 3, 4)).astype(np.float32)
    start = np.array([0, 4, 7], np.int32)
    jb = jops.bank_rows(jnp.asarray(buf), jnp.asarray(rows),
                        jnp.asarray(start))
    tb = ops.bank_rows(_t(buf), _t(rows), _t(start))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(
        np.asarray(jops.gather_rows(jb, jnp.asarray(start), 3)),
        ops.gather_rows(tb, _t(start), 3).numpy())


# -- wrappers and build ----------------------------------------------------------


def test_cpu_tensors_take_plain_versions_without_launching():
    counters = (tde.KERNEL, tlp.KERNEL, tsp.KERNEL, tsp.SCATTER_BATCH_KERNEL)
    before = [k.launches for k in counters]
    x = torch.randn(2, 16)
    tde.delta_encode(x, torch.zeros_like(x), 0.1)
    tlp.lstm_pointwise(torch.randn(2, 4, 8), torch.randn(2, 8))
    val, lidx = torch.randn(6, 2, 2), torch.zeros(6, 2, 2, dtype=torch.int32)
    idx, ds = torch.zeros(2, 3, dtype=torch.int32), torch.randn(2, 3)
    tsp.stsp_spmv_scatter_batch(val, lidx, idx, ds, s=4)
    tsp.stsp_spmv(val, lidx, idx[0], ds[0], s=4)
    assert [k.launches for k in counters] == before


def test_check_cuda_rejects_host_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("k", {}, x=torch.zeros(3))


def test_kernel_build_lands_under_ignored_build_dir():
    rel = _build.library_path().relative_to(REPO)
    assert rel.parts[:2] == ("build", "repro_torch")
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert all((_build.CSRC_DIR / s).is_file() for s in _build.SOURCES)
