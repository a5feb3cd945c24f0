"""The port's CUDA kernels on the card, against their plain PyTorch
versions (1e-6 elementwise, exact fired counts; the fused layer-step
stages bit for bit, state written in place and inactive slots untouched;
the SpMV bit-identical to the host scatter, whose per-row sum order it
keeps), and the pool on the card against the same pool on the host.

Every test needs an NVIDIA GPU and nvcc (the kernels build at first use)
and skips elsewhere; whether a card exists is decided in a fixture, never
at import time.  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import apply_cbtd, blen_for, cbcsc_encode
from repro_torch.kernels import delta_encode as de
from repro_torch.kernels import dense_mirror as dm
from repro_torch.kernels import lstm_pointwise as lp
from repro_torch.kernels import ops
from repro_torch.kernels import stsp_spmv as sp
from repro_torch.models import lstm_am
from repro_torch.serving import BatchedSpartusEngine, EngineConfig
from repro_torch.serving import SpartusEngine, serve_requests

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _max_err(a, b):
    return float((a.cpu().double() - b.cpu().double()).abs().max())


@pytest.mark.parametrize("f,act_bits", [(1147, None), (2048, None),
                                        (2048, 16), (37, 16)])
def test_delta_encode_kernel_matches_plain(cuda, f, act_bits):
    x = torch.randn((16, f), generator=_gen(f))
    xh = x + 0.3 * torch.randn((16, f), generator=_gen(f + 1))
    before = de.KERNEL.launches
    got = de.delta_encode(x.to(cuda), xh.to(cuda), 0.3, act_bits)
    want = de.plain(x, xh, 0.3, act_bits)
    assert de.KERNEL.launches == before + 1
    assert torch.equal(got[2].cpu(), want[2])
    assert _max_err(got[0], want[0]) <= 1e-6
    assert _max_err(got[1], want[1]) <= 1e-6


@pytest.mark.parametrize("b,h", [(16, 1024), (3, 700)])
def test_lstm_pointwise_kernel_matches_plain(cuda, b, h):
    dm = torch.randn((b, 4, h), generator=_gen(h)) * 4
    c = torch.randn((b, h), generator=_gen(h + 1)) * 2
    before = lp.KERNEL.launches
    got = lp.lstm_pointwise(dm.to(cuda), c.to(cuda))
    want = lp.plain(dm, c)
    assert lp.KERNEL.launches == before + 1
    for a, w in zip(got, want):
        assert _max_err(a, w) <= 1e-6


def _bits(t):
    """Bit pattern, so NaN payloads and -0.0 compare exactly."""
    return t.contiguous().view(torch.int32).cpu()


def _poison(t):
    """A -0.0 and a NaN with a payload in every row of a state tensor."""
    t[:, 0] = -0.0
    t[:, -1] = torch.tensor(0x7FC01234, dtype=torch.int32).view(
        torch.float32)
    return t


def _on_card(t, cuda, offset):
    """t on the card; with ``offset`` one element past a 16-byte aligned
    base, so rows are unaligned whatever their length."""
    if not offset:
        return t.to(cuda)
    store = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
    store[1:] = t.flatten().to(cuda)
    return store[1:].view(t.shape)


def _mask(b, mode):
    if mode == "null":
        return None
    return torch.tensor([mode == "all" or i % 3 != 1 for i in range(b)])


# (b, d, h, act_bits): the 2x1024 model's layers 1 and 2 at the pool's
# and the batch-1 engine's B, D=0 (s = h alone), small odd widths
ENCODE_CASES = [(16, 1024, 1024, None), (16, 123, 1024, None),
                (16, 1024, 1024, 16), (1, 123, 1024, None),
                (1, 1024, 1024, 16), (3, 0, 128, None), (3, 37, 64, 16),
                (3, 123, 3000, None)]


@pytest.mark.parametrize("b,d,h,act_bits", ENCODE_CASES)
@pytest.mark.parametrize("mode", ["null", "all", "mixed"])
def test_delta_encode_step_kernel_equals_plain(cuda, b, d, h, act_bits,
                                               mode):
    gen = _gen(b + d + h)
    x = torch.randn((b, d), generator=gen)
    hid = torch.randn((b, h), generator=gen)
    s_hat = _poison(torch.cat([x, hid], -1)
                    + 0.3 * torch.randn((b, d + h), generator=gen))
    active = _mask(b, mode)
    want_state = s_hat.clone()
    want = de.plain_step(x, hid, want_state, 0.3, active, act_bits)
    state = _on_card(s_hat, cuda, offset=d % 2 == 1)
    before = de.KERNEL.launches
    got = de.delta_encode_step(
        _on_card(x, cuda, offset=d % 2 == 1), hid.to(cuda), state, 0.3,
        None if active is None else active.to(cuda), act_bits)
    assert de.KERNEL.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(_bits(state), _bits(want_state))


# (b, h): the pool and batch-1 engine at the 2x1024 model's width, and
# widths that leave partial blocks
HPE_CASES = [(16, 1024), (1, 1024), (3, 700), (3, 128)]


@pytest.mark.parametrize("b,h", HPE_CASES)
@pytest.mark.parametrize("mode", ["null", "all", "mixed"])
def test_lstm_pointwise_step_kernel_equals_plain(cuda, b, h, mode):
    gen = _gen(b + h)
    dm = torch.randn((b, 4 * h), generator=gen) * 4
    y = torch.randn((b, 4 * h), generator=gen)
    c = torch.randn((b, h), generator=gen) * 2
    hid = torch.randn((b, h), generator=gen)
    active = _mask(b, mode)
    if active is not None:
        # poisoned rows only where the kernel must not touch them: the
        # card's arithmetic returns a canonical NaN where the host's keeps
        # the payload
        for t in (dm, c, hid):
            t[~active] = _poison(t[~active])
    want_state = [t.clone() for t in (dm, c, hid)]
    want = lp.plain_step(*want_state[:1], y, *want_state[1:], active)
    state = [t.to(cuda) for t in (dm, c, hid)]
    before = lp.KERNEL.launches
    got = lp.lstm_pointwise_step(state[0], y.to(cuda), state[1], state[2],
                                 None if active is None else active.to(cuda))
    assert lp.KERNEL.launches == before + 1
    # h of a poisoned row is a NaN on both sides, its payload the card's
    nan = want.isnan()
    assert torch.equal(got.cpu().isnan(), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    for g, w in zip(state, want_state):
        assert torch.equal(_bits(g), _bits(w))


def _cbcsc(seed, h, q, m, gamma):
    w = apply_cbtd(torch.randn((h, q), generator=_gen(seed)) * 0.1, gamma, m)
    return cbcsc_encode(w, m, blen=blen_for(h, m, gamma))


def _int8(val, lidx, s):
    """The quantized pack's storage: int8 codes at a power-of-two scale,
    lidx int8 where S fits it (int32 otherwise)."""
    scale = float(2.0 ** np.ceil(np.log2(float(val.abs().max()) / 127)))
    val8 = torch.round(val / scale).to(torch.int8)
    return val8, lidx.to(torch.int8) if s <= 127 else lidx, scale


@pytest.mark.parametrize("h,q,m,gamma", [(4096, 2048, 64, 0.9375),
                                         (128, 96, 16, 0.75)])
@pytest.mark.parametrize("payload", ["fp32", "int8"])
def test_stsp_spmv_kernels_match_plain(cuda, h, q, m, gamma, payload):
    enc = _cbcsc(q, h, q, m, gamma)
    val, lidx, scale = enc.val, enc.lidx, 1.0
    if payload == "int8":
        val, lidx, scale = _int8(val, lidx, enc.s)
    fired = torch.rand((16, q), generator=_gen(1)) < 0.3
    delta = torch.where(fired, torch.randn((16, q), generator=_gen(2)), 0.0)
    idx, ds, _ = ops.select_active_columns_batch(delta, q // 2)
    idx[0, 1] = idx[0, 0]                       # a duplicate column
    dev = [t.to(cuda) for t in (val, lidx, idx, ds)]
    before = (sp.SCATTER_BATCH_KERNEL.launches, sp.KERNEL.launches)
    got = sp.stsp_spmv_scatter_batch(*dev, s=enc.s)
    one = sp.stsp_spmv(dev[0], dev[1], dev[2][3], dev[3][3], s=enc.s)
    assert (sp.SCATTER_BATCH_KERNEL.launches, sp.KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    # the host scatter adds each row's terms in list order, as the kernel
    # does: bit-identical, at B=16 and at B=1
    assert torch.equal(got.cpu(), sp.plain_batch(val, lidx, idx, ds, enc.s))
    assert torch.equal(one.cpu(), sp.plain_batch(val, lidx, idx[3:4],
                                                 ds[3:4], enc.s)[0])
    # the batch-1 entry against the one-hot spec (another sum order)
    assert _max_err(one * scale, sp.plain(val, lidx, idx[3], ds[3], enc.s)
                    * scale) <= 1e-5


# (h, q, m, gamma, b, offset): S = h/m in {45, 40, 100, 512, 20}, no
# multiple of 16, so a lane's row registers R run 4, 4, 8, 32, 2 with the
# last partly past S; BLEN in {3, 10, 7, 16, 5} takes the kernel's
# runtime-BLEN path, (4096, 64) its BLEN=4 one; K = q/2 is no multiple of
# the 128-entry tile; m=12 gives blocks of P=2 PEs, the odd m=5 P=1 (one
# half-warp idle); offset shifts val's base by one element (narrower
# copies).
SPMV_EDGES = [
    (2880, 600, 64, 0.9375, 1, False),
    (100, 40, 5, 0.75, 3, False),
    (2880, 600, 64, 0.9375, 3, True),
    (480, 200, 12, 0.75, 16, False),
    (6400, 1000, 64, 0.9375, 16, False),
    (4096, 64, 8, 0.96875, 3, False),
    (4096, 600, 64, 0.9375, 16, True),
]


@pytest.mark.parametrize("h,q,m,gamma,b,offset", SPMV_EDGES)
@pytest.mark.parametrize("payload", ["fp32", "int8", "fp32-lidx8"])
def test_stsp_spmv_kernel_edges_exact(cuda, h, q, m, gamma, b, offset,
                                      payload):
    enc = _cbcsc(h + q, h, q, m, gamma)
    val, lidx = enc.val, enc.lidx
    if payload == "int8":
        val, lidx, _ = _int8(val, lidx, enc.s)
    elif payload == "fp32-lidx8" and enc.s <= 127:
        lidx = lidx.to(torch.int8)
    fired = torch.rand((b, q), generator=_gen(b)) < 0.4
    delta = torch.where(fired, torch.randn((b, q), generator=_gen(b + 1)),
                        0.0)
    idx, ds, _ = ops.select_active_columns_batch(delta, q // 2)
    idx[0, 1] = idx[0, 0]                       # a duplicate column
    ds[:, 5] = 0.0                              # padding mid-list
    idx[:, 7], idx[:, 9] = q + 5, -3            # out of range: skipped
    # what the kernel must equal: the same list with the skipped entries
    # turned into padding
    bad = (idx < 0) | (idx >= q)
    want = sp.plain_batch(val, lidx, torch.where(bad, 0, idx),
                          torch.where(bad, 0.0, ds), enc.s)
    dval = val.to(cuda)
    if offset:
        store = torch.zeros(val.numel() + 1, dtype=val.dtype, device=cuda)
        store[1:] = dval.flatten()
        dval = store[1:].view(val.shape)
    dev = [lidx.to(cuda), idx.to(cuda), ds.to(cuda)]
    got = sp.stsp_spmv_scatter_batch(dval, *dev, s=enc.s)
    assert torch.equal(got.cpu(), want)
    one = sp.stsp_spmv(dval, dev[0], dev[1][b - 1], dev[2][b - 1], s=enc.s)
    assert torch.equal(one.cpu(), want[b - 1])



def _ulp_report(got, want):
    """How many elements differ, and by at most how many ulps."""
    diff = (got.view(torch.int32).long() - want.view(torch.int32).long())
    n = int((got != want).sum())
    return f"{n} of {got.numel()} elements differ, by <= " \
        f"{int(diff.abs().max())} ulp"


MIRROR_ROWS = (1, 4, 8, 16, 24, 32, 48)


def _mirror_case(q, payload, fired_share, rows=max(MIRROR_ROWS), n=4096):
    """Seeded deltas [rows, q] with ``fired_share`` of them nonzero, and a
    mirror [q, n] (fp32, or int8 with its scale)."""
    g = _gen(q if fired_share == 0.3 else q + 5)
    fired = torch.rand((rows, q), generator=g) < fired_share
    ds = torch.where(fired, torch.randn((rows, q), generator=g), 0.0)
    wt = 0.05 * torch.randn((q, n), generator=g)
    scale = None
    if payload == "int8":
        scale = torch.tensor(2.0 ** -7)
        wt = torch.clamp(torch.round(wt / scale), -127, 127).to(torch.int8)
    return ds, wt, scale


@pytest.mark.parametrize("fired_share", [0.05, 0.3])
@pytest.mark.parametrize("q", [1147, 2048])
@pytest.mark.parametrize("payload", ["fp32", "int8"])
def test_dense_mirror_kernel_equals_plain(cuda, q, payload, fired_share):
    """The dense-mirror kernel at the 2x1024 model's layer shapes (Q =
    D+H, N = 4H = 4096), 5% (the served model's share) and 30% of the
    deltas fired, equals its plain float64 product on the card and on the
    host at B = 1, 4, 8, 16, 24, 32 and 48 (past one pass of rows), and
    each row equals the same row computed alone."""
    ds, wt, scale = _mirror_case(q, payload, fired_share)
    d_wt = wt.to(cuda)
    d_scale = None if scale is None else scale.to(cuda)
    alone = [dm.dense_mirror(ds[i:i + 1].to(cuda), d_wt, d_scale).cpu()
             for i in range(ds.shape[0])]
    for b in MIRROR_ROWS:
        before = dm.KERNEL.launches
        got = dm.dense_mirror(ds[:b].to(cuda), d_wt, d_scale)
        assert dm.KERNEL.launches == before + 1
        for want in (dm.plain(ds[:b].to(cuda), d_wt, d_scale).cpu(),
                     dm.plain(ds[:b], wt, scale)):
            assert torch.equal(got.cpu(), want), _ulp_report(got.cpu(), want)
        assert torch.equal(got.cpu(), torch.cat(alone[:b]))


@pytest.mark.parametrize("payload", ["fp32", "int8"])
def test_dense_mirror_rows_do_not_depend_on_their_neighbours(cuda, payload):
    """A row's output is bit-identical whatever rows share its launch:
    the rows permuted, and one row among 15 neighbours that fire exactly
    the k it does not, each equal the row computed alone."""
    ds, wt, scale = _mirror_case(2048, payload, 0.05, rows=16)
    d_wt = wt.to(cuda)
    d_scale = None if scale is None else scale.to(cuda)
    alone = torch.cat([dm.dense_mirror(ds[i:i + 1].to(cuda), d_wt,
                                       d_scale).cpu() for i in range(16)])
    perm = torch.randperm(16, generator=_gen(5))
    got = dm.dense_mirror(ds[perm].to(cuda), d_wt, d_scale).cpu()
    assert torch.equal(got, alone[perm])
    row = ds[3]
    others = torch.randn((15, 2048), generator=_gen(6))
    others[:, row != 0] = 0.0           # fire every k the row does not
    mixed = torch.cat([others[:7], row[None], others[7:]])
    got = dm.dense_mirror(mixed.to(cuda), d_wt, d_scale).cpu()
    assert torch.equal(got[7], alone[3])
    assert torch.equal(got, dm.plain(mixed, wt, scale))


def test_dense_mirror_kernel_edges(cuda):
    """Ragged shapes (Q and N off the kernel's tiles), a row group of 3,
    all-zero rows and a batch beyond one row group; a launch whose every
    row is zero; a row that alone fires, at the last k of a ragged slice;
    an int8 mirror whose rows copy 4 bytes at a time (N = 96) and byte by
    byte (N = 50)."""
    g = _gen(7)
    for b, q, n in ((3, 37, 50), (17, 300, 96), (1, 0, 64), (5, 64, 1)):
        ds = torch.randn((b, q), generator=g)
        if b > 1:
            ds[1] = 0.0
        wt = torch.randn((q, n), generator=g)
        got = dm.dense_mirror(ds.to(cuda), wt.to(cuda))
        assert torch.equal(got.cpu(), dm.plain(ds, wt))
    wt = torch.randn((300, 96), generator=g)
    zero = torch.zeros((5, 300))
    got = dm.dense_mirror(zero.to(cuda), wt.to(cuda))
    assert torch.equal(got.cpu(), dm.plain(zero, wt))
    lone = torch.zeros((5, 300))
    lone[2, 299] = 1.5                  # the last k of slice 9 (12 wide)
    got = dm.dense_mirror(lone.to(cuda), wt.to(cuda)).cpu()
    assert torch.equal(got, dm.plain(lone, wt))
    assert torch.equal(got[2], dm.dense_mirror(lone[2:3].to(cuda),
                                               wt.to(cuda)).cpu()[0])
    scale = torch.tensor(2.0 ** -7)
    for n in (96, 50):
        ds = torch.where(torch.rand((6, 300), generator=g) < 0.3,
                         torch.randn((6, 300), generator=g), 0.0)
        wt8 = torch.randint(-127, 128, (300, n), generator=g,
                            dtype=torch.int8)
        got = dm.dense_mirror(ds.to(cuda), wt8.to(cuda), scale.to(cuda))
        assert torch.equal(got.cpu(), dm.plain(ds, wt8, scale))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 8), device=cuda)
    with pytest.raises(TypeError):
        de.delta_encode(x.double(), x.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        lp.lstm_pointwise(torch.zeros((2, 8, 4), device=cuda).transpose(1, 2),
                          torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        de.delta_encode(x, x.cpu(), 0.1)
    with pytest.raises(TypeError, match="active"):
        de.delta_encode_step(x, x, torch.zeros((2, 16), device=cuda), 0.1,
                             torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="s_hat"):
        de.delta_encode_step(x, x, x, 0.1)
    with pytest.raises(ValueError, match="dm, y"):
        lp.lstm_pointwise_step(x, x, x, x)
    val = torch.zeros((4, 2, 2), device=cuda, dtype=torch.float16)
    lidx = torch.zeros((4, 2, 2), device=cuda, dtype=torch.int32)
    idx = torch.zeros((1, 3), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32/int8"):
        sp.stsp_spmv_scatter_batch(val, lidx, idx, idx.float(), s=4)
    with pytest.raises(ValueError, match="rows per PE"):
        sp.stsp_spmv_scatter_batch(val.float(), lidx, idx, idx.float(),
                                   s=sp.MAX_S + 1)
    with pytest.raises(TypeError, match="float32 or int8"):
        dm.dense_mirror(x, x.T.contiguous().half())
    with pytest.raises(ValueError, match="wt \\[Q, N\\]"):
        dm.dense_mirror(x, x)


@pytest.mark.parametrize("route", ["scatter", "dense"])
@pytest.mark.parametrize("quant", [False, True])
def test_pool_on_card_matches_host_pool_and_batch1(cuda, route, quant):
    from repro_torch.core import QuantConfig

    cfg = lstm_am.LSTMAMConfig(input_dim=20, hidden_dim=64, n_layers=2,
                               n_classes=11)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(_gen(0), cfg, device="cpu"), gamma=0.75, m=8)
    ecfg = EngineConfig(theta=0.05, gamma=0.75, m=8, spmv_path=route,
                        quant=QuantConfig() if quant else None)
    rng = np.random.default_rng(0)
    reqs = [(i, rng.standard_normal((t, 20)).astype(np.float32))
            for i, t in enumerate([9, 6, 12, 7])]
    card, _ = serve_requests(BatchedSpartusEngine(params, cfg, ecfg,
                                                  device=cuda), reqs, 3,
                             chunk_frames=4)
    host, _ = serve_requests(BatchedSpartusEngine(params, cfg, ecfg,
                                                  device="cpu"), reqs, 3,
                             chunk_frames=4)
    batch1 = SpartusEngine(params, cfg, ecfg, device=cuda)
    for a, b, (_, feats) in zip(card, host, reqs):
        np.testing.assert_allclose(a.logits, b.logits, atol=1e-5)
        np.testing.assert_allclose(
            a.logits, batch1.run_utterance(feats).cpu().numpy(), atol=1e-5)


def _shard_model(device, route):
    cfg = lstm_am.LSTMAMConfig(input_dim=20, hidden_dim=64, n_layers=2,
                               n_classes=11)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(_gen(0), cfg, device="cpu"), gamma=0.75, m=8)
    return BatchedSpartusEngine(params, cfg, EngineConfig(
        theta=0.05, gamma=0.75, m=8, spmv_path=route), device=device)


def _shard_requests():
    rng = np.random.default_rng(3)
    return [(i % 3, rng.standard_normal((t, 20)).astype(np.float32))
            for i, t in enumerate([9, 6, 12, 7, 15, 3, 10, 8, 5, 11])]


@pytest.mark.parametrize("route", ["scatter", "dense"])
def test_sharded_pool_on_card_matches_host_and_unsharded(cuda, route):
    """4 logical shards of 2 slots on the card: within 1e-5 of the same
    sharded pool on the host and of the unsharded pool on the card (the
    head's fp32 GEMM may pick another cuBLAS kernel at the shard's
    batch), and their boundaries make no blocking copy or synchronize."""
    from repro_torch.launch.mesh import emulated_devices

    from repro_torch.serving import SessionPool, StreamRequest

    reqs = _shard_requests()
    card = _shard_model(cuda, route)
    base, _ = serve_requests(card, reqs, 8, chunk_frames=4)
    with emulated_devices(4):
        host, _ = serve_requests(_shard_model("cpu", route), reqs, 8,
                                 chunk_frames=4, n_devices=4)
        pool = SessionPool(card, 8, max_frames=16, chunk_frames=4,
                           n_devices=4)
    serve_requests(card, reqs[:4], 8, chunk_frames=4)      # warm-up
    pending = sorted((StreamRequest(i, a, f)
                      for i, (a, f) in enumerate(reqs)),
                     key=lambda r: (r.arrival_step, r.req_id))
    got, now = {}, 0
    torch.cuda.synchronize()
    with _NoSync():
        while pending or pool.n_active or pool.has_pending:
            while pending and pending[0].arrival_step <= now and pool.n_free:
                assert pool.admit(pending.pop(0), now)
            fin, adv = pool.tick(now)
            got.update({r.req_id: r.logits for r in fin})
            now += max(adv, 1)
    assert pool.n_shards == 4
    for b, c in zip(host, base):
        np.testing.assert_allclose(got[b.req_id], b.logits, atol=1e-5)
        np.testing.assert_allclose(got[b.req_id], c.logits, atol=1e-5)
    assert pool.measured_sparsity()["temporal_sparsity"] > 0


@pytest.mark.parametrize("route", ["scatter", "dense"])
def test_sharded_pool_on_distinct_cards(cuda, route):
    """With two cards, a 2-shard pool of an engine on ``cuda`` (the
    current card) places one shard on each, with the engine's weights
    copied to the second once, serves the unsharded pool's logits within
    1e-5, and leaves the current card as it was: a kernel launched on the
    second card gives the caller's current device back."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from repro_torch.serving import SessionPool

    reqs = _shard_requests()
    card = _shard_model(cuda, route)
    pool = SessionPool(card, 4, chunk_frames=4, n_devices=2)
    assert pool._devices == [torch.device("cuda", 0),
                             torch.device("cuda", 1)]
    assert pool._shards[0].engine is card and len(card._replicas) == 1
    assert pool._shards[1].engine.device == torch.device("cuda", 1)
    assert pool._shards[1].state.cursor.device == torch.device("cuda", 1)
    x = torch.randn((4, 64), device="cuda:1")
    de.delta_encode(x, torch.zeros_like(x), 0.3)
    assert torch.cuda.current_device() == 0
    base, _ = serve_requests(card, reqs, 4, chunk_frames=4)
    sharded, _ = serve_requests(card, reqs, 4, chunk_frames=4, n_devices=2)
    assert torch.cuda.current_device() == 0
    for a, b in zip(sharded, base):
        np.testing.assert_allclose(a.logits, b.logits, atol=1e-5)


def test_cuda_resolves_to_the_current_card(cuda):
    """An unindexed ``cuda`` resolves once, to ``cuda:<current>``: an
    engine built on it carries its index, and ``engine.on`` of either
    spelling is the engine itself (device identity is ``==``)."""
    from repro_torch._device import resolve_device

    here = torch.device("cuda", torch.cuda.current_device())
    assert resolve_device(None) == resolve_device("cuda") == here
    card = _shard_model(cuda, "scatter")
    assert card.device == here
    assert card.on("cuda") is card and card.on(here) is card
    assert not card._replicas


def test_engine_refuses_tf32_head(cuda):
    cfg = lstm_am.LSTMAMConfig(input_dim=20, hidden_dim=64, n_layers=2,
                               n_classes=11)
    params = lstm_am.init_params(_gen(0), cfg, device="cpu")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            SpartusEngine(params, cfg, EngineConfig(), device=cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _stream_model(cuda, route):
    cfg = lstm_am.LSTMAMConfig(input_dim=20, hidden_dim=64, n_layers=2,
                               n_classes=11)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(_gen(1), cfg, device="cpu"), gamma=0.75, m=8)
    return BatchedSpartusEngine(params, cfg, EngineConfig(
        theta=0.05, gamma=0.75, m=8, spmv_path=route), device=cuda)


@pytest.mark.parametrize("route", ["scatter", "dense"])
@pytest.mark.parametrize("offload", [True, False])
def test_async_server_on_card_matches_serve_requests(cuda, route, offload):
    """Drip-fed clients through the async server on the card: the
    streamed partials are the result bit for bit, and the result is
    serve_requests' on the card within 1e-5."""
    import asyncio

    from repro_torch.serving import AsyncSpartusServer, StreamRequest

    engine = _stream_model(cuda, route)
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((t, 20)).astype(np.float32)
             for t in (17, 5, 30, 9, 23)]

    async def client(srv, f, seed):
        r = np.random.default_rng(seed)
        h = await srv.stream(want_partials=True)
        j = 0
        while j < len(f):
            n = int(r.integers(1, 6))
            await h.send(f[j:j + n])
            j += n
            await asyncio.sleep(0)
        h.close()
        parts = [p async for p in h]
        return parts, await h.result()

    async def run():
        async with AsyncSpartusServer(engine, 3, chunk_frames=4,
                                      max_frames=32, partial_queue_len=2,
                                      offload_ticks=offload) as srv:
            out = await asyncio.gather(*[client(srv, f, i)
                                         for i, f in enumerate(feats)])
            return out, srv.pool.n_active

    out, n_active = asyncio.run(run())
    sync, _ = serve_requests(engine, [StreamRequest(i, 0, f)
                                      for i, f in enumerate(feats)], 3,
                             chunk_frames=4)
    assert n_active == 0
    for (parts, res), ref in zip(out, sync):
        np.testing.assert_array_equal(
            np.concatenate([p.rows for p in parts]), res.logits)
        np.testing.assert_allclose(res.logits, ref.logits, atol=1e-5)


class _NoSync:
    """torch's sync debug mode at "error" while active: any blocking copy
    or synchronize raises (event waits, the tick's only waits, do not)."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("route", ["scatter", "dense"])
def test_pool_boundaries_on_card_never_sync(cuda, route):
    """The gpu twin of the CPU pin: with observability and partials on, a
    pool's boundaries on the card (admissions, appends, ``tick`` with
    its dispatch, retirements and observability fold, the staged
    backfill, ``staged_sparsity``, the engine's telemetry totals) make no
    blocking copy or synchronize, and the streamed blocks, a backfill
    among them, still concatenate to each result bit for bit."""
    from repro_torch.serving import PoolObservability, SessionPool

    engine = _stream_model(cuda, route)
    rng = np.random.default_rng(8)
    feats = [rng.standard_normal((t, 20)).astype(np.float32)
             for t in (30, 17, 45)]
    pool = SessionPool(engine, 3, max_frames=8, chunk_frames=4,
                       stream_partials=True,
                       observability=PoolObservability())
    warm = SessionPool(engine, 3, max_frames=8, chunk_frames=4,
                       stream_partials=True,
                       observability=PoolObservability())
    assert warm.admit_stream(99, 0, feats=feats[0][:9])
    warm.finish_stream(99)
    while warm.n_active or warm.has_pending:
        warm.tick(0)
        warm.take_partials()
    sent, out, parts, now, ticks, backfilled = [3, 3, 3], {}, [], 0, 0, 0
    with _NoSync():
        for rid, f in enumerate(feats):
            assert pool.admit_stream(rid, 0, feats=f[:3])
        while len(out) < len(feats):
            for rid, f in enumerate(feats):
                if rid in pool._by_req and sent[rid] < len(f):
                    pool.append_frames(rid, f[sent[rid]:sent[rid] + 5])
                    sent[rid] = min(len(f), sent[rid] + 5)
                    if sent[rid] == len(f):
                        pool.finish_stream(rid)
            fin, adv = pool.tick(now)
            out.update({r.req_id: r.logits for r in fin})
            now += max(adv, 1)
            parts += pool.take_partials()
            ticks += 1
            if ticks == 1:
                pool.pause_partials(1)
            if ticks == 4:
                got = sum(p.rows.shape[0] for p in parts if p.req_id == 1)
                backfilled = pool.backfill_partials(1, got)
            pool.staged_sparsity()
            pool.telemetry_totals()
        parts += pool.take_partials()
    assert backfilled > 4
    assert pool.staged_sparsity() == pool.measured_sparsity()
    for rid in range(len(feats)):
        mine = sorted((p for p in parts if p.req_id == rid),
                      key=lambda p: p.t0)
        assert np.array_equal(np.concatenate([p.rows for p in mine]),
                              out[rid])


def test_async_server_on_card_never_syncs(cuda):
    """The async server with ticks offloaded, a slow consumer backfilled
    and ``stats()`` read mid-run makes no blocking copy or synchronize
    anywhere (loop or worker); the stream is still the result bit for
    bit and serve_requests' on the card within 1e-5."""
    import asyncio

    from repro_torch.serving import AsyncSpartusServer, StreamRequest

    engine = _stream_model(cuda, "scatter")
    rng = np.random.default_rng(9)
    feats = [rng.standard_normal((t, 20)).astype(np.float32)
             for t in (48, 11, 26)]
    serve_requests(engine, [StreamRequest(0, 0, feats[1])], 2,
                   chunk_frames=2)                    # warm-up

    async def run():
        async with AsyncSpartusServer(engine, 2, chunk_frames=2,
                                      max_frames=64, partial_queue_len=3,
                                      offload_ticks=True) as srv:
            others = [asyncio.ensure_future(srv.submit(f))
                      for f in feats[1:]]
            h = await srv.stream(want_partials=True)
            for j in range(0, 48, 4):
                await h.send(feats[0][j:j + 4])
                await asyncio.sleep(0.001)
            for _ in range(5000):
                if h.req_id in srv._lagging:
                    break
                await asyncio.sleep(0.002)
            mid = srv.stats()
            parts = [await h.__anext__() for _ in range(2)]
            await asyncio.sleep(0.05)
            h.close()
            parts += [p async for p in h]
            return parts, await h.result(), await asyncio.gather(*others), \
                mid

    with _NoSync():
        parts, result, others, mid = asyncio.run(run())
    np.testing.assert_array_equal(np.concatenate([p.rows for p in parts]),
                                  result.logits)
    assert max(p.rows.shape[0] for p in parts) > 2
    assert mid.n_dispatches > 0
    sync, _ = serve_requests(engine, [StreamRequest(i, 0, f)
                                      for i, f in enumerate(feats)], 2,
                             chunk_frames=2)
    for got, ref in zip([result] + others, sync):
        np.testing.assert_allclose(got.logits, ref.logits, atol=1e-5)


def test_pinned_fetch_matches_cpu_copy(cuda):
    """The staged device-to-host copy (pinned buffer, non-blocking, one
    event) returns exactly what a blocking .cpu() of the same rows does,
    also when the source is overwritten right after the copy is
    enqueued — the copy is ordered before the overwrite."""
    from repro_torch._device import HostCopy, upload

    src = torch.randn((16, 320, 41), generator=_gen(7)).to(cuda)
    want = src.cpu()
    slots = torch.tensor([3, 0, 11], device=cuda)
    fetch = HostCopy(src.index_select(0, slots)[:, :200], src[5])
    src.fill_(float("nan"))                         # the next chunk
    got_rows, got_row = fetch.wait()
    assert got_rows.is_pinned() and got_row.is_pinned()
    assert torch.equal(got_rows, want[[3, 0, 11], :200])
    assert torch.equal(got_row, want[5])
    back = upload(np.arange(12, dtype=np.int32), cuda)
    assert back.device.type == "cuda"
    assert torch.equal(back.cpu(), torch.arange(12, dtype=torch.int32))


def test_pool_snapshot_restore_on_card_is_bit_identical(cuda):
    """Sessions snapshotted mid-stream out of a pool on the card and
    restored into a larger one finish with the uninterrupted run's
    logits exactly."""
    from repro_torch.serving import SessionPool, restore_into

    engine = _stream_model(cuda, "scatter")
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((t, 20)).astype(np.float32)
             for t in (13, 7, 21)]

    def drive(pool, now=0):
        out = {}
        while pool.n_active or pool.has_pending:
            fin, adv = pool.tick(now)
            out.update({r.req_id: r.logits for r in fin})
            now += max(adv, 1)
        return out

    ref_pool = SessionPool(engine, 3, max_frames=32, chunk_frames=4)
    for i, f in enumerate(feats):
        assert ref_pool.admit_stream(i, 0, feats=f)
        ref_pool.finish_stream(i)
    ref = drive(ref_pool)
    pool = SessionPool(engine, 3, max_frames=32, chunk_frames=4)
    for i, f in enumerate(feats):
        assert pool.admit_stream(i, 0, feats=f[:6])
    pool.tick(0)
    big = SessionPool(engine, 6, max_frames=32, chunk_frames=4)
    restore_into(big, pool.snapshot())
    for i, f in enumerate(feats):
        big.append_frames(i, f[6:])
        big.finish_stream(i)
    got = drive(big, now=4)
    for i in range(3):
        assert np.array_equal(got[i], ref[i]), i


def _train_case(delta: bool):
    """A small pretrain (or DeltaLSTM retrain) config, host params and a
    host batch."""
    from repro_torch.data.speech import SpeechConfig, SpeechDataset
    from repro_torch.training.trainer import TrainConfig

    model = lstm_am.LSTMAMConfig(input_dim=123, hidden_dim=64, n_layers=2,
                                 n_classes=41, delta=delta, theta=0.3)
    cfg = TrainConfig(model=model, data=SpeechConfig(max_frames=32),
                      batch_size=4, cbtd_gamma=0.75, cbtd_m=8)
    params = lstm_am.init_params(_gen(0), model, device="cpu")
    return cfg, params, next(SpeechDataset(cfg.data, 4))


def _to(tree, device):
    from repro_torch import _tree

    return _tree.tree_map(lambda t: t.to(device), tree)


def test_train_step_on_card_matches_host(cuda):
    """One LSTM pretrain step on the card against the same step on the
    host: loss, gradients (relative to the largest) and the updated
    params within 1e-4; then CBTD of the same params on the card is
    bit-equal to the host's; the DeltaLSTM retrain step, whose thresholds
    can flip on an ulp, is held by its loss."""
    from repro_torch import _tree
    from repro_torch.core import cbtd_prune_tree
    from repro_torch.core.cbtd import CBTDConfig
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import loss_and_grads, make_train_step

    cfg, params, batch = _train_case(delta=False)
    loss_h, grads_h = loss_and_grads(params, cfg, batch)
    loss_c, grads_c = loss_and_grads(_to(params, cuda), cfg,
                                     _to(batch, cuda))
    assert abs(float(loss_c) - float(loss_h)) <= 1e-4 * abs(float(loss_h))
    gmax = max(float(g.abs().max()) for g in _tree.leaves(grads_h))
    for a, b in zip(_tree.leaves(grads_c), _tree.leaves(grads_h)):
        assert _max_err(a, b) <= 1e-4 * gmax
    step = make_train_step(cfg)
    host, _, _ = step(params, adamw_init(params), batch, 0.0)
    dev_params = _to(params, cuda)
    card, state, _ = step(dev_params, adamw_init(dev_params),
                            _to(batch, cuda), 0.0)
    assert state.step.device.type == "cuda"
    for a, b in zip(_tree.leaves(card), _tree.leaves(host)):
        assert a.device.type == "cuda" and _max_err(a, b) <= 1e-4
    layout = {k: CBTDConfig(gamma=0.75, m=8) for k in ("w_x", "w_h", "fcl/w")}
    pruned_c = cbtd_prune_tree(card, layout, 1.0)
    pruned_h = cbtd_prune_tree(_to(card, "cpu"), layout, 1.0)
    for a, b in zip(_tree.leaves(pruned_c), _tree.leaves(pruned_h)):
        assert torch.equal(a.cpu(), b)

    cfg, params, batch = _train_case(delta=True)
    loss_h, _ = loss_and_grads(params, cfg, batch)
    loss_c, _ = loss_and_grads(_to(params, cuda), cfg, _to(batch, cuda))
    assert abs(float(loss_c) - float(loss_h)) <= 1e-4 * abs(float(loss_h))


@pytest.mark.parametrize("width", ["test", "full"])
def test_contract_cases_on_card(cuda, width):
    """Every contract case on the card, each traced call under sync debug
    mode "error": zero violations, the same op histogram as on the host
    at test scale."""
    from repro_torch.analysis import cases, contracts

    host = {c.name: contracts.check_case(c)
            for c in (cases.build_cases(device="cpu")
                      + cases.served_cases(device="cpu"))} \
        if width == "test" else {}
    for case in (cases.build_cases(width=width, device=cuda)
                 + cases.served_cases(width=width, device=cuda)):
        built = case.build()
        torch.cuda.synchronize()
        with _NoSync():
            report = contracts.check_built(case, built)
        assert report.ok, [str(v) for v in report.violations]
        if case.name in host:
            assert report.op_histogram == host[case.name].op_histogram


def _zoo_outputs(cfg, params, device, seed=1):
    """The forward over 16 tokens (B=2) and 8 decode steps from a zero
    16-slot cache (audio: the cross-KV of 12 frames), on ``device``."""
    from repro_torch.models import api, encdec, mamba2, rglru, transformer

    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                         dtype=torch.int32).to(device)
    x = torch.randn((2, 16, cfg.d_model), generator=gen).to(device)
    frames = x[:, :12]
    with torch.inference_mode():
        if cfg.family in ("dense", "moe"):
            fwd = transformer.forward(params, cfg, toks)
        elif cfg.family == "vlm":
            fwd = transformer.forward(params, cfg, None, inputs_embeds=x)
        elif cfg.family == "ssm":
            fwd = mamba2.forward(params, cfg, toks)
        elif cfg.family == "hybrid":
            fwd = rglru.forward(params, cfg, toks)
        else:
            fwd = encdec.decode_train(params, cfg, toks,
                                      encdec.encode(params, cfg, frames))
        if cfg.family == "audio":
            cache = api.init_cache(cfg, 2, 12, device=device)
            cache["cross"] = api.prefill(params, cfg, frames)
        else:
            cache = api.init_cache(cfg, 2, 16, device=device)
        steps = []
        for i in range(8):
            inp = x[:, i:i + 1] if cfg.family == "vlm" else toks[:, i:i + 1]
            logits, cache = api.serve_step(params, cfg, inp, cache)
            steps.append(logits)
    assert int(cache["pos"]) == 8
    return fwd.cpu(), torch.cat(steps, 1).cpu()


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-1.7b", "granite-34b",
                                  "internlm2-20b", "mamba2-130m",
                                  "pixtral-12b", "granite-moe-1b-a400m",
                                  "olmoe-1b-7b", "seamless-m4t-medium",
                                  "recurrentgemma-9b"])
def test_zoo_arch_on_card_matches_host(cuda, name):
    """Each registry arch at ``.reduced()``: the forward and 8 decode
    steps on the card against the same weights on the host, within 1e-4
    of max|logits| (fp32 sums in another order; ``chip_smoke.py`` phase 7
    holds the same gate at full width)."""
    from repro_torch import _tree
    from repro_torch.configs import get_arch
    from repro_torch.models import api

    cfg = get_arch(name).reduced()
    host = api.init_params(cfg, _gen(0), device="cpu")
    card = _tree.tree_map(lambda a: a.to(cuda), host)
    for got, want in zip(_zoo_outputs(cfg, card, cuda),
                         _zoo_outputs(cfg, host, "cpu")):
        assert torch.isfinite(got).all()
        assert _max_err(got, want) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-1.7b", "granite-34b",
                                  "internlm2-20b", "mamba2-130m",
                                  "pixtral-12b", "granite-moe-1b-a400m",
                                  "olmoe-1b-7b", "seamless-m4t-medium",
                                  "recurrentgemma-9b"])
def test_zoo_train_step_on_card_matches_host(cuda, name):
    """One ``make_train_step`` of each registry arch at ``.reduced()`` on
    the card against the same step on the host (the launcher's optimizer
    and first batch, B=4, S=32): loss 1e-4 relative, the clipped
    gradients (``m / (1 - b1)``) 1e-4 of the largest, the updated params
    1e-4 of max|param|, but for elements whose host gradient lies within
    twice the card-vs-host gap of 0 (Adam's first step may take them
    either way, up to 2 lr apart; at most 2% of a tree)."""
    from repro_torch import _tree
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMConfig, LMDataset
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.training.optimizer import adamw_init

    cfg = get_arch(name).reduced()
    args = train.parse_args(["--arch", name, "--steps", "18"])
    opt_cfg = train.adamw_config(args)
    host = api.init_params(cfg, _gen(0), device="cpu")
    card = _tree.tree_map(lambda a: a.to(cuda), host)
    batch = train.next_batch(cfg, LMDataset(LMConfig(vocab=cfg.vocab,
                                                     seq_len=32), 4,
                                            device="cpu"), 0, 4, 32)
    step = st.make_train_step(cfg, opt_cfg, 32)
    pc, oc, mc = step(card, adamw_init(card),
                      {k: v.to(cuda) for k, v in batch.items()})
    ph, oh, mh = step(host, adamw_init(host), batch)
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-4 * abs(
        float(mh["loss"]))
    gh = [m / (1 - opt_cfg.b1) for m in _tree.leaves(oh.m)]
    gc = [m.cpu() / (1 - opt_cfg.b1) for m in _tree.leaves(oc.m)]
    gmax = max(float(g.abs().max()) for g in gh)
    pmax = max(float(p.abs().max()) for p in _tree.leaves(ph))
    lr, n_free, n_all = float(mh["lr"]), 0, 0
    for a, b, g_c, g_h in zip(_tree.leaves(pc), _tree.leaves(ph), gc, gh):
        assert a.device.type == "cuda"
        assert _max_err(g_c, g_h) <= 1e-4 * gmax
        free = (g_h.abs() <= 2 * (g_c - g_h).abs()) & ((g_h != 0) | (g_c != 0))
        err = (a.cpu().double() - b.double()).abs()
        assert bool((err <= 1e-4 * pmax + free.double() * 2 * lr).all())
        n_free += int(free.sum())
        n_all += free.numel()
    assert n_free <= 0.02 * n_all


def test_lm_stream_on_card(cuda):
    """The LM stream drawn on the card: the views, ids under the vocab,
    the same batch from two datasets and after ``load_state_dict``, and
    the first tokens of 4096 streams against ``softmax(zipf)`` (Pearson
    chi-square under its 1 - 1e-4 quantile, cells expecting < 5 pooled)."""
    from scipy import stats

    from repro_torch.data import lm

    cfg = lm.LMConfig(vocab=64, seq_len=8)
    data = lm.LMDataset(cfg, 4096, device=cuda)
    tok, tgt = next(data)
    assert tok.device.type == "cuda" and tok.dtype == torch.int32
    assert torch.equal(tok[:, 1:], tgt[:, :-1])
    assert int(tok.min()) >= 0 and int(tgt.max()) < cfg.vocab
    again = lm.LMDataset(cfg, 4096, device=cuda)
    assert torch.equal(next(again)[0], tok)
    again.load_state_dict({"step": 0})
    assert torch.equal(next(again)[1], tgt)
    p = torch.softmax(lm._zipf_logits(cfg, "cpu").double(), 0).numpy()
    obs = np.bincount(tok[:, 0].cpu().numpy(), minlength=cfg.vocab)
    exp = 4096 * p
    small = exp < 5
    obs = np.append(obs[~small], obs[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    obs, exp = obs[exp > 0], exp[exp > 0]
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert stat <= stats.chi2.ppf(1 - 1e-4, len(exp) - 1)


def _zoo_train_state(device, name="qwen3-1.7b"):
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.training.optimizer import adamw_init

    cfg = get_arch(name).reduced()
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
    batch = api.make_train_batch(cfg, torch.Generator(device).manual_seed(1),
                                 8, 32)
    return cfg, params, adamw_init(params), batch


def _assert_zoo_trees_equal(got, want):
    from repro_torch import _tree
    from repro_torch.distributed.sharding import host_tree

    for (path, a), b in zip(_tree.leaves_with_path(host_tree(got)),
                            _tree.leaves(host_tree(want))):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_sharded_zoo_train_step_on_logical_shards(cuda, name):
    """Two logical shards of cuda:0 on a (1, 2) mesh (data size 1): three
    sharded train steps are bit-equal to the one-device steps."""
    from repro_torch.distributed.sharding import ShardedTensor
    from repro_torch.launch import elastic
    from repro_torch.launch.mesh import emulated_devices
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training.optimizer import AdamWConfig

    cfg, params, opt, batch = _zoo_train_state(cuda, name)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), 32)
    with emulated_devices(2):
        mesh = elastic.best_mesh_for(2, cuda)
    assert mesh.shape == {"data": 1, "model": 2}
    sharded = tuple(elastic.reshard(t, mesh, cfg) for t in (params, opt))
    one = (params, opt)
    for _ in range(3):
        *one, m1 = step(*one, batch)
        *sharded, m2 = step(*sharded, batch)
        assert torch.equal(m1["loss"], m2["loss"])
    _assert_zoo_trees_equal(sharded, one)
    leaf = sharded[0]["embed"]
    assert isinstance(leaf, ShardedTensor)
    assert all(s.device == torch.device("cuda", 0) for s in leaf.shards)


def test_sharded_zoo_train_step_on_distinct_cards(cuda):
    """With two cards, the (1, 2) mesh puts one shard on each; the step
    gathers onto cuda:0, is bit-equal to the one-device step, and leaves
    the current card as it was.  Then (2, 1): one data replica per
    card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from repro_torch.launch import elastic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training.optimizer import AdamWConfig

    cfg, params, opt, batch = _zoo_train_state(cuda)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), 32)
    mesh = elastic.best_mesh_for(2, cuda)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    sharded = tuple(elastic.reshard(t, mesh, cfg) for t in (params, opt))
    assert sharded[0]["embed"].shards[1].device == torch.device("cuda", 1)
    one = (params, opt)
    for _ in range(2):
        *one, m1 = step(*one, batch)
        *sharded, m2 = step(*sharded, batch)
        assert torch.equal(m1["loss"], m2["loss"])
    assert torch.cuda.current_device() == 0
    _assert_zoo_trees_equal(sharded, one)
    # two data replicas, one per card: the second computes its half of
    # the batch on cuda:1; the losses agree with the one-device step's
    from repro_torch.launch.mesh import compat_make_mesh

    mesh = compat_make_mesh((2, 1), ("data", "model"), cuda)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    state = tuple(elastic.reshard(t, mesh, cfg) for t in one)
    *one, m1 = step(*one, batch)
    *state, m2 = step(*state, batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * abs(
        float(m1["loss"]))


def _card_recount(monkeypatch):
    """Wrap the ops entry points the benchmark wraps and recount each
    call from its own inputs on the card: [calls, fired, union, staged]
    per call, in call order."""
    calls = []
    mirror, spmv = ops._mirror_matmul, ops.stsp_spmv_batch

    def counted_mirror(ds, wt, scale=None):
        fired = ds != 0
        b = ds.shape[0]
        rows = next(r for r in (1, 2, 4, 8, 16, 32) if r >= min(b, 32))
        staged = sum(int(fired[r:r + rows].any(0).sum())
                     for r in range(0, b, rows))
        calls.append([1, int(fired.sum()), int(fired.any(0).sum()), staged])
        return mirror(ds, wt, scale)

    def counted_spmv(val, lidx, idx, ds_vals, *, s, scale=None):
        live = ds_vals != 0
        n = int(live.sum())
        calls.append([1, n, int(torch.unique(idx[live]).numel()), n])
        return spmv(val, lidx, idx, ds_vals, s=s, scale=scale)

    monkeypatch.setattr(ops, "_mirror_matmul", counted_mirror)
    monkeypatch.setattr(ops, "stsp_spmv_batch", counted_spmv)
    return calls


@pytest.mark.parametrize("route", ["scatter", "dense"])
@pytest.mark.parametrize("quant", [False, True])
def test_launch_counters_on_card_equal_a_recount(cuda, monkeypatch, route,
                                                 quant):
    """The pool's launch counters on the card (the kernels' own atomics
    and marks, the HPE's count of them) equal a recount from the same
    calls' deltas and NZI lists, layer by layer, at a pool of 40 slots
    (two passes of the mirror kernel's 32 rows); logits bit-identical with
    counting on and off."""
    from repro_torch.core import QuantConfig
    from repro_torch.serving import PoolObservability

    cfg = lstm_am.LSTMAMConfig(input_dim=20, hidden_dim=64, n_layers=2,
                               n_classes=11)
    params = lstm_am.cbtd_prune_stacks(
        lstm_am.init_params(_gen(2), cfg, device="cpu"), gamma=0.75, m=8)
    ecfg = EngineConfig(theta=0.05, gamma=0.75, m=8, spmv_path=route,
                        capacity_frac=0.5,
                        quant=QuantConfig() if quant else None)
    rng = np.random.default_rng(6)
    reqs = [(0, rng.standard_normal((t, 20)).astype(np.float32))
            for t in rng.integers(8, 20, 50)]       # all there at once
    plain, _ = serve_requests(BatchedSpartusEngine(params, cfg, ecfg,
                                                   device=cuda), reqs, 40,
                              chunk_frames=4)
    engine = BatchedSpartusEngine(params, cfg, ecfg, device=cuda)
    calls = _card_recount(monkeypatch)
    got, _ = serve_requests(engine, reqs, 40, chunk_frames=4,
                            observability=PoolObservability())
    want = np.zeros((2, 4), np.int64)
    for i, c in enumerate(calls):
        want[i % 2] += c
    np.testing.assert_array_equal(engine.counters.counts.cpu().numpy(), want)
    assert int(engine.counters.marks.sum()) == 0
    if route == "dense":
        assert (want[:, 3] > want[:, 2]).all()       # 40 rows: two passes
    for a, b in zip(got, plain):
        assert np.array_equal(a.logits, b.logits)


@pytest.mark.parametrize("route", ["scatter", "dense"])
def test_launch_counters_survive_cuda_graph_replay(cuda, route):
    """One pool ``step_chunk`` captured in a CUDA graph: the counters are
    kept by the launches themselves, so n replays add n times one eager
    chunk's counts (every slot reset at the chunk's start, so every chunk
    does the same work), and the replay's logits equal the eager
    chunk's."""
    from repro_torch.kernels import counters as kcount

    engine = _stream_model(cuda, route)
    counters = engine.count_kernels()
    b, t_buf, n = 6, 16, 4
    state = engine.init_state(b)
    frames = torch.randn((b, t_buf, 20), generator=_gen(5)).to(cuda)
    lengths = torch.tensor([16, 3, 9, 16, 1, 12], dtype=torch.int32,
                           device=cuda)
    every = torch.ones((b,), dtype=torch.bool, device=cuda)
    out = engine.init_out_buf(b, t_buf + n)

    def chunk():
        with kcount.counting():            # as a pool with observability
            engine.step_chunk(state, frames, lengths, every, every, out,
                              n_frames=n)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: builds and loads
        chunk()
    torch.cuda.current_stream().wait_stream(side)
    before = counters.counts.clone()
    chunk()
    one = counters.counts - before
    eager = out.clone()
    assert one[:, 0].tolist() == [n, n] and (one[:, 2] > 0).all()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chunk()
    before = counters.counts.clone()
    out.zero_()
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(counters.counts - before, 5 * one)
    assert int(counters.marks.sum()) == 0
    assert torch.equal(out, eager)


@pytest.mark.parametrize("b", [5, 40])
@pytest.mark.parametrize("payload", ["fp32", "int8"])
def test_counted_launches_equal_plain_ones(cuda, b, payload):
    """The counted instantiations give the plain ones' outputs bit for
    bit and count one call each: the dense mirror at 2x1024 layer 2's
    shapes, and the CBCSC SpMV at BLEN 4 (counted, it runs the same
    BLEN-4 loop); the HPE then counts the union."""
    from repro_torch.kernels import counters as kcount

    q, h = 2048, 4096
    enc = _cbcsc(q, h, q, 64, 0.9375)
    val, lidx = enc.val, enc.lidx
    w = torch.randn((q, h), generator=_gen(b))
    scale = None
    if payload == "int8":
        val, lidx, _ = _int8(val, lidx, enc.s)
        scale = torch.tensor([2.0 ** -7], device=cuda)
        w = w.clamp(-1, 1).mul(127).round().to(torch.int8)
    fired = torch.rand((b, q), generator=_gen(b + 1)) < 0.2
    delta = torch.where(fired, torch.randn((b, q), generator=_gen(b + 2)),
                        0.0)
    idx, vals, _ = ops.select_active_columns_batch(delta, q // 2)
    live = vals != 0
    d_delta, d_w = delta.to(cuda), w.to(cuda)
    d_sp = [t.to(cuda) for t in (val, lidx, idx, vals)]
    y0, z0 = dm.dense_mirror(d_delta, d_w, scale), \
        sp.stsp_spmv_scatter_batch(*d_sp, s=enc.s)
    counters = kcount.KernelCounters([q, q], ["dense_mirror", "stsp_spmv"],
                                     cuda)
    hpe = [torch.zeros((b, 64), device=cuda) for _ in range(2)]
    try:
        kcount.select(counters.layers[0])
        y1 = dm.dense_mirror(d_delta, d_w, scale)
        lp.lstm_pointwise_step(torch.zeros((b, 256), device=cuda),
                               torch.zeros((b, 256), device=cuda), *hpe)
        kcount.select(counters.layers[1])
        z1 = sp.stsp_spmv_scatter_batch(*d_sp, s=enc.s)
        lp.lstm_pointwise_step(torch.zeros((b, 256), device=cuda),
                               torch.zeros((b, 256), device=cuda), *hpe)
    finally:
        kcount.select(None)
    assert torch.equal(y0, y1) and torch.equal(z0, z1)
    rows = min(32, 1 << (min(b, 32) - 1).bit_length())
    staged = sum(int(fired[r:r + rows].any(0).sum())
                 for r in range(0, b, rows))
    assert counters.counts.tolist() == [
        [1, int(fired.sum()), int(fired.any(0).sum()), staged],
        [1, int(live.sum()), int(torch.unique(idx[live]).numel()),
         int(live.sum())]]
