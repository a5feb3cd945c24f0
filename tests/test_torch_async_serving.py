"""Port parity, asyncio front-end: repro_torch.serving.AsyncSpartusServer
on the CPU, through the twelve cases of tests/test_async_serving.py, plus
one workload served by both packages' async servers and a pin that the
event loop never waits on the device.

Same model as the reference's test (D=20, H=32, 11 classes, 2 layers,
gamma=0.75, m=4, theta=0.05), its weights moved across as numpy.  The
oracle is the port's batch-1 engine; logits are held to it and to the
port's `serve_requests` at the reference's 1e-5, the concatenated
partials to the port's own result bit for bit, and the port's async
results to the reference's async results at 1e-5.
"""
import asyncio
import time

import jax
import numpy as np
import pytest

from repro.models import lstm_am as jam
from repro.serving import AsyncSpartusServer as JAsyncServer
from repro.serving import BatchedSpartusEngine as JBatched
from repro.serving import EngineConfig as JConfig
from repro_torch.launch.mesh import emulated_devices
from repro_torch.models import lstm_am as tam
from repro_torch.serving import (
    AsyncSpartusServer,
    BatchedSpartusEngine,
    EngineConfig,
    SpartusEngine,
    StreamClosed,
    StreamRequest,
    serve_requests,
)

INPUT_DIM, HIDDEN, CLASSES = 20, 32, 11
GAMMA, M, THETA = 0.75, 4, 0.05
LENS = [5, 9, 3, 12, 1, 7]
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    tcfg = tam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    params = jam.cbtd_prune_stacks(jam.init_params(jax.random.key(0), jcfg),
                                   gamma=GAMMA, m=M)
    tparams = tam.params_from_numpy(jax.device_get(params), device="cpu")
    return params, jcfg, tparams, tcfg


@pytest.fixture(scope="module")
def engines(model):
    _, _, tparams, tcfg = model
    ecfg = EngineConfig(theta=THETA, gamma=GAMMA, m=M, capacity_frac=1.0)
    return (SpartusEngine(tparams, tcfg, ecfg, device="cpu"),
            BatchedSpartusEngine(tparams, tcfg, ecfg, device="cpu"))


def _utterance(key, t):
    return np.asarray(
        jax.random.normal(jax.random.key(key), (t, INPUT_DIM)), np.float32)


def _run1(e1, feats):
    return e1.run_utterance(feats).numpy()


@pytest.fixture(scope="module")
def workload(engines):
    e1, _ = engines
    feats = [_utterance(300 + i, t) for i, t in enumerate(LENS)]
    return feats, [_run1(e1, f) for f in feats]


async def _stream_client(server, feats, rng, slice_hi=4):
    """Feed an utterance in random 1..slice_hi-frame blocks, yielding the
    loop between sends, and collect every partial."""
    handle = await server.stream(want_partials=True)
    j = 0
    while j < len(feats):
        n = int(rng.integers(1, slice_hi))
        await handle.send(feats[j:j + n])
        j += n
        await asyncio.sleep(0)
    handle.close()
    parts = [p async for p in handle]
    result = await handle.result()
    return parts, result


@pytest.mark.parametrize("capacity,chunk", [(2, 4), (4, 8), (3, 1)])
def test_async_streamed_parity_grid(engines, workload, capacity, chunk):
    _, eb = engines
    feats, refs = workload
    reqs = [StreamRequest(i, 0, feats[i]) for i in range(len(feats))]
    sync_results, _ = serve_requests(eb, reqs, capacity=capacity,
                                     chunk_frames=chunk)

    async def run():
        async with AsyncSpartusServer(
                eb, capacity, chunk_frames=chunk, max_frames=16,
                offload_ticks=False) as srv:
            rngs = [np.random.default_rng(7 * i + capacity)
                    for i in range(len(feats))]
            return await asyncio.gather(*[
                _stream_client(srv, feats[i], rngs[i])
                for i in range(len(feats))])

    out = asyncio.run(run())
    for i, (parts, result) in enumerate(out):
        assert [p.t0 for p in parts] == sorted(p.t0 for p in parts)
        streamed = np.concatenate([p.rows for p in parts])
        assert streamed.shape[0] == LENS[i]
        np.testing.assert_array_equal(streamed, result.logits)
        np.testing.assert_allclose(result.logits, refs[i], atol=TOL)
        np.testing.assert_allclose(
            result.logits, sync_results[i].logits, atol=TOL)


def test_async_submit_matches_oracle(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=2, chunk_frames=4,
                                      max_frames=16,
                                      offload_ticks=False) as srv:
            results = await asyncio.gather(
                *[srv.submit(feats[i]) for i in range(len(feats))])
            return results, srv.stats()

    results, stats = asyncio.run(run())
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.logits, refs[i], atol=TOL)
        assert 0 <= r.queue_wait_s <= r.wall_latency_s + 1e-9
        assert 0 < r.ttfl_s <= r.wall_latency_s + 1e-9
    assert stats.n_requests == len(feats)
    assert stats.total_frames == sum(LENS)
    assert stats.p50_ttfl_s > 0
    assert stats.p99_latency_s >= stats.p50_latency_s


def test_async_mid_stream_admission(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=2, chunk_frames=2,
                                      max_frames=16,
                                      offload_ticks=False) as srv:
            h1 = await srv.stream(want_partials=True)
            await h1.send(feats[3][:2])
            first = await h1.__anext__()
            assert first.t0 == 0
            h2 = await srv.stream(feats[0], want_partials=False)
            h2.close()
            await h2.admitted.wait()
            assert srv.n_connected == 2
            await h1.send(feats[3][2:])
            h1.close()
            parts = [first] + [p async for p in h1]
            return parts, await h1.result(), await h2.result()

    parts, r1, r2 = asyncio.run(run())
    np.testing.assert_array_equal(np.concatenate([p.rows for p in parts]),
                                  r1.logits)
    np.testing.assert_allclose(r1.logits, refs[3], atol=TOL)
    np.testing.assert_allclose(r2.logits, refs[0], atol=TOL)


def test_async_cancellation_mid_utterance(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=1, chunk_frames=4,
                                      max_frames=16,
                                      offload_ticks=False) as srv:
            victim = await srv.stream(feats[1][:4], want_partials=True)
            await victim.admitted.wait()
            survivor_task = asyncio.create_task(srv.submit(feats[2]))
            await asyncio.sleep(0.01)
            assert not survivor_task.done()
            victim.cancel()
            with pytest.raises(asyncio.CancelledError):
                await victim.result()
            with pytest.raises(StreamClosed):
                await victim.send(feats[1][4:6])
            survivor = await survivor_task
            return survivor, srv.pool.n_active

    survivor, n_active = asyncio.run(run())
    np.testing.assert_allclose(survivor.logits, refs[2], atol=TOL)
    assert n_active == 0


def test_async_backpressure_bounds_admission_queue(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=1, chunk_frames=4,
                                      max_frames=16, max_pending=1,
                                      offload_ticks=False) as srv:
            h1 = await srv.stream(feats[0])
            await h1.admitted.wait()
            h2 = await srv.stream(feats[2])
            h2.close()
            opened3 = asyncio.Event()

            async def third():
                h3 = await srv.stream(feats[4])
                opened3.set()
                h3.close()
                return await h3.result()

            t3 = asyncio.create_task(third())
            await asyncio.sleep(0.02)
            assert not opened3.is_set()
            h1.close()
            r1 = await h1.result()
            r2 = await h2.result()
            r3 = await t3
            assert opened3.is_set()
            return r1, r2, r3

    r1, r2, r3 = asyncio.run(run())
    np.testing.assert_allclose(r1.logits, refs[0], atol=TOL)
    np.testing.assert_allclose(r2.logits, refs[2], atol=TOL)
    np.testing.assert_allclose(r3.logits, refs[4], atol=TOL)
    assert 0 < r3.queue_wait_s <= r3.wall_latency_s + 1e-9


def test_async_submit_stream_iterator(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def blocks(f):
        for j in range(0, len(f), 3):
            yield f[j:j + 3]
            await asyncio.sleep(0)

    async def run():
        async with AsyncSpartusServer(eb, capacity=2, chunk_frames=4,
                                      max_frames=16,
                                      offload_ticks=False) as srv:
            handles = [await srv.submit_stream(blocks(feats[i]))
                       for i in (1, 5)]
            return await asyncio.gather(*[h.result() for h in handles])

    r1, r5 = asyncio.run(run())
    np.testing.assert_allclose(r1.logits, refs[1], atol=TOL)
    np.testing.assert_allclose(r5.logits, refs[5], atol=TOL)


def test_async_offloaded_ticks_parity(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=2, chunk_frames=4,
                                      max_frames=16,
                                      offload_ticks=True) as srv:
            return await asyncio.gather(
                *[srv.submit(feats[i]) for i in range(4)])

    for i, r in enumerate(asyncio.run(run())):
        np.testing.assert_allclose(r.logits, refs[i], atol=TOL)


def test_async_bad_request_fails_only_itself(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=2, chunk_frames=4,
                                      max_frames=16, max_buffer_frames=32,
                                      offload_ticks=False) as srv:
            with pytest.raises(ValueError, match="feature dim"):
                await srv.submit(np.zeros((4, INPUT_DIM + 3), np.float32))
            with pytest.raises(ValueError, match="growth limit"):
                await srv.submit(np.zeros((100, INPUT_DIM), np.float32))
            h = await srv.stream(feats[0][:2])
            with pytest.raises(ValueError, match="feature dim"):
                await h.send(np.zeros((2, 5), np.float32))
            h.cancel()
            return await srv.submit(feats[2])

    survivor = asyncio.run(run())
    np.testing.assert_allclose(survivor.logits, refs[2], atol=TOL)
    assert survivor.logits.shape[0] == LENS[2]


def test_async_stats_total_steps_counts_dispatching_ticks(engines, workload):
    _, eb = engines
    feats, _ = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=2, chunk_frames=4,
                                      max_frames=16,
                                      offload_ticks=False) as srv:
            await asyncio.gather(srv.submit(feats[0]), srv.submit(feats[2]))
            return srv.stats()

    stats = asyncio.run(run())
    assert stats.total_frames == LENS[0] + LENS[2]
    assert stats.total_steps == max(LENS[0], LENS[2])


def test_async_slow_consumer_bounded_queue(engines):
    e1, eb = engines
    bound = 3
    a_feats = _utterance(400, 10)
    b_feats = _utterance(401, 48)
    a_ref, b_ref = _run1(e1, a_feats), _run1(e1, b_feats)

    async def run():
        async with AsyncSpartusServer(
                eb, capacity=2, chunk_frames=2, max_frames=64,
                partial_queue_len=bound, offload_ticks=False) as srv:
            hb = await srv.stream(b_feats[:4], want_partials=True)
            qsizes, mid_parts = [], []

            async def feeder():
                for j in range(4, 48, 4):
                    await hb.send(b_feats[j:j + 4])
                    await asyncio.sleep(0.002)
                    qsizes.append(hb._partials.qsize())
                    if j == 24:
                        mid_parts.append(await hb.__anext__())
                        mid_parts.append(await hb.__anext__())
                hb.close()

            ra, _ = await asyncio.gather(srv.submit(a_feats), feeder())
            rb = await hb.result()
            tail = [p async for p in hb]
            return ra, rb, mid_parts + tail, qsizes

    ra, rb, parts, qsizes = asyncio.run(run())
    assert max(qsizes) == bound
    np.testing.assert_allclose(ra.logits, a_ref, atol=TOL)
    np.testing.assert_allclose(rb.logits, b_ref, atol=TOL)
    assert [p.t0 for p in parts] == sorted(p.t0 for p in parts)
    streamed = np.concatenate([p.rows for p in parts])
    assert streamed.shape[0] == 48
    np.testing.assert_array_equal(streamed, rb.logits)
    assert max(p.rows.shape[0] for p in parts) > 2


def test_async_loop_thread_never_waits_on_the_device(engines, monkeypatch):
    """With ``offload_ticks`` every wait on a staged copy runs in the
    tick worker, never on the event loop: a slow consumer's backfill is
    staged by the loop and resolved by the next tick, and ``stats()``
    reads the telemetry the pool staged.  Nor does serving code fetch an
    unstaged tensor on the loop (``.cpu()``/``.item()``/``.tolist()``/
    ``.numpy()``).  The backfilled stream is still the result bit for
    bit, and the final ``stats()`` sparsity is ``measured_sparsity``'s."""
    import sys
    import threading

    import torch

    from repro_torch._device import HostCopy

    e1, eb = engines
    feats = _utterance(410, 48)
    ref = _run1(e1, feats)
    loop_thread = threading.current_thread()
    waits, fetches, staged = [], [], []

    def asker():
        f = sys._getframe(2)
        while f is not None and f.f_globals.get("__name__") in (
                __name__, "repro_torch._device"):
            f = f.f_back
        return "" if f is None else f.f_globals.get("__name__", "")

    wait, init = HostCopy.wait, HostCopy.__init__

    def recorded_wait(copy):
        waits.append(threading.current_thread())
        return wait(copy)

    def staging_init(copy, *tensors):
        init(copy, *tensors)
        staged.extend(copy.host)

    def reader(orig, name):
        def f(t, *a, **k):
            if asker().startswith("repro_torch.serving") and not any(
                    t is h for h in staged):
                fetches.append((name, threading.current_thread()))
            return orig(t, *a, **k)
        return f

    async def run():
        async with AsyncSpartusServer(
                eb, capacity=2, chunk_frames=2, max_frames=64,
                partial_queue_len=3, offload_ticks=True) as srv:
            h = await srv.stream(want_partials=True)
            for j in range(0, 48, 4):
                await h.send(feats[j:j + 4])
                await asyncio.sleep(0.001)
            for _ in range(5000):
                if h.req_id in srv._lagging and srv.pool.max_chunk_advance() \
                        == 0 and not srv.pool.has_pending:
                    break
                await asyncio.sleep(0.002)
            assert h.req_id in srv._lagging
            mid = srv.stats()
            parts = [await h.__anext__() for _ in range(2)]
            for _ in range(5000):
                if h._partials.qsize() > 1:
                    break
                await asyncio.sleep(0.002)
            h.close()
            parts += [p async for p in h]
            return parts, await h.result(), mid, srv

    with monkeypatch.context() as mp:
        mp.setattr(HostCopy, "wait", recorded_wait)
        mp.setattr(HostCopy, "__init__", staging_init)
        for name in ("cpu", "item", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name,
                       reader(getattr(torch.Tensor, name), name))
        parts, result, mid, srv = asyncio.run(run())
        final = srv.stats()
    assert waits and all(t is not loop_thread for t in waits)
    assert all(t.name.startswith("spartus-tick") for t in waits)
    assert not [f for f in fetches if f[1] is loop_thread], fetches
    np.testing.assert_allclose(result.logits, ref, atol=TOL)
    assert [p.t0 for p in parts] == list(np.cumsum(
        [0] + [p.rows.shape[0] for p in parts[:-1]]))
    np.testing.assert_array_equal(np.concatenate([p.rows for p in parts]),
                                  result.logits)
    assert max(p.rows.shape[0] for p in parts) > 2       # the backfill
    assert 0 < mid.sparsity["temporal_sparsity"]
    assert final.sparsity == srv.pool.measured_sparsity()


def test_async_cancel_in_retirement_window(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def attempt(srv):
        h = await srv.stream(feats[1], want_partials=True)
        h.close()
        for _ in range(10_000):
            if h.req_id not in srv.pool._by_req:
                break
            await asyncio.sleep(0)
        if h._result.done():
            return None
        h.cancel()
        with pytest.raises(asyncio.CancelledError):
            await h.result()
        return [p async for p in h]

    async def run():
        async with AsyncSpartusServer(eb, capacity=1, chunk_frames=4,
                                      max_frames=16,
                                      offload_ticks=False) as srv:
            caught, misses = None, 0
            for _ in range(25):
                caught = await attempt(srv)
                if caught is not None:
                    break
                misses += 1
            survivor = await srv.submit(feats[2])
            return caught, misses, survivor, srv.stats(), \
                len(srv._completed)

    caught, misses, survivor, stats, n_completed = asyncio.run(run())
    assert caught is not None, "never caught the retirement window"
    np.testing.assert_allclose(survivor.logits, refs[2], atol=TOL)
    assert n_completed == misses + 1
    assert stats.n_requests == misses + 1
    assert stats.total_frames == misses * LENS[1] + LENS[2]


def test_async_wall_clock_pacing(engines, workload):
    _, eb = engines
    feats, refs = workload

    async def run():
        async with AsyncSpartusServer(eb, capacity=1, chunk_frames=4,
                                      max_frames=16, target_chunk_ms=30.0,
                                      offload_ticks=False) as srv:
            t0 = time.perf_counter()
            r = await srv.submit(feats[3])
            return r, time.perf_counter() - t0

    r, wall = asyncio.run(run())
    np.testing.assert_allclose(r.logits, refs[3], atol=TOL)
    assert wall >= 0.06


def test_async_rejects_multi_gpu_sharding(engines, workload):
    """More shards than visible devices raises the overcommit error; on
    two emulated devices the server streams the oracle logits."""
    _, eb = engines
    feats, refs = workload
    with pytest.raises(ValueError, match="visible"):
        AsyncSpartusServer(eb, capacity=2, chunk_frames=4, n_devices=2)

    async def run():
        async with AsyncSpartusServer(eb, capacity=4, chunk_frames=4,
                                      max_frames=16, offload_ticks=False,
                                      n_devices=2) as srv:
            assert srv.pool.n_shards == 2
            return await asyncio.gather(*[srv.submit(f) for f in feats])

    with emulated_devices(2):
        results = asyncio.run(run())
    for r, ref in zip(results, refs):
        np.testing.assert_allclose(r.logits, ref, atol=TOL)


# -- both packages on one workload -------------------------------------------


def _drip_workload(server_cls, eb, feats, seed):
    """Every utterance drip-fed in seeded 1..5-frame blocks by concurrent
    clients; returns [(partials, result)] in client order."""

    async def client(srv, f, rng):
        h = await srv.stream(want_partials=True)
        j = 0
        while j < len(f):
            n = int(rng.integers(1, 6))
            await h.send(f[j:j + n])
            j += n
            await asyncio.sleep(0)
        h.close()
        parts = [p async for p in h]
        return parts, await h.result()

    async def run():
        async with server_cls(eb, 3, chunk_frames=4, max_frames=16,
                              offload_ticks=True) as srv:
            return await asyncio.gather(*[
                client(srv, f, np.random.default_rng(seed + i))
                for i, f in enumerate(feats)])

    return asyncio.run(run())


def test_both_packages_serve_one_workload(model):
    params, jcfg, tparams, tcfg = model
    kw = dict(theta=THETA, gamma=GAMMA, m=M, capacity_frac=1.0)
    jeb = JBatched(params, jcfg, JConfig(**kw))
    teb = BatchedSpartusEngine(tparams, tcfg, EngineConfig(**kw),
                               device="cpu")
    feats = [_utterance(500 + i, t) for i, t in
             enumerate([13, 6, 21, 2, 9])]
    ref = _drip_workload(JAsyncServer, jeb, feats, seed=11)
    port = _drip_workload(AsyncSpartusServer, teb, feats, seed=11)
    for f, (jparts, jres), (tparts, tres) in zip(feats, ref, port):
        assert tres.logits.shape == (len(f), CLASSES)
        np.testing.assert_array_equal(
            np.concatenate([p.rows for p in tparts]), tres.logits)
        np.testing.assert_allclose(tres.logits, np.asarray(jres.logits),
                                   atol=TOL)
        np.testing.assert_allclose(
            np.concatenate([p.rows for p in tparts]),
            np.concatenate([np.asarray(p.rows) for p in jparts]), atol=TOL)
