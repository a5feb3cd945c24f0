"""Port parity, the launcher: repro_torch.launch.serve's JSON-lines TCP
protocol and admin endpoint on the CPU, against the JAX package's
launcher on the same conversation.

In process, both packages' ``handle_conn`` serve their own
AsyncSpartusServer (D=20, H=32 model, weights moved across as numpy)
over a localhost socket; the replies must carry the same events, codes
and keys, and the port's streamed logits equal its own results bit for
bit and the reference's within 1e-5.  One subprocess runs the launcher
end to end with ``--device cpu --hidden 32``.
"""
import asyncio
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.launch import serve as jlaunch
from repro.models import lstm_am as jam
from repro.serving import AsyncSpartusServer as JServer
from repro.serving import BatchedSpartusEngine as JBatched
from repro.serving import EngineConfig as JConfig
from repro.serving import PoolObservability as JObs
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.mesh import emulated_devices
from repro_torch.models import lstm_am as tam
from repro_torch.serving import AsyncSpartusServer as TServer
from repro_torch.serving import BatchedSpartusEngine as TBatched
from repro_torch.serving import EngineConfig as TConfig
from repro_torch.serving import PoolObservability as TObs
from repro_torch.serving.metrics import KERNEL_FIELDS, KERNELS

REPO = Path(__file__).resolve().parents[1]
INPUT_DIM, HIDDEN, CLASSES = 20, 32, 11
KW = dict(theta=0.05, gamma=0.75, m=4, capacity_frac=1.0)


@pytest.fixture(scope="module")
def engines():
    jcfg = jam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    tcfg = tam.LSTMAMConfig(input_dim=INPUT_DIM, hidden_dim=HIDDEN,
                            n_layers=2, n_classes=CLASSES)
    params = jam.cbtd_prune_stacks(jam.init_params(jax.random.key(0), jcfg),
                                   gamma=0.75, m=4)
    tparams = tam.params_from_numpy(jax.device_get(params), device="cpu")
    return (JBatched(params, jcfg, JConfig(**KW)),
            TBatched(tparams, tcfg, TConfig(**KW), device="cpu"))


def _feats(seed, t):
    return np.random.default_rng(seed).standard_normal(
        (t, INPUT_DIM)).astype(np.float32)


async def _ask(reader, writer, launch, obj):
    if isinstance(obj, bytes):
        writer.write(obj)
    else:
        launch.jline(writer, obj)
    await writer.drain()
    return json.loads(await reader.readline())


async def _read_until_done(reader):
    rows, events = [], []
    while True:
        msg = json.loads(await reader.readline())
        events.append(msg)
        if msg["event"] == "partial":
            rows.append(np.asarray(msg["logits"], np.float32))
        if msg["event"] in ("done", "cancelled", "error"):
            return events, rows


def _conversation(launch, server_cls, obs_cls, engine):
    """One scripted session of the protocol: returns every reply plus
    the logits streamed for the two completed streams."""
    feats = [_feats(1, 11), _feats(2, 6)]

    async def run():
        obs = obs_cls()
        async with server_cls(engine, 2, chunk_frames=4, max_frames=16,
                              offload_ticks=True,
                              observability=obs) as srv:
            tcp = await asyncio.start_server(
                lambda r, w: launch.handle_conn(srv, r, w), "127.0.0.1", 0,
                limit=launch.MAX_LINE_BYTES)
            port = tcp.sockets[0].getsockname()[1]
            admin = await launch.start_admin_server(srv, obs, port=0)
            aport = admin.sockets[0].getsockname()[1]
            r, w = await asyncio.open_connection("127.0.0.1", port)
            replies = []
            for raw in (b"this is not json\n", b"[1, 2]\n",
                        b'{"op": "detonate", "id": 1}\n',
                        b'{"op": "frames", "id": 1, "frames": [[0.0]]}\n',
                        b'{"op": "close", "id": 3}\n'):
                replies.append(await _ask(r, w, launch, raw))
            replies.append(await _ask(r, w, launch, {"op": "open", "id": 0}))
            replies.append(await _ask(r, w, launch, {"op": "open", "id": 0}))
            replies.append(await _ask(
                r, w, launch, {"op": "frames", "id": 0,
                               "frames": [[float("nan")] * INPUT_DIM]}))
            streams = []
            for cid, f in enumerate(feats):
                if cid:
                    replies.append(await _ask(r, w, launch,
                                              {"op": "open", "id": cid}))
                for j in range(0, len(f), 3):
                    launch.jline(w, {"op": "frames", "id": cid,
                                     "frames": f[j:j + 3].tolist()})
                launch.jline(w, {"op": "close", "id": cid})
                await w.drain()
                events, rows = await _read_until_done(r)
                replies += events
                streams.append(np.concatenate(rows))
            # cancel mid-utterance
            replies.append(await _ask(r, w, launch, {"op": "open", "id": 4}))
            launch.jline(w, {"op": "frames", "id": 4,
                             "frames": _feats(3, 2).tolist()})
            launch.jline(w, {"op": "cancel", "id": 4})
            await w.drain()
            events, _ = await _read_until_done(r)
            replies.append(events[-1])
            # admin endpoint, while the TCP connection is still up
            ar, aw = await asyncio.open_connection("127.0.0.1", aport)
            admin_replies = [await _ask(ar, aw, launch, cmd) for cmd in (
                {"cmd": "healthz"}, {"cmd": "stats"}, {"cmd": "metrics"},
                {"cmd": "timeseries", "last": 3}, {"cmd": "nope"}, [1])]
            aw.close()
            # an over-long line closes only this connection
            w.write(b'{"op": "open", "id": 9, "pad": "'
                    + b"x" * (launch.MAX_LINE_BYTES + 64) + b'"}\n')
            await w.drain()
            replies.append(json.loads(await r.readline()))
            closed = await r.readline()
            w.close()
            r2, w2 = await asyncio.open_connection("127.0.0.1", port)
            alive = await _ask(r2, w2, launch, {"op": "open", "id": 0})
            launch.jline(w2, {"op": "cancel", "id": 0})
            await w2.drain()
            await _read_until_done(r2)
            w2.close()
            admin.close()
            await admin.wait_closed()
            tcp.close()
            await tcp.wait_closed()
            results = {r_.req_id: r_.logits for r_ in srv._completed}
            return replies, admin_replies, streams, closed, alive, results

    return asyncio.run(run())


def _shape(msg):
    """A reply's protocol shape: its event/error code and its keys."""
    return (msg.get("event"), msg.get("code"), sorted(msg))


@pytest.fixture(scope="module")
def conversations(engines):
    jeb, teb = engines
    return (_conversation(jlaunch, JServer, JObs, jeb),
            _conversation(tlaunch, TServer, TObs, teb))


def test_protocol_replies_match_reference(conversations):
    (jrep, _, jstreams, _, _, _), (trep, _, tstreams, _, _, _) = \
        conversations

    def shapes(replies):
        # partial events vary in count with chunk timing; keep their shape
        out = []
        for m in replies:
            if m.get("event") == "partial" and out and out[-1][0] == "partial":
                continue
            out.append(_shape(m))
        return out

    assert shapes(trep) == shapes(jrep)
    codes = [m.get("code") for m in trep if m.get("event") == "error"]
    assert codes == ["bad_json", "bad_json", "unknown_op", "no_such_stream",
                     "no_such_stream", "duplicate_id", "bad_request",
                     "line_too_long"]
    assert all(m["retriable"] is False for m in trep
               if m.get("event") == "error")
    assert [m["event"] for m in trep if m.get("event") in
            ("done", "cancelled")] == ["done", "done", "cancelled"]
    for j, t in zip(jstreams, tstreams):
        np.testing.assert_allclose(t, j, atol=1e-5)


def test_streamed_logits_equal_results(conversations):
    _, (trep, _, tstreams, _, _, results) = conversations
    done = [m for m in trep if m.get("event") == "done"]
    assert [d["n_frames"] for d in done] == [11, 6]
    assert len(results) == 2
    for streamed, rid in zip(tstreams, sorted(results)):
        np.testing.assert_array_equal(streamed, results[rid])


def test_line_too_long_closes_only_that_connection(conversations):
    _, (trep, _, _, closed, alive, _) = conversations
    assert trep[-1]["code"] == "line_too_long"
    assert closed == b""
    assert alive == {"event": "open_ok", "id": 0}


def test_admin_commands_match_reference(conversations):
    """The reference's replies, metrics and sample keys, and besides them
    only the port's own: the pool engine's launch counters (four per
    layer), the tick's hand-off histogram, and the samples' clock, hand-off
    and counter increments."""
    (_, jadmin, *_), (_, tadmin, *_) = conversations
    assert [sorted(m) for m in tadmin] == [sorted(m) for m in jadmin]
    health, stats, metrics, ts, bad, not_obj = tadmin
    assert health["ok"] is True and health["capacity"] == 2
    assert sorted(stats["stats"]) == sorted(jadmin[1]["stats"])
    assert stats["stats"]["n_requests"] == 2
    counters = {m for m in metrics["metrics"]
                if m.startswith("spartus_kernel_")}
    assert len(counters) == len(KERNEL_FIELDS) * 2
    port_only = counters | {"spartus_tick_handoff_seconds"}
    assert sorted(set(metrics["metrics"]) - port_only) == \
        sorted(jadmin[2]["metrics"])
    assert port_only <= set(metrics["metrics"])
    assert "# TYPE spartus_frames_total counter" in metrics["prometheus"]
    assert 0 < len(ts["timeseries"]) <= 3 and ts["n_appended"] > 0
    sample_only = {"t_mono", "handoff_s"} | {
        f"{k}_{f}_inc" for k in KERNELS for f in KERNEL_FIELDS}
    assert sorted(set(ts["timeseries"][0]) - sample_only) == \
        sorted(jadmin[3]["timeseries"][0])
    assert sample_only <= set(ts["timeseries"][0])
    assert "error" in bad and "error" in not_obj


def test_demo_client_through_the_port(engines):
    _, teb = engines

    async def run():
        async with TServer(teb, 2, chunk_frames=4, max_frames=64,
                           offload_ticks=True) as srv:
            tcp = await asyncio.start_server(
                lambda r, w: tlaunch.handle_conn(srv, r, w), "127.0.0.1", 0,
                limit=tlaunch.MAX_LINE_BYTES)
            port = tcp.sockets[0].getsockname()[1]
            out = await asyncio.gather(*[
                tlaunch.demo_client(port, i, _feats(10 + i, 9 + 4 * i))
                for i in range(3)])
            tcp.close()
            await tcp.wait_closed()
            return out, tlaunch.stats_line(srv)

    out, line = asyncio.run(run())
    for cid, streamed, done in out:
        assert done["event"] == "done"
        assert streamed.shape == (9 + 4 * cid, CLASSES)
    assert line.startswith("[stats] occ 0/2")


def _launcher(*args, env=None):
    full_env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=full_env, capture_output=True, text=True, timeout=300)


def test_launcher_end_to_end_on_cpu():
    proc = _launcher("--spartus", "--async", "--device", "cpu",
                     "--hidden", "32", "--pool", "2", "--clients", "3",
                     "--chunk-frames", "8", "--admin-port", "0",
                     "--stats-interval", "0.05")
    assert proc.returncode == 0, proc.stderr
    assert "3 concurrent TCP clients served" in proc.stdout
    assert "admin endpoint on 127.0.0.1:" in proc.stdout
    assert "dispatch economy" in proc.stdout


@pytest.mark.parametrize("args,message", [
    (["--spartus", "--async", "--device", "cpu", "--pool", "4",
      "--devices", "2"], "serve: --devices 2: requested a 2-device mesh"),
    (["--spartus", "--device", "cpu", "--pool", "4", "--devices", "4"],
     "serve: --devices 4: requested a 4-device mesh"),
    (["--async"], "--async requires")])
def test_unported_modes_exit_with_their_roadmap_item(capsys, args, message):
    """Modes the launcher refuses: more ``--devices`` than are visible
    exit with the overcommit error as the exit message, and ``--async``
    without ``--spartus`` with a usage error (exit code 2)."""
    with pytest.raises(SystemExit) as ei:
        tlaunch.main(args)
    if ei.value.code == 2:
        assert message in capsys.readouterr().err
    else:
        assert str(ei.value.code).startswith(message)
        assert "visible" in str(ei.value.code)


def test_devices_shards_the_async_pool(capsys):
    """``--devices 2`` over two emulated host devices: the pool runs two
    shards and every client is served."""
    with emulated_devices(2):
        tlaunch.main(["--spartus", "--async", "--device", "cpu", "--hidden",
                      "32", "--pool", "4", "--clients", "3",
                      "--chunk-frames", "8", "--devices", "2"])
    out = capsys.readouterr().out
    assert "over 2 device(s): 2 shard(s)" in out
    assert "3 concurrent TCP clients served" in out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "pixtral-12b"])
def test_arch_mode_serves_on_cpu(capsys, arch):
    """The default mode: greedy decode of the reduced arch (the vlm arch
    feeds embeddings, not its argmax) and the reference's [serve] line."""
    tlaunch.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                  "--steps", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(rf"\[serve\] {arch}: 4 steps batch=2 -> "
                        rf"[0-9.]+ ms/token \([0-9.]+ tok/s\)", line), line
