"""Decode service tests (in-process server on an ephemeral port)."""

import threading

import numpy as np
import pytest

from hvqm4_jax import serve
from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip

from .conftest import golden_decode


# assurance tier: serving-surface integration (sockets, batching) (docs/TESTING.md)
pytestmark = pytest.mark.assurance

@pytest.fixture(scope="module")
def server():
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()


def test_serve_yuv_bitexact(server):
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB"], seed=91)
    host, port = server
    chunks = serve.decode_remote(host, port, clip, mode=serve.MODE_YUV)
    want = [f.tobytes() for f in golden_decode(cfg, clip)]
    assert chunks == want


def test_serve_rgb_shapes(server):
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I"], seed=92)
    host, port = server
    chunks = serve.decode_remote(host, port, clip, mode=serve.MODE_RGB)
    assert len(chunks) == 1
    rgb = np.frombuffer(chunks[0], np.uint8).reshape(48, 64, 3)
    assert rgb.shape == (48, 64, 3)


def test_serve_error_response(server):
    host, port = server
    with pytest.raises(RuntimeError, match="server error"):
        serve.decode_remote(host, port, b"garbage garbage garbage")
    # the server must keep serving after an error
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I"], seed=93)
    assert serve.decode_remote(host, port, clip, mode=serve.MODE_YUV)


def test_serve_rejects_oversized(server):
    host, port = server
    srv_max = 256 << 20
    # craft a header that CLAIMS an oversized clip without sending it
    import socket
    import struct

    with socket.create_connection((host, port), timeout=30) as s:
        s.sendall(serve.MAGIC_Q + struct.pack("<II", 0, srv_max + 1))
        head = s.recv(12)
        assert head[:4] == serve.MAGIC_R
        status, _n = struct.unpack("<II", head[4:])
        assert status == 1


def test_serve_embeddings_mode():
    import struct

    from hvqm4_jax.models.vit import ViTConfig

    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             vit_cfg=ViTConfig(image_size=32, patch_size=8,
                                               dim=64, depth=1, heads=2))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["IP"], seed=94)
        host, port = srv.server_address
        chunks = serve.decode_remote(host, port, clip, mode=serve.MODE_EMBED)
        assert len(chunks) == 2
        emb = np.frombuffer(chunks[0], "<f4")
        assert emb.shape == (64,) and np.isfinite(emb).all()
    finally:
        srv.shutdown()


def test_serve_continuous_batching():
    """Concurrent same-shape requests coalesce into ONE multi-stream batch;
    a corrupt clip fails alone without harming its batchmates."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=95 + i) for i in range(3)]
    bad = make_clip(cfg, ["IPB"], seed=99)[:-30]  # truncated container
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="jax",
                             batch_window_s=0.25, max_batch=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    try:
        results, errs = {}, {}

        def req(i, clip):
            try:
                results[i] = serve.decode_remote(host, port, clip)
            except Exception as e:  # noqa: BLE001 - assert on it below
                errs[i] = str(e)

        threads = [threading.Thread(target=req, args=(i, c))
                   for i, c in enumerate(clips + [bad])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        for i, c in enumerate(clips):
            assert results[i] == [f.tobytes() for f in golden_decode(cfg, c)], i
        assert 3 in errs  # the corrupt clip failed...
        m = serve.fetch_metrics(host, port)
        assert m["batched_requests"] == 3  # ...while the rest decoded fine
        # coalescing must actually happen: 3 requests in fewer batches
        # (the first may dispatch alone; the rest arrive while it decodes)
        assert 1 <= m["batches"] <= 2, m
    finally:
        srv.shutdown()


def test_serve_metrics(server):
    host, port = server
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IP"], seed=94)
    serve.decode_remote(host, port, clip, mode=serve.MODE_YUV)
    m = serve.fetch_metrics(host, port)
    assert m["requests_total"] >= 1
    assert m["frames_served"] >= 2
    assert m["by_mode"]["yuv"] >= 1
    assert m["uptime_s"] > 0
    assert "latency_avg_s" in m


def test_serve_auth():
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             auth_token="sekrit")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["I"], seed=95)
        with pytest.raises(PermissionError):
            serve.decode_remote(host, port, clip)
        with pytest.raises(PermissionError):
            serve.decode_remote(host, port, clip, token="wrong")
        want = [f.tobytes() for f in golden_decode(cfg, clip)]
        got = serve.decode_remote(host, port, clip, token="sekrit")
        assert got == want
        assert serve.fetch_metrics(host, port, token="sekrit")[
            "auth_failures"] == 2
    finally:
        srv.shutdown()


def test_serve_rejects_huge_dimensions():
    """An untrusted header declaring giant frames is rejected before any
    shape-keyed allocation or compilation happens."""
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             max_pixels=64 * 48)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        ok_clip = make_clip(SeqConfig(64, 48), ["I"], seed=97)
        assert serve.decode_remote(host, port, ok_clip)
        big_clip = make_clip(SeqConfig(128, 96), ["I"], seed=97)
        with pytest.raises(RuntimeError, match="pixel cap"):
            serve.decode_remote(host, port, big_clip)
    finally:
        srv.shutdown()


def test_serve_session_lru_eviction():
    """Distinct sequence shapes must not grow the session cache without
    bound; least-recently-used shapes are evicted."""
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        for w, h in [(32, 32), (64, 48), (32, 48), (64, 32)]:
            clip = make_clip(SeqConfig(w, h), ["I"], seed=98)
            assert serve.decode_remote(host, port, clip)
            assert len(srv._sessions) <= 2  # noqa: SLF001
        # most recent shape is still cached and serves correctly
        clip = make_clip(SeqConfig(64, 32), ["I"], seed=99)
        assert serve.decode_remote(host, port, clip)
    finally:
        srv.shutdown()


def test_serve_mux_pipelined_out_of_order(server):
    """One connection, several pipelined clips; results retrievable in any
    order and each bit-exact. A garbage clip fails only its own req_id and
    the session keeps serving."""
    host, port = server
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=120 + i) for i in range(3)]
    with serve.MuxClient(host, port) as mc:
        ids = [mc.submit(c) for c in clips]
        bad_id = mc.submit(b"not a container at all")
        for i, rid in reversed(list(enumerate(ids))):  # out-of-order reads
            got = mc.result(rid, timeout=120)
            assert got == [f.tobytes() for f in golden_decode(cfg, clips[i])]
        with pytest.raises(RuntimeError, match="server error"):
            mc.result(bad_id, timeout=120)
        # session survives the failed request
        extra = make_clip(cfg, ["I"], seed=124)
        assert mc.decode(extra, timeout=120) == [
            f.tobytes() for f in golden_decode(cfg, extra)]
    m = serve.fetch_metrics(host, port)
    assert m["mux_sessions"] >= 1
    assert m["mux_requests"] >= 4


def test_serve_mux_auth():
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             auth_token="sekrit")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["I"], seed=125)
        with serve.MuxClient(host, port, token="wrong") as mc:
            # the server replies GOODBYE/STATUS_AUTH and closes right away;
            # depending on timing the reader files PermissionError before
            # submit() runs (submit re-raises it) or the closed socket
            # resets mid-send — so submit() sits inside the raises block too
            with pytest.raises((PermissionError, ConnectionError, OSError)):
                rid = mc.submit(clip)
                mc.result(rid, timeout=30)
        with serve.MuxClient(host, port, token="sekrit") as mc:
            assert mc.decode(clip, timeout=60) == [
                f.tobytes() for f in golden_decode(cfg, clip)]
    finally:
        srv.shutdown()


def test_serve_mux_batching_coalesces():
    """Concurrent submissions from ONE mux connection coalesce into one
    device batch when batching is on (the mux path feeds decode_batched)."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IP"], seed=130 + i) for i in range(3)]
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="jax",
                             batch_window_s=0.25, max_batch=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        with serve.MuxClient(host, port) as mc:
            ids = [mc.submit(c) for c in clips]
            for i, rid in enumerate(ids):
                got = mc.result(rid, timeout=180)
                assert got == [f.tobytes()
                               for f in golden_decode(cfg, clips[i])], i
        m = serve.fetch_metrics(host, port)
        assert m["batched_requests"] == 3
        assert 1 <= m["batches"] <= 2, m
    finally:
        srv.shutdown()


def test_serve_protocol_fuzz(server):
    """Garbage, truncated, or adversarial wire bytes must never kill or
    wedge the server: every connection ends with an error reply or a clean
    close, and a valid request still succeeds afterwards."""
    import random
    import socket
    import struct

    host, port = server
    rng = random.Random(0xF00D)
    payloads = [
        b"",                                          # connect-and-close
        b"XXXX",                                      # bad magic
        serve.MAGIC_A + struct.pack("<I", 4096),      # oversized token decl
        serve.MAGIC_Q + struct.pack("<I", 0),         # truncated header
        serve.MAGIC_Q + struct.pack("<II", 99, 4) + b"abcd",       # bad mode
        serve.MAGIC_Q + struct.pack("<II", 0, 2**31 - 1),  # huge clip decl
        serve.MAGIC_X + struct.pack("<I", 2**31 - 1),  # huge mux token decl
        serve.MAGIC_X + struct.pack("<I", 0)           # mux clip too large
        + struct.pack("<III", 1, 0, 2**31 - 1),
        serve.MAGIC_X + struct.pack("<I", 0)           # truncated mux body
        + struct.pack("<III", 1, 0, 100) + b"short",
    ] + [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))
         for _ in range(10)]
    for pl in payloads:
        with socket.create_connection((host, port), timeout=30) as s:
            s.sendall(pl)
            try:
                s.shutdown(socket.SHUT_WR)  # EOF: server must not wait forever
            except OSError:
                pass  # server already closed on us — also a clean outcome
            s.settimeout(30)
            try:
                while s.recv(4096):  # drain any reply until close; no hang
                    pass
            except OSError:
                pass
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I"], seed=140)
    assert serve.decode_remote(host, port, clip) == [
        f.tobytes() for f in golden_decode(cfg, clip)]


def test_serve_metrics_prometheus(server):
    host, port = server
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I"], seed=126)
    serve.decode_remote(host, port, clip)
    (raw,) = serve.decode_remote(host, port, b"",
                                 mode=serve.MODE_METRICS_PROM)
    text = raw.decode()
    assert "# TYPE hvqm4_serve_requests_total counter" in text
    assert "hvqm4_serve_frames_served_total " in text
    assert 'hvqm4_serve_requests_by_mode_total{mode="yuv"}' in text
    assert "# TYPE hvqm4_serve_uptime_s gauge" in text
    # every sample line parses as "name[{labels}] value"
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, val = line.rsplit(" ", 1)
        assert name and float(val) >= 0


def test_serve_busy_shedding():
    """With max_pending=0, a request arriving while one is active is shed
    with status=busy instead of queueing."""
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             max_pending=0)
    # make decode slow and controllable
    gate = threading.Event()
    orig = srv.decode

    def slow(clip, mode):
        gate.wait(timeout=30)
        return orig(clip, mode)

    srv.decode = slow
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["I"], seed=96)
        results = {}

        def first():
            results["first"] = serve.decode_remote(host, port, clip)

        t1 = threading.Thread(target=first)
        t1.start()
        # wait until the first request holds the admission slot
        for _ in range(200):
            if srv.admission._value == 0:  # noqa: SLF001 - test introspection
                break
            import time
            time.sleep(0.01)
        with pytest.raises(serve.BusyError):
            serve.decode_remote(host, port, clip)
        gate.set()
        t1.join(timeout=30)
        assert "first" in results  # the admitted request completed fine
        assert serve.fetch_metrics(host, port)["busy_rejections"] == 1
    finally:
        gate.set()
        srv.shutdown()


def test_serve_mux_idle_timeout_clean_close():
    """An idle mux session past socket_timeout_s must end with a clean
    server-side close — NOT an injected single-shot (H4MR) error frame,
    which would desync the client's H4MS reader — and must not count as a
    server error."""
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             socket_timeout_s=0.5)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["I"], seed=140)
        mc = serve.MuxClient(host, port)
        assert mc.decode(clip, timeout=60) == [
            f.tobytes() for f in golden_decode(cfg, clip)]
        # idle past the server's socket timeout: the session reader times
        # out and the server closes; the client sees EOF (ConnectionError),
        # never a bad-magic ValueError from a stray H4MR frame
        mc._reader.join(timeout=10)
        assert not mc._reader.is_alive()
        assert isinstance(mc._reader_exc, (ConnectionError, OSError))
        assert not isinstance(mc._reader_exc, ValueError)
        mc._sock.close()
        assert serve.fetch_metrics(host, port)["errors"] == 0
    finally:
        srv.shutdown()


def test_serve_mux_slow_request_keeps_session_open():
    """A request that decodes for longer than socket_timeout_s (as a cold
    server compiles for minutes) is not idleness: the session must stay
    open, and a request the client sends after that reply still succeeds."""
    import time

    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy",
                             socket_timeout_s=0.5)
    orig = srv.decode
    calls = []

    def slow_first(clip, mode):
        calls.append(mode)
        if len(calls) == 1:
            time.sleep(1.5)  # three idle limits
        return orig(clip, mode)

    srv.decode = slow_first
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["IP"], seed=142)
        want = [f.tobytes() for f in golden_decode(cfg, clip)]
        with serve.MuxClient(host, port) as mc:
            assert mc.decode(clip, timeout=60) == want
            assert mc.decode(clip, timeout=60) == want
        assert len(calls) == 2
        assert serve.fetch_metrics(host, port)["errors"] == 0
    finally:
        srv.shutdown()


def test_serve_mux_close_drains_inflight():
    """close() right after pipelined submits must let the server drain and
    reply (goodbye + wait for server EOF), not RST the socket — the server
    records zero errors and all requests as served."""
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        cfg = SeqConfig(64, 48)
        clip = make_clip(cfg, ["IP"], seed=141)
        with serve.MuxClient(host, port) as mc:
            for _ in range(3):
                mc.submit(clip)
            # no result() calls: __exit__ sends goodbye and drains
        m = serve.fetch_metrics(host, port)
        assert m["errors"] == 0
        assert m["mux_requests"] == 3
        assert m["requests_total"] >= 3  # all three decoded and replied
    finally:
        srv.shutdown()


def test_raise_for_status_tolerates_chunkless_errors():
    """A hostile/buggy peer may send a non-OK status with zero chunks; the
    client must raise the TYPED error, not IndexError."""
    with pytest.raises(serve.BusyError):
        serve._raise_for_status(serve.STATUS_BUSY, [])
    with pytest.raises(PermissionError):
        serve._raise_for_status(serve.STATUS_AUTH, [])
    with pytest.raises(RuntimeError, match="no detail"):
        serve._raise_for_status(serve.STATUS_ERROR, [])
    # invalid UTF-8 in the detail chunk must not raise UnicodeDecodeError
    with pytest.raises(RuntimeError):
        serve._raise_for_status(serve.STATUS_ERROR, [b"\xff\xfe bad"])
    assert serve._raise_for_status(serve.STATUS_OK, [b"x"]) == [b"x"]
