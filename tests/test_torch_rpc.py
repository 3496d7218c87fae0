"""RPC transport tests (two regimes + the multiplexed path).

The twin of tests/test_rpc.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror)."""
import socket
import threading
import time

import pytest

from repro_torch.core.rpc import (_HDR, ClientReactor, InProcTransport,
                                  MuxServer, MuxTransport, ProtocolError,
                                  RPCError, RPCServer, SocketTransport,
                                  _decode_frame, _encode_frame, pack_json,
                                  unpack_json)


def test_frame_codec_roundtrip():
    m, p = _decode_frame(_encode_frame("match_grow", b"payload-bytes"))
    assert m == "match_grow" and p == b"payload-bytes"


def test_inproc_transport():
    t = InProcTransport(lambda m, p: (m + ":").encode() + p)
    assert t.call("x", b"abc") == b"x:abc"
    assert t.regime == "intranode"


def test_socket_transport_roundtrip():
    srv = RPCServer(lambda m, p: p[::-1])
    try:
        t = SocketTransport(srv.address)
        assert t.call("rev", b"abcdef") == b"fedcba"
        # larger payloads (multi-frame reads)
        big = bytes(range(256)) * 4096
        assert t.call("rev", big) == big[::-1]
        t.close()
    finally:
        srv.close()


def test_socket_transport_pools_connections():
    """Concurrent calls each get their own pooled connection (no
    serialization on one socket), the pool never exceeds its bound,
    and connections are reused across sequential calls."""
    import threading

    srv = RPCServer(lambda m, p: p[::-1])
    try:
        t = SocketTransport(srv.address, pool_size=2)
        try:
            results = {}

            def worker(i):
                payload = bytes([i]) * 1024
                results[i] = t.call("rev", payload) == payload[::-1]

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert all(results[i] for i in range(8))
            assert len(t._pool) <= 2        # surplus closed on check-in
            # sequential calls reuse the pooled connection
            before = t._pool[0]
            assert t.call("rev", b"ab") == b"ba"
            assert t._pool[0] is before
        finally:
            t.close()
    finally:
        srv.close()


def test_max_frame_enforced_on_client():
    """A corrupt/hostile length prefix from the server must raise a
    clean ProtocolError, never attempt the allocation."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)

    def evil_server():
        conn, _ = lst.accept()
        conn.recv(65536)                      # swallow the request
        conn.sendall(_HDR.pack(0xFFFFFFFF))   # 4 GiB "response"
        time.sleep(0.5)
        conn.close()

    th = threading.Thread(target=evil_server, daemon=True)
    th.start()
    t = SocketTransport(lst.getsockname(), max_frame=1 << 20)
    with pytest.raises(ProtocolError, match="exceeds max_frame"):
        t.call("x", b"hi")
    t.close()
    lst.close()
    th.join(timeout=2)


def test_max_frame_enforced_on_server():
    """A client announcing an oversized frame gets disconnected (both
    server implementations), not a multi-GiB buffer."""
    for srv in (RPCServer(lambda m, p: p, max_frame=1 << 16),
                MuxServer(lambda m, p: p, max_frame=1 << 16)):
        try:
            c = socket.create_connection(srv.address)
            c.sendall(_HDR.pack(1 << 24))     # 16 MiB > 64 KiB limit
            c.settimeout(2.0)
            assert c.recv(1) == b""           # server hung up
            c.close()
        finally:
            srv.close()


def test_mux_rejects_oversized_frame_from_server_push():
    """MuxTransport applies the same bound on its reader path."""
    srv = MuxServer(lambda m, p: b"x" * (1 << 18))
    try:
        t = MuxTransport(srv.address, max_frame=1 << 16)
        with pytest.raises((ProtocolError, ConnectionError)):
            t.call("big", b"")
        t.close()
    finally:
        srv.close()


def test_rpcserver_close_joins_all_sessions():
    """close() must unblock sessions parked in recv and join every
    session thread before returning — no lingering threads."""
    srv = RPCServer(lambda m, p: p)
    transports = [SocketTransport(srv.address) for _ in range(4)]
    for t in transports:
        assert t.call("echo", b"ok") == b"ok"
    with srv._lock:
        threads = [th for th, _ in srv._sessions.values()]
    assert len(threads) == 4 and all(th.is_alive() for th in threads)
    srv.close()
    assert all(not th.is_alive() for th in threads)
    assert not srv._thread.is_alive()
    for t in transports:
        t.close()


def test_rpcserver_backlog_configurable():
    srv = RPCServer(lambda m, p: p, backlog=64)
    try:
        t = SocketTransport(srv.address)
        assert t.call("x", b"y") == b"y"
        t.close()
    finally:
        srv.close()


def test_mid_frame_peer_close_client_side():
    """Server dies mid-response: the client surfaces ConnectionError
    instead of hanging or returning a short read."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)

    def half_server():
        conn, _ = lst.accept()
        conn.recv(65536)
        conn.sendall(_HDR.pack(1000) + b"x" * 10)   # 10 of 1000 bytes
        conn.close()

    th = threading.Thread(target=half_server, daemon=True)
    th.start()
    t = SocketTransport(lst.getsockname())
    with pytest.raises((ConnectionError, OSError)):
        t.call("x", b"req")
    t.close()
    lst.close()
    th.join(timeout=2)


def test_mid_frame_peer_close_server_side():
    """Client dies mid-request: both servers drop the session cleanly
    and keep serving other clients."""
    for srv in (RPCServer(lambda m, p: p), MuxServer(lambda m, p: p)):
        try:
            c = socket.create_connection(srv.address)
            frame = _encode_frame("x", b"y" * 100)
            c.sendall(_HDR.pack(len(frame)) + frame[:5])   # truncated
            c.close()
            t = SocketTransport(srv.address)
            assert t.call("ok", b"alive") == b"alive"
            t.close()
        finally:
            srv.close()


def test_mux_pipelined_out_of_order_correlation():
    """Responses land out of order (slow call issued first); the
    request-id correlation must route each to its caller."""
    def handler(method, payload):
        if method == "slow":
            time.sleep(0.2)
        return method.encode() + b":" + payload

    srv = MuxServer(handler, workers=4)
    try:
        t = MuxTransport(srv.address)
        results = {}

        def call(method, payload):
            results[method] = t.call(method, payload)

        slow = threading.Thread(target=call, args=("slow", b"a"))
        slow.start()
        time.sleep(0.05)            # slow call is in flight
        assert t.call("fast", b"b") == b"fast:b"   # overtakes it
        slow.join(timeout=2)
        assert results["slow"] == b"slow:a"
        # call_many pipelines a whole batch on one connection
        out = t.call_many([("m%d" % i, bytes([i])) for i in range(50)])
        assert out == [b"m%d:" % i + bytes([i]) for i in range(50)]
        t.close()
    finally:
        srv.close()


def test_mux_error_frame_raises_rpcerror():
    def handler(method, payload):
        raise ValueError("no such thing")
    srv = MuxServer(handler)
    try:
        t = MuxTransport(srv.address)
        with pytest.raises(RPCError, match="no such thing"):
            t.call("x", b"")
        # the connection survives an application error
        srv2_alive = True
        with pytest.raises(RPCError):
            t.call("y", b"")
        assert srv2_alive
        t.close()
    finally:
        srv.close()


def test_mux_eof_fails_pending_calls():
    """Server close fails every in-flight call promptly."""
    srv = MuxServer(lambda m, p: (time.sleep(1.5), p)[1])
    t = MuxTransport(srv.address)
    errs = []

    def call():
        try:
            t.call("hang", b"")
        except (ConnectionError, OSError) as e:
            errs.append(e)

    th = threading.Thread(target=call)
    th.start()
    time.sleep(0.1)
    srv.close()
    th.join(timeout=3)
    assert not th.is_alive() and len(errs) == 1
    t.close()


def test_client_reactor_services_many_transports():
    """Many MuxTransports share one reactor thread."""
    srv = MuxServer(lambda m, p: p[::-1])
    reactor = ClientReactor()
    try:
        ts = [MuxTransport(srv.address, reactor=reactor)
              for _ in range(16)]
        for i, t in enumerate(ts):
            assert t.call("rev", bytes([i]) * 8) == bytes([i]) * 8
        for t in ts:
            t.close()
    finally:
        reactor.close()
        srv.close()


def test_legacy_transport_against_mux_server():
    """The compatibility/oracle path: pooled blocking SocketTransport
    works unchanged against the multiplexed server."""
    srv = MuxServer(lambda m, p: p[::-1])
    try:
        t = SocketTransport(srv.address, pool_size=2)
        big = bytes(range(256)) * 4096
        assert t.call("rev", big) == big[::-1]
        results = {}

        def worker(i):
            payload = bytes([i]) * 512
            results[i] = t.call("rev", payload) == payload[::-1]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert all(results.values())
        t.close()
    finally:
        srv.close()


def test_mux_server_deterministic_close():
    srv = MuxServer(lambda m, p: p)
    t = MuxTransport(srv.address)
    assert t.call("x", b"1") == b"1"
    srv.close()
    assert not srv._loop_thread.is_alive()
    assert all(not w.is_alive() for w in srv._workers)
    t.close()


def test_json_helpers():
    d = {"jobspec": {"resources": [{"type": "core", "count": 4}]}}
    assert unpack_json(pack_json(d)) == d
    assert unpack_json(b"") == {}


def test_method_registry_dispatch():
    from repro_torch.core.rpc import MethodRegistry
    reg = MethodRegistry()
    reg.register("echo", lambda p: p)
    reg.register("rev", lambda p: p[::-1])
    assert "echo" in reg and reg.methods() == ("echo", "rev")
    assert reg("echo", b"x") == b"x"
    assert reg("rev", b"ab") == b"ba"
    with pytest.raises(ValueError, match="unknown RPC method"):
        reg("nope", b"")
    reg.unregister("rev")
    assert "rev" not in reg


def test_scheduler_registers_methods_and_extension():
    from repro_torch.core import SchedulerInstance, build_cluster
    from repro_torch.core.rpc import pack_json, unpack_json
    inst = SchedulerInstance("s", build_cluster(nodes=1, device="cpu"))
    assert {"match_grow", "release", "reclaim"} <= set(inst.methods.methods())
    inst.register_method(
        "status", lambda p: pack_json({"free": inst.graph.vertex(
            inst.graph.roots[0]).agg_free}))
    t = inst.inproc_transport()
    out = unpack_json(t.call("status", b""))
    assert out["free"]["core"] == 32
    with pytest.raises(ValueError):
        t.call("bogus", b"")
