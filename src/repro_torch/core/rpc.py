"""Parent-child RPC transport for subgraph exchange (paper Section 4).

The paper transmits JGF-encoded subgraphs between parent and child
scheduler instances via Flux RPC; communication has two regimes —
*intranode* (parent and child on the same node) and *internode* (levels
separated by IPoIB).  We reproduce both regimes:

* ``InProcTransport`` — "intranode": the call serializes the request and
  response through bytes (so serialization cost is real) but stays in
  process.
* ``SocketTransport`` — "internode": a loopback TCP socket with a
  length-prefixed frame protocol, pooled persistent connections, one
  in-flight call per connection.  Kept as the compatibility/oracle
  path: simple, blocking, strictly request/response.
* ``MuxTransport`` / ``MuxServer`` — the scaled internode path: a
  single-event-loop (selectors) server that multiplexes thousands of
  connections without a thread each, a framed protocol with a
  request id so one connection carries many in-flight pipelined calls
  (``call_many``), and server-push EVENT frames so a ``subscribe``
  stream delivers events without busy-polling.  The server speaks BOTH
  protocols — the first frame of a connection identifies it — so old
  ``SocketTransport`` clients work unchanged against the same port.

Wire format (both protocols): a 4-byte ``!I`` length prefix, then the
frame body, never larger than ``max_frame`` (a corrupt or hostile
header must not trigger an unbounded allocation — ``ProtocolError``).

Legacy body:  ``!I`` method-len, method, ``!I`` payload-len, payload;
responses are bare payloads, strictly in order.  The first body byte is
the high byte of the method length — always 0.

Mux body: first byte is a kind tag with the high bit set (which is how
the server tells the protocols apart):

* ``0x81 REQUEST``  — ``!BIH`` kind, request-id, method-len; method;
  payload.
* ``0x82 RESPONSE`` — ``!BI`` kind, request-id; payload.
* ``0x83 ERROR``    — ``!BI`` kind, request-id; utf-8 message
  (raised client-side as ``RPCError``).
* ``0x84 EVENT``    — ``!BII`` kind, stream-id, event-count; payload
  (server push on a stream opened by a stream verb; the stream id is
  the request id of the opening call).

Both paths carry (method, payload-bytes) and return payload bytes, so
the measured time is linear in the subgraph size n = |V|+|E|:
``t = n*beta + beta_0``.

Threading contract: no lock in this module may be held across a socket
send except the leaf ``_send_lock`` writer serialization — the rules,
and the lint/witness machinery enforcing them, are documented in
``docs/CONCURRENCY.md``.
"""
from __future__ import annotations

import collections
import json
import select
import selectors
import socket
import struct
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..analysis.lockwitness import named_lock, note_transport_call

Handler = Callable[[str, bytes], bytes]

_HDR = struct.Struct("!I")  # 4-byte length prefix

#: Upper bound on any frame body; a length prefix beyond this is a
#: protocol violation, not an allocation request.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_MUX_REQ = struct.Struct("!BIH")   # kind, request id, method length
_MUX_RSP = struct.Struct("!BI")    # kind, request id
_MUX_EVT = struct.Struct("!BII")   # kind, stream id, event count

KIND_REQUEST = 0x81
KIND_RESPONSE = 0x82
KIND_ERROR = 0x83
KIND_EVENT = 0x84

#: Reserved verb: closes a push stream previously opened on the same
#: connection (payload: ``{"stream": <id>}``).
UNSUBSCRIBE_METHOD = "unsubscribe"


class ProtocolError(ConnectionError):
    """The peer violated the frame protocol (oversized/garbled frame)."""


class RPCError(RuntimeError):
    """The server's handler raised; carries the remote error message."""


class MethodRegistry:
    """Named-method dispatch table for RPC servers.

    Scheduler instances (and extensions) register payload handlers under
    a method name; the registry itself is a ``Handler``, so it plugs
    into either transport regime unchanged.
    """

    def __init__(self) -> None:
        self._methods: Dict[str, Callable[[bytes], bytes]] = {}

    def register(self, name: str,
                 fn: Callable[[bytes], bytes]) -> None:
        self._methods[name] = fn

    def unregister(self, name: str) -> None:
        self._methods.pop(name, None)

    def methods(self) -> Tuple[str, ...]:
        return tuple(sorted(self._methods))

    def __contains__(self, name: str) -> bool:
        return name in self._methods

    def __call__(self, method: str, payload: bytes) -> bytes:
        fn = self._methods.get(method)
        if fn is None:
            raise ValueError(
                f"unknown RPC method {method!r}; "
                f"registered: {', '.join(self.methods()) or '(none)'}")
        return fn(payload)


class Transport:
    """Abstract parent-facing call channel."""

    regime = "abstract"

    def call(self, method: str, payload: bytes) -> bytes:
        raise NotImplementedError

    def call_many(self, calls: Sequence[Tuple[str, bytes]]) -> List[bytes]:
        """Issue several calls and return their responses in order.
        The base implementation is sequential; pipelining transports
        override it to pay one flush/round-trip for the batch."""
        return [self.call(m, p) for m, p in calls]

    def close(self) -> None:
        pass


class InProcTransport(Transport):
    """Intranode regime: serialize through bytes, dispatch in-process."""

    regime = "intranode"

    def __init__(self, handler: Handler):
        self._handler = handler

    def call(self, method: str, payload: bytes) -> bytes:
        # Round-trip through a frame encode/decode so that serialization
        # cost matches the socket path's payload handling.
        note_transport_call(method)
        frame = _encode_frame(method, payload)
        m, p = _decode_frame(frame)
        resp = self._handler(m, p)
        return bytes(resp)


def _encode_frame(method: str, payload: bytes) -> bytes:
    mb = method.encode()
    return _HDR.pack(len(mb)) + mb + _HDR.pack(len(payload)) + payload


def _decode_frame(frame: bytes) -> Tuple[str, bytes]:
    (mlen,) = _HDR.unpack_from(frame, 0)
    method = frame[4:4 + mlen].decode()
    (plen,) = _HDR.unpack_from(frame, 4 + mlen)
    off = 8 + mlen
    return method, frame[off:off + plen]


def _mux_request(rid: int, method: str, payload: bytes) -> bytes:
    mb = method.encode()
    body = _MUX_REQ.pack(KIND_REQUEST, rid, len(mb)) + mb + payload
    return _HDR.pack(len(body)) + body


def _mux_response(rid: int, payload: bytes) -> bytes:
    body = _MUX_RSP.pack(KIND_RESPONSE, rid) + payload
    return _HDR.pack(len(body)) + body


def _mux_error(rid: int, message: str) -> bytes:
    body = _MUX_RSP.pack(KIND_ERROR, rid) + message.encode()
    return _HDR.pack(len(body)) + body


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_len(conn: socket.socket, max_frame: int) -> int:
    """Read and validate a 4-byte length prefix."""
    (n,) = _HDR.unpack(_recv_exact(conn, 4))
    if n > max_frame:
        raise ProtocolError(
            f"frame length {n} exceeds max_frame {max_frame}")
    return n


class RPCServer:
    """Loopback TCP server dispatching length-prefixed frames
    (thread-per-connection; the compatibility/oracle server — use
    :class:`MuxServer` for scale).

    ``close()`` is deterministic: it shuts every live session socket
    down (unblocking threads parked in ``recv``) and joins the accept
    thread and every session thread before returning.
    """

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 backlog: int = 8, max_frame: int = MAX_FRAME_BYTES):
        self._handler = handler
        self._max_frame = max_frame
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(backlog)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._stop = threading.Event()
        self._lock = named_lock("rpcserver")
        self._sessions: Dict[int, Tuple[threading.Thread,
                                        socket.socket]] = {}
        self._session_seq = 0
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    break
                sid = self._session_seq
                self._session_seq += 1
                t = threading.Thread(target=self._session,
                                     args=(conn, sid), daemon=True)
                self._sessions[sid] = (t, conn)
            t.start()

    def _session(self, conn: socket.socket, sid: int) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                total = _recv_len(conn, self._max_frame)
                frame = _recv_exact(conn, total)
                method, payload = _decode_frame(frame)
                resp = self._handler(method, payload)
                conn.sendall(_HDR.pack(len(resp)) + resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            with self._lock:
                self._sessions.pop(sid, None)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions.values())
        for _, conn in sessions:
            # unblock threads parked in recv: shutdown forces an EOF
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=5.0)
        for t, _ in sessions:
            t.join(timeout=5.0)


class SocketTransport(Transport):
    """Internode regime: loopback TCP with length-prefixed frames.

    Connections are pooled: the transport keeps up to ``pool_size``
    persistent connections and checks one out per in-flight call, so
    concurrent MG requests to the same level no longer serialize on a
    single locked socket (each RPCServer session runs in its own
    thread; it is the *instances* that are not thread-safe, which the
    per-connection request/response discipline preserves).  A call that
    finds the pool empty dials a fresh connection; surplus connections
    beyond the pool size are closed on check-in rather than retained.
    A connection that died between calls is redialed once.

    ``latency_s`` adds a simulated one-way link latency per call:
    loopback TCP round-trips in microseconds, which hides the real
    internode link cost (the paper's IPoIB regime is ~O(100us-1ms)).
    The sleep happens outside the pool lock and releases the GIL, so
    concurrent callers (sibling actor loops) overlap their link waits
    exactly as concurrent RPCs on a real fabric would.
    """

    regime = "internode"

    def __init__(self, address: Tuple[str, int], pool_size: int = 4,
                 latency_s: float = 0.0,
                 max_frame: int = MAX_FRAME_BYTES):
        self._address = address
        self._pool_size = pool_size
        self._latency_s = latency_s
        self._max_frame = max_frame
        self._lock = named_lock("socktransport.pool")
        self._pool: list = [self._dial()]   # fail fast on a bad address
        self._closed = False

    def _dial(self) -> socket.socket:
        s = socket.create_connection(self._address)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _checkout(self) -> Tuple[socket.socket, bool]:
        """Returns (socket, from_pool) — pooled connections may have
        died while idle and are the only ones worth a retry."""
        with self._lock:
            if self._closed:
                raise ConnectionError("transport closed")
            if self._pool:
                return self._pool.pop(), True
        return self._dial(), False

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._pool) < self._pool_size:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def call(self, method: str, payload: bytes) -> bytes:
        note_transport_call(method)
        if self._latency_s > 0.0:
            time.sleep(self._latency_s)
        frame = _encode_frame(method, payload)
        sock, pooled = self._checkout()
        try:
            try:
                sock.sendall(_HDR.pack(len(frame)) + frame)
            except (ConnectionError, OSError):
                # the retry is scoped to the SEND phase on a POOLED
                # connection: that failure proves the server never saw
                # the request (the peer closed while the socket idled),
                # so re-sending cannot duplicate a non-idempotent RPC
                # (match_grow/revoke/release).  A receive-phase failure
                # is ambiguous — the server may have executed the call
                # — and must surface to the caller instead.
                if not pooled:
                    raise
                try:
                    sock.close()
                except OSError:
                    pass
                sock = self._dial()
                sock.sendall(_HDR.pack(len(frame)) + frame)
            n = _recv_len(sock, self._max_frame)
            resp = _recv_exact(sock, n)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._checkin(sock)
        return resp

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for s in pool:
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------- #
# multiplexed server: one event loop, a small worker pool, both protocols
# ---------------------------------------------------------------------- #
class _Conn:
    """Per-connection server state.  Fields below the lock comment are
    guarded by the owning server's ``_lock``."""

    __slots__ = ("sock", "fd", "inbuf", "mode",
                 # guarded by MuxServer._lock:
                 "out", "out_bytes", "want_write", "closed", "close_req",
                 "legacy_pending", "legacy_busy", "streams")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.fd = sock.fileno()
        self.inbuf = bytearray()
        self.mode: Optional[str] = None       # None | "legacy" | "mux"
        self.out: Deque[memoryview] = collections.deque()
        self.out_bytes = 0
        self.want_write = False
        self.closed = False
        self.close_req = False
        self.legacy_pending: Deque[bytes] = collections.deque()
        self.legacy_busy = False
        self.streams: Dict[int, Callable[[], None]] = {}


class MuxServer:
    """Single-event-loop multiplexed RPC server.

    One ``selectors`` loop owns every connection (no thread per
    connection), a fixed pool of ``workers`` threads runs handlers, and
    responses are correlated by request id — so one connection carries
    many in-flight pipelined calls and the server scales to thousands
    of concurrent connections bounded by fds, not threads.

    * **Both protocols.**  The first frame of a connection identifies
      it: legacy ``SocketTransport`` frames (first body byte 0) are
      served with strict per-connection FIFO request/response ordering,
      exactly like the thread-per-connection ``RPCServer``; mux frames
      (high bit set) dispatch concurrently and respond out of order.
    * **Push streams.**  A *stream verb* registered via
      ``register_stream`` is opened by a normal request; its opener
      receives a ``push(count, payload)`` callable that enqueues EVENT
      frames on the opening connection from any thread, and returns
      ``(ack_payload, close_fn)``.  ``close_fn`` runs on client
      ``unsubscribe`` and on connection teardown.
    * **Bounded everything.**  Frames beyond ``max_frame`` close the
      connection (never allocate), and a subscriber whose outbound
      backlog exceeds ``max_backlog`` is dropped — it can reattach from
      its cursor (slow consumers must not wedge the loop).
    * **Deterministic close.**  ``close()`` tears down every
      connection (running stream close hooks), then joins the loop
      thread and every worker before returning.
    """

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 backlog: int = 512, workers: int = 8,
                 max_frame: int = MAX_FRAME_BYTES,
                 max_backlog: int = 128 * 1024 * 1024,
                 streams: Optional[Dict[str, Callable]] = None):
        self._handler = handler
        self._max_frame = max_frame
        self._max_backlog = max_backlog
        self._streams = dict(streams or {})
        self._lock = named_lock("muxserver")
        self._conns: Dict[int, _Conn] = {}
        self._attention: List[_Conn] = []   # need write-enable or close
        self._stop = threading.Event()

        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, 0))
        self._listen.listen(backlog)
        self._listen.setblocking(False)
        self.address: Tuple[str, int] = self._listen.getsockname()

        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listen, selectors.EVENT_READ, "listen")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

        import queue as _queue
        self._tasks: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(workers)]
        for t in self._workers:
            t.start()
        self._loop_thread = threading.Thread(target=self._loop, daemon=True)
        self._loop_thread.start()

    # -- registration --------------------------------------------------- #
    def register_stream(self, name: str, opener: Callable) -> None:
        """``opener(payload, push) -> (ack_payload, close_fn)``."""
        with self._lock:
            self._streams[name] = opener

    # -- cross-thread send ---------------------------------------------- #
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass    # a pending wake byte is as good as a new one

    def _send_buffers(self, conn: _Conn, bufs: Sequence[bytes]) -> None:
        """Enqueue outbound buffers (thread-safe).  Buffers are held by
        reference — a payload shared across 500 subscriber connections
        is one bytes object, not 500 copies."""
        with self._lock:
            if conn.closed or conn.close_req:
                return
            for b in bufs:
                conn.out.append(memoryview(b))
                conn.out_bytes += len(b)
            if conn.out_bytes > self._max_backlog:
                conn.close_req = True       # drop the slow consumer
            if not conn.want_write:
                conn.want_write = True
                self._attention.append(conn)
            elif conn.close_req:
                self._attention.append(conn)
        self._wake()

    def _push_event(self, conn: _Conn, sid: int, count: int,
                    payload: bytes) -> None:
        hdr = _HDR.pack(_MUX_EVT.size + len(payload)) + \
            _MUX_EVT.pack(KIND_EVENT, sid, count)
        self._send_buffers(conn, (hdr, payload))

    def _request_close(self, conn: _Conn) -> None:
        with self._lock:
            if conn.closed:
                return
            conn.close_req = True
            self._attention.append(conn)
        self._wake()

    # -- event loop ------------------------------------------------------ #
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                ready = self._sel.select(timeout=0.5)
            except OSError:
                break
            for key, mask in ready:
                if key.data == "listen":
                    self._accept()
                elif key.data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    conn = key.data
                    if mask & selectors.EVENT_READ:
                        self._on_readable(conn)
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._on_writable(conn)
            self._apply_attention()
        # shutdown: tear down every connection, then the listener
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        for s in (self._listen, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass

    def _apply_attention(self) -> None:
        with self._lock:
            pending, self._attention = self._attention, []
        for conn in pending:
            if conn.closed:
                continue
            if conn.close_req:
                self._close_conn(conn)
                continue
            mask = selectors.EVENT_READ
            if conn.want_write:
                mask |= selectors.EVENT_WRITE
            try:
                self._sel.modify(conn.sock, mask, conn)
            except (KeyError, ValueError, OSError):
                pass

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[conn.fd] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _close_conn(self, conn: _Conn) -> None:
        """Loop-thread only: final teardown of one connection."""
        with self._lock:
            if conn.closed:
                return
            conn.closed = True
            closers = list(conn.streams.values())
            conn.streams.clear()
            conn.out.clear()
            conn.out_bytes = 0
        for fn in closers:
            try:
                fn()
            except Exception:
                pass
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.pop(conn.fd, None)

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(262144)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.inbuf += data
        buf = conn.inbuf
        while not conn.closed:
            if len(buf) < 4:
                break
            (n,) = _HDR.unpack_from(buf, 0)
            if n > self._max_frame or n == 0:
                # oversized or empty frame: protocol violation — never
                # allocate for it, just drop the connection
                self._close_conn(conn)
                return
            if len(buf) < 4 + n:
                break
            body = bytes(buf[4:4 + n])
            del buf[:4 + n]
            self._handle_body(conn, body)

    def _on_writable(self, conn: _Conn) -> None:
        # The socket send must NOT happen under the server-global lock:
        # a slow consumer draining its 1 MiB budget here would stall
        # every handler thread queueing responses on *other*
        # connections.  Take buffers off the deque under the lock, send
        # with no lock held (only this loop thread writes a connection,
        # so frame order is preserved), then put the unsent tail back
        # at the head.
        budget = 1 << 20
        err = False
        sent_total = 0
        taken: List[bytes] = []
        with self._lock:
            out = conn.out
            while out and budget > 0:
                head = out.popleft()
                taken.append(head)
                budget -= len(head)
        unsent: List[bytes] = []
        for i, head in enumerate(taken):
            try:
                sent = conn.sock.send(head)
            except (BlockingIOError, InterruptedError):
                unsent = taken[i:]
                break
            except OSError:
                err = True
                break
            sent_total += sent
            if sent < len(head):
                unsent = [head[sent:]] + taken[i + 1:]
                break
        with self._lock:
            # handler threads may have appended while we were sending;
            # the unsent tail goes back BEFORE anything they queued
            for b in reversed(unsent):
                conn.out.appendleft(b)
            conn.out_bytes -= sent_total
            if not conn.out:
                conn.want_write = False
            done_writing = not conn.want_write
        if err:
            self._close_conn(conn)
            return
        if done_writing:
            try:
                self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
            except (KeyError, ValueError, OSError):
                pass

    def _handle_body(self, conn: _Conn, body: bytes) -> None:
        if conn.mode is None:
            conn.mode = "mux" if body[0] & 0x80 else "legacy"
        if conn.mode == "legacy":
            with self._lock:
                if conn.legacy_busy:
                    conn.legacy_pending.append(body)
                    return
                conn.legacy_busy = True
            self._tasks.put(("legacy", conn, body))
            return
        kind = body[0]
        if kind != KIND_REQUEST:
            self._close_conn(conn)
            return
        try:
            _, rid, mlen = _MUX_REQ.unpack_from(body, 0)
            method = body[_MUX_REQ.size:_MUX_REQ.size + mlen].decode()
            payload = body[_MUX_REQ.size + mlen:]
        except (struct.error, UnicodeDecodeError):
            self._close_conn(conn)
            return
        self._tasks.put(("mux", conn, rid, method, payload))

    # -- worker pool ----------------------------------------------------- #
    def _worker(self) -> None:
        while True:
            task = self._tasks.get()
            if task is None:
                return
            try:
                if task[0] == "legacy":
                    self._run_legacy(task[1], task[2])
                else:
                    self._run_mux(task[1], task[2], task[3], task[4])
            except Exception:
                pass    # a handler bug must never kill a worker

    def _run_legacy(self, conn: _Conn, body: bytes) -> None:
        # strict per-connection FIFO: drain queued frames one at a time
        # (SocketTransport never pipelines, but correctness must not
        # depend on that)
        while True:
            try:
                method, payload = _decode_frame(body)
                resp = self._handler(method, payload)
            except Exception:
                # legacy protocol has no error frame: drop the
                # connection, exactly like RPCServer's session did
                self._request_close(conn)
                return
            self._send_buffers(conn, (_HDR.pack(len(resp)), resp))
            with self._lock:
                if conn.legacy_pending:
                    body = conn.legacy_pending.popleft()
                else:
                    conn.legacy_busy = False
                    return

    def _run_mux(self, conn: _Conn, rid: int, method: str,
                 payload: bytes) -> None:
        if method == UNSUBSCRIBE_METHOD:
            sid = unpack_json(payload).get("stream")
            with self._lock:
                close_fn = conn.streams.pop(sid, None)
            if close_fn is not None:
                try:
                    close_fn()
                except Exception:
                    pass
            self._send_buffers(conn, (_mux_response(
                rid, pack_json({"ok": close_fn is not None})),))
            return
        with self._lock:
            opener = self._streams.get(method)
        if opener is not None:
            def push(count: int, data: bytes,
                     _c=conn, _s=rid) -> None:
                self._push_event(_c, _s, count, data)
            try:
                ack, close_fn = opener(payload, push)
            except Exception as exc:
                self._send_buffers(conn, (_mux_error(rid, str(exc)),))
                return
            run_now = False
            with self._lock:
                if conn.closed or conn.close_req:
                    run_now = True
                else:
                    conn.streams[rid] = close_fn
            if run_now:
                try:
                    close_fn()
                except Exception:
                    pass
            self._send_buffers(conn, (_mux_response(rid, ack),))
            return
        try:
            resp = self._handler(method, payload)
        except Exception as exc:
            self._send_buffers(conn, (_mux_error(rid, str(exc)),))
            return
        self._send_buffers(conn, (_mux_response(rid, resp),))

    # -- lifecycle ------------------------------------------------------- #
    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._wake()
        self._loop_thread.join(timeout=5.0)
        for _ in self._workers:
            self._tasks.put(None)
        for t in self._workers:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------- #
# multiplexed client
# ---------------------------------------------------------------------- #
class _Pending:
    __slots__ = ("event", "value", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.value: Optional[bytes] = None
        self.exc: Optional[BaseException] = None


class Subscription:
    """Client side of one push stream.

    ``events_received``/``batches`` count what arrived (updated on the
    reader thread).  In ``raw`` mode EVENT payloads are *skipped on the
    wire* — only counted — which is what a throughput consumer wants;
    otherwise ``on_batch(count, payload)`` receives the payload bytes
    for decoding."""

    def __init__(self, transport: "MuxTransport", sid: int,
                 on_batch: Optional[Callable[[int, Optional[bytes]],
                                             None]] = None,
                 raw: bool = False):
        self._transport = transport
        self.stream_id = sid
        self.on_batch = on_batch
        self.raw = raw
        self.ack: Optional[bytes] = None
        self.events_received = 0
        self.batches = 0
        self.closed = False

    def _deliver(self, count: int, payload: Optional[bytes]) -> None:
        self.events_received += count
        self.batches += 1
        if self.on_batch is not None:
            try:
                self.on_batch(count, payload)
            except Exception:
                pass

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._transport._unsubscribe(self)


class MuxTransport(Transport):
    """Pipelined multiplexed client with a synchronous ``call`` facade.

    One TCP connection carries many in-flight requests correlated by
    request id: concurrent ``call``\\ s from different threads share the
    connection, ``call_many`` flushes a batch in one write and collects
    the responses as they land (out-of-order on the wire is fine), and
    ``subscribe`` opens a server-push stream delivered on the reader
    thread.  A dedicated reader thread services the socket by default;
    pass a shared :class:`ClientReactor` to multiplex many transports
    onto one thread (the 1000-subscriber client shape).
    """

    regime = "internode"

    def __init__(self, address: Tuple[str, int], latency_s: float = 0.0,
                 max_frame: int = MAX_FRAME_BYTES,
                 reactor: Optional["ClientReactor"] = None):
        self._latency_s = latency_s
        self._max_frame = max_frame
        self._sock = socket.create_connection(address)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = named_lock("muxtransport")
        self._send_lock = named_lock("muxtransport.send")
        self._next_id = 0
        self._calls: Dict[int, _Pending] = {}
        self._streams: Dict[int, Subscription] = {}
        self._error: Optional[BaseException] = None
        self._buf = bytearray()
        self._skip_n = 0
        self._skip_fire: Optional[Tuple[Subscription, int]] = None
        self._reactor = reactor
        self._reader: Optional[threading.Thread] = None
        if reactor is not None:
            self._sock.setblocking(False)
            reactor.add(self)
        else:
            self._reader = threading.Thread(target=self._read_loop,
                                            daemon=True)
            self._reader.start()

    # -- reading --------------------------------------------------------- #
    def _read_loop(self) -> None:
        while True:
            try:
                data = self._sock.recv(262144)
            except OSError:
                self._fail(ConnectionError("transport closed"))
                return
            if not data:
                self._fail(ConnectionError("peer closed"))
                return
            try:
                self._feed(data)
            except ProtocolError as exc:
                self._fail(exc)
                return

    def _on_readable(self) -> None:
        """Reactor callback: drain the socket without blocking."""
        while True:
            try:
                data = self._sock.recv(262144)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._fail(ConnectionError("transport closed"))
                return
            if not data:
                self._fail(ConnectionError("peer closed"))
                return
            try:
                self._feed(data)
            except ProtocolError as exc:
                self._fail(exc)
                return

    def _feed(self, data: bytes) -> None:
        if self._skip_n:
            take = min(len(data), self._skip_n)
            self._skip_n -= take
            if self._skip_n:
                return
            sub, count = self._skip_fire  # type: ignore[misc]
            self._skip_fire = None
            sub._deliver(count, None)
            data = data[take:]
        buf = self._buf
        buf += data
        while True:
            if len(buf) < 4:
                return
            (n,) = _HDR.unpack_from(buf, 0)
            if n > self._max_frame or n == 0:
                raise ProtocolError(
                    f"frame length {n} exceeds max_frame "
                    f"{self._max_frame}")
            have = len(buf) - 4
            if have >= _MUX_EVT.size and buf[4] == KIND_EVENT:
                _, sid, count = _MUX_EVT.unpack_from(buf, 4)
                sub = self._streams.get(sid)
                if sub is not None and sub.raw:
                    # fast path: count the events, skip the payload
                    # bytes without ever assembling the frame
                    rest = n - _MUX_EVT.size
                    avail = have - _MUX_EVT.size
                    if avail >= rest:
                        del buf[:4 + n]
                        sub._deliver(count, None)
                        continue
                    del buf[:]
                    self._skip_n = rest - avail
                    self._skip_fire = (sub, count)
                    return
            if have < n:
                return
            body = bytes(buf[4:4 + n])
            del buf[:4 + n]
            self._dispatch(body)

    def _dispatch(self, body: bytes) -> None:
        kind = body[0]
        if kind in (KIND_RESPONSE, KIND_ERROR):
            _, rid = _MUX_RSP.unpack_from(body, 0)
            with self._lock:
                pending = self._calls.pop(rid, None)
            if pending is None:
                return
            if kind == KIND_ERROR:
                pending.exc = RPCError(body[_MUX_RSP.size:].decode())
            else:
                pending.value = body[_MUX_RSP.size:]
            pending.event.set()
        elif kind == KIND_EVENT:
            _, sid, count = _MUX_EVT.unpack_from(body, 0)
            sub = self._streams.get(sid)
            if sub is not None:
                sub._deliver(count, body[_MUX_EVT.size:])
        else:
            raise ProtocolError(f"unexpected frame kind 0x{kind:02x}")

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
            pending = list(self._calls.values())
            self._calls.clear()
            subs = list(self._streams.values())
        for p in pending:
            p.exc = exc
            p.event.set()
        for s in subs:
            s.closed = True
        if self._reactor is not None:
            self._reactor.discard(self)
        try:
            self._sock.close()
        except OSError:
            pass

    # -- writing --------------------------------------------------------- #
    def _raw_send(self, data: bytes) -> None:
        with self._send_lock:
            mv = memoryview(data)
            while mv:
                try:
                    # lint: allow(R2) _send_lock is a leaf writer lock; hoisting would interleave frames from concurrent pipelined callers
                    sent = self._sock.send(mv)
                except (BlockingIOError, InterruptedError):
                    select.select([], [self._sock], [], 1.0)
                    continue
                except OSError as exc:
                    raise ConnectionError(str(exc)) from exc
                mv = mv[sent:]

    def _begin(self, n: int = 1) -> List[Tuple[int, _Pending]]:
        with self._lock:
            if self._error is not None:
                raise ConnectionError(str(self._error)) from self._error
            out = []
            for _ in range(n):
                rid = self._next_id
                self._next_id = (self._next_id + 1) & 0xFFFFFFFF
                p = _Pending()
                self._calls[rid] = p
                out.append((rid, p))
            return out

    # -- public API ------------------------------------------------------ #
    def call(self, method: str, payload: bytes) -> bytes:
        note_transport_call(method)
        if self._latency_s > 0.0:
            time.sleep(self._latency_s)
        ((rid, pending),) = self._begin()
        self._raw_send(_mux_request(rid, method, payload))
        pending.event.wait()
        if pending.exc is not None:
            raise pending.exc
        return pending.value  # type: ignore[return-value]

    def call_many(self, calls: Sequence[Tuple[str, bytes]]) -> List[bytes]:
        """Pipelined batch: every request goes out in one write, and
        the batch completes when the last response lands — one flush
        and one round-trip of latency for N calls, not N."""
        if not calls:
            return []
        note_transport_call("call_many")
        if self._latency_s > 0.0:
            time.sleep(self._latency_s)
        ids = self._begin(len(calls))
        blob = b"".join(_mux_request(rid, m, p)
                        for (rid, _), (m, p) in zip(ids, calls))
        self._raw_send(blob)
        out: List[bytes] = []
        for _, pending in ids:
            pending.event.wait()
            if pending.exc is not None:
                raise pending.exc
            out.append(pending.value)  # type: ignore[arg-type]
        return out

    def subscribe(self, payload: bytes = b"",
                  on_batch: Optional[Callable] = None, raw: bool = False,
                  method: str = "subscribe") -> Subscription:
        """Open a server-push stream; returns once the server acks.
        ``sub.ack`` holds the ack payload.  EVENT batches are delivered
        on the reader thread via ``on_batch(count, payload)`` — with
        ``raw=True`` payloads are skipped on the wire and only counted."""
        ((rid, pending),) = self._begin()
        sub = Subscription(self, rid, on_batch=on_batch, raw=raw)
        self._streams[rid] = sub        # before send: events may beat ack
        try:
            self._raw_send(_mux_request(rid, method, payload))
        except BaseException:
            self._streams.pop(rid, None)
            raise
        pending.event.wait()
        if pending.exc is not None:
            self._streams.pop(rid, None)
            raise pending.exc
        sub.ack = pending.value
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        self._streams.pop(sub.stream_id, None)
        if self._error is None:
            try:
                self.call(UNSUBSCRIBE_METHOD,
                          pack_json({"stream": sub.stream_id}))
            except (ConnectionError, RPCError):
                pass

    def close(self) -> None:
        self._fail(ConnectionError("transport closed"))
        if self._reader is not None:
            self._reader.join(timeout=2.0)


class ClientReactor:
    """One thread + selector servicing many :class:`MuxTransport`\\ s.

    512 subscriber transports on one reactor cost one thread and one
    ``select`` loop — the client-side mirror of :class:`MuxServer` —
    instead of 512 blocking reader threads fighting for the GIL."""

    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self._lock = named_lock("clientreactor")
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._pending: List[Tuple[str, MuxTransport]] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass

    def add(self, transport: MuxTransport) -> None:
        with self._lock:
            self._pending.append(("add", transport))
        self._wake()

    def discard(self, transport: MuxTransport) -> None:
        with self._lock:
            self._pending.append(("del", transport))
        self._wake()

    def _loop(self) -> None:
        while not self._closed:
            for key, _ in self._sel.select(timeout=0.5):
                if key.data is None:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    key.data._on_readable()
            with self._lock:
                pending, self._pending = self._pending, []
            for op, t in pending:
                try:
                    if op == "add":
                        self._sel.register(t._sock,
                                           selectors.EVENT_READ, t)
                    else:
                        self._sel.unregister(t._sock)
                except (KeyError, ValueError, OSError):
                    pass
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        self._wake()
        self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------- #
# JSON helpers used by scheduler RPC methods
# ---------------------------------------------------------------------- #
def pack_json(obj: Dict) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def unpack_json(data: bytes) -> Dict:
    return json.loads(data) if data else {}
