"""The worker contract's method table and its transport on the stdlib.

Port of ``localai_tpu/worker/rpc.py``. The JAX package serves the table
with grpcio; the card's machine has no gRPC, so the port carries the same
messages (``worker.backend_pb2``, protobuf's bytes) over a transport of its
own: one TCP connection per call, framed as gRPC frames a message.

A call, from the client:

  * a header frame: flag ``0x80``, a 4-byte big-endian length, then
    ``name:value`` lines (``\\r\\n``-terminated, values percent-encoded):
    ``:path`` (``/<SERVICE>/<Method>``), ``grpc-timeout`` (the
    deadline, in gRPC's ``<digits><unit>`` form) and the call's metadata
    (``x-localai-trace-id``, ``x-localai-tenant``);
  * each request message as gRPC frames it: flag 0 (never compressed), a
    4-byte big-endian length, the message's bytes;
  * an empty ``0x80`` frame ending the request stream.

From the server: each response message framed alike, then a ``0x80``
trailer frame of ``grpc-status:<code>`` and ``grpc-message:<details>``
lines (gRPC-Web's trailer form). A status other than 0 reaches the client
as :class:`RpcError` with ``.code()`` and ``.details()``, as grpcio's does:
a servicer's ``context.abort(code, details)``, a method the servicer lacks
(``UNIMPLEMENTED``), an exception in a handler (``UNKNOWN``), an expired
deadline (``DEADLINE_EXCEEDED``), a peer that cannot be reached or dies
mid-call (``UNAVAILABLE``) and a message over 256 MiB
(``RESOURCE_EXHAUSTED``).

A client that goes away (its connection closes) cancels the call: the
server's context turns inactive and runs its callbacks, as grpcio's does,
so a dropped ``PredictStream`` frees its decode slot at once. Every socket
of a call keeps TCP keepalive probes after 30 s of silence, 10 s apart,
and gives up on unacknowledged data after 40 s, so a peer that dies
without a reset fails an in-flight call within about 40 s, as the JAX
client's 30 s keepalive ping with its 10 s ack bound does.

This is not gRPC over HTTP/2: a grpcio client cannot dial a port worker
and the port's client cannot dial a grpcio worker (an intended divergence,
ROADMAP §C). The method table, the messages and the status codes are the
JAX package's.
"""

from __future__ import annotations

import enum
import logging
import select
import socket
import struct
import threading
import time
import urllib.parse
from concurrent import futures
from typing import Any, Callable, Iterator, Optional

from localai_tpu_torch.worker import backend_pb2 as pb

log = logging.getLogger(__name__)

# backend.proto's package and service: the method paths are gRPC's
PROTO_PACKAGE = "localai_tpu"
SERVICE = f"{PROTO_PACKAGE}.Backend"
# the JAX client's and server's grpc.max_{send,receive}_message_length
MAX_MESSAGE_BYTES = 256 * 1024 * 1024
# a dead peer fails a call after KEEPALIVE_IDLE_S + KEEPALIVE_INTERVAL_S
KEEPALIVE_IDLE_S = 30
KEEPALIVE_INTERVAL_S = 10
_HEADER_FLAG = 0x80
_FRAME = struct.Struct(">BI")
# a server's read of the request stream when the call names no deadline
_NO_DEADLINE_S = 3600.0


class StatusCode(enum.IntEnum):
    """gRPC's status codes, by grpcio's names and gRPC's numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


# span propagation across the worker boundary: the API tier sends its
# trace id as call metadata, the worker stamps it onto the GenRequest, so
# both processes record spans under one trace id
TRACE_ID_METADATA_KEY = "x-localai-trace-id"
# the hashed tenant bucket of the usage ledger (never the raw API key)
TENANT_METADATA_KEY = "x-localai-tenant"


def trace_metadata(trace_id: str) -> tuple:
    """Per-call metadata carrying ``trace_id`` ('' → none)."""
    if not trace_id:
        return ()
    return ((TRACE_ID_METADATA_KEY, trace_id),)


def tenant_metadata(tenant: str) -> tuple:
    """Per-call metadata carrying the hashed tenant bucket."""
    if not tenant:
        return ()
    return ((TENANT_METADATA_KEY, tenant),)


def _from_context(context: Any, key: str) -> str:
    try:
        for k, value in context.invocation_metadata():
            if k == key:
                return value
    except Exception:  # noqa: BLE001 — tracing and accounting never fail
        pass
    return ""


def trace_id_from_context(context: Any) -> str:
    """The propagated trace id of a servicer context."""
    return _from_context(context, TRACE_ID_METADATA_KEY)


def tenant_from_context(context: Any) -> str:
    """The propagated tenant bucket of a servicer context."""
    return _from_context(context, TENANT_METADATA_KEY)


# which side of the call is a message stream
UNARY = "unary"
SERVER_STREAM = "server_stream"
CLIENT_STREAM = "client_stream"

# name → (kind, request type, response type)
METHODS: dict[str, tuple[str, Any, Any]] = {
    "Health": (UNARY, pb.HealthMessage, pb.Reply),
    "LoadModel": (UNARY, pb.ModelOptions, pb.Result),
    "Predict": (UNARY, pb.PredictOptions, pb.Reply),
    "PredictStream": (SERVER_STREAM, pb.PredictOptions, pb.Reply),
    "Embedding": (UNARY, pb.EmbeddingRequest, pb.EmbeddingResult),
    "TokenizeString": (UNARY, pb.TokenizationRequest, pb.TokenizationResponse),
    "Status": (UNARY, pb.HealthMessage, pb.StatusResponse),
    "GetMetrics": (UNARY, pb.MetricsRequest, pb.MetricsResponse),
    "TTS": (UNARY, pb.TTSRequest, pb.AudioResult),
    "SoundGeneration": (UNARY, pb.SoundGenerationRequest, pb.AudioResult),
    "AudioTranscription": (UNARY, pb.TranscriptRequest, pb.TranscriptResult),
    "GenerateImage": (UNARY, pb.GenerateImageRequest, pb.ImageResult),
    "Rerank": (UNARY, pb.RerankRequest, pb.RerankResult),
    "StoresSet": (UNARY, pb.StoresSetOptions, pb.Result),
    "StoresDelete": (UNARY, pb.StoresDeleteOptions, pb.Result),
    "StoresGet": (UNARY, pb.StoresGetOptions, pb.StoresGetResult),
    "StoresFind": (UNARY, pb.StoresFindOptions, pb.StoresFindResult),
    # fleet disaggregation: prefill export out, prefix-block transfer in
    "PrefillPrefix": (SERVER_STREAM, pb.PredictOptions, pb.PrefixChunk),
    "TransferPrefix": (CLIENT_STREAM, pb.PrefixChunk, pb.Result),
    # fleet telemetry harvest: trace spans, flight ring and metrics in one
    # bounded control-plane pull (obs.fleetview)
    "GetTelemetry": (UNARY, pb.TelemetryRequest, pb.TelemetryResponse),
}


# -- framing ---------------------------------------------------------------


def _tune(sock: socket.socket) -> None:
    """No Nagle delay (a stream sends one small frame a token); keepalive
    probes and an unacknowledged-data bound, so a dead peer fails the call
    in about KEEPALIVE_IDLE_S + KEEPALIVE_INTERVAL_S."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, value in (("TCP_KEEPIDLE", KEEPALIVE_IDLE_S),
                       ("TCP_KEEPINTVL", KEEPALIVE_INTERVAL_S),
                       ("TCP_KEEPCNT", 1),
                       ("TCP_USER_TIMEOUT",
                        (KEEPALIVE_IDLE_S + KEEPALIVE_INTERVAL_S) * 1000)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), value)


def _send_frame(sock: socket.socket, flag: int, payload: bytes) -> None:
    if len(payload) > MAX_MESSAGE_BYTES:
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                       f"Sent message larger than max ({len(payload)} vs. "
                       f"{MAX_MESSAGE_BYTES})")
    head = _FRAME.pack(flag, len(payload))
    if len(payload) < 65536:
        sock.sendall(head + payload)    # one segment for a small frame
    else:
        sock.sendall(head)
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """``n`` bytes, or None at a clean end of stream before the first."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            if got == 0:
                return None
            raise ConnectionError("connection closed inside a frame")
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> Optional[tuple[int, bytes]]:
    """(flag, payload), or None when the peer closed between frames."""
    head = _recv_exact(sock, _FRAME.size)
    if head is None:
        return None
    flag, n = _FRAME.unpack(head)
    if n > MAX_MESSAGE_BYTES:
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                       f"Received message larger than max ({n} vs. "
                       f"{MAX_MESSAGE_BYTES})")
    body = _recv_exact(sock, n) if n else bytearray()
    if body is None:
        raise ConnectionError("connection closed inside a frame")
    return flag, bytes(body)


def _encode_headers(pairs) -> bytes:
    return "".join(f"{k}:{urllib.parse.quote(str(v), safe='')}\r\n"
                   for k, v in pairs).encode("ascii")


def _decode_headers(payload: bytes) -> list[tuple[str, str]]:
    out = []
    for line in payload.decode("ascii").split("\r\n"):
        if line:
            cut = line.index(":", 1)    # a pseudo-header starts with ':'
            out.append((line[:cut], urllib.parse.unquote(line[cut + 1:])))
    return out


def _timeout_header(seconds: float) -> str:
    """gRPC's ``grpc-timeout`` value: at most 8 digits and a unit."""
    ms = max(1, int(seconds * 1000))
    return f"{ms}m" if ms < 10**8 else f"{max(1, int(seconds))}S"


_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
          "n": 1e-9}


def _parse_timeout(value: str) -> float:
    return int(value[:-1]) * _UNITS[value[-1]]


def _split_address(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host.strip("[]") or "127.0.0.1", int(port)


# -- the server --------------------------------------------------------------


class _Abort(Exception):
    """Raised by ``ServicerContext.abort`` to end the call."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


class ServicerContext:
    """A call's context on the server: grpcio's ``ServicerContext``
    surface that the servicers use."""

    def __init__(self, sock: socket.socket, metadata: list,
                 deadline: Optional[float]):
        self._sock = sock
        self._metadata = tuple(metadata)
        self._deadline = deadline
        self._cancelled = False
        self._done = False
        self._callbacks: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def is_active(self) -> bool:
        return not self._cancelled and (
            self._deadline is None or time.monotonic() < self._deadline)

    def abort(self, code: StatusCode, details: str) -> None:
        raise _Abort(StatusCode(code), details)

    def add_callback(self, callback: Callable[[], None]) -> bool:
        """Run ``callback`` when the call ends, normally or cancelled."""
        with self._lock:
            if self._done:
                return False
            self._callbacks.append(callback)
            return True

    def _terminate(self, cancelled: bool) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
            self._cancelled = self._cancelled or cancelled
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 — one callback never stops
                log.exception("call termination callback failed")

    def _watch(self) -> None:
        """Cancel the call when the client's connection closes (the client
        sends nothing after its end-of-stream frame)."""
        while not self._done:
            try:
                ready, _, _ = select.select([self._sock], [], [], 0.25)
                if not ready or self._done:
                    continue
                if self._sock.recv(1, socket.MSG_PEEK):
                    time.sleep(0.25)    # stray bytes: not a departure
                    continue
            except (OSError, ValueError):
                pass
            if not self._done:
                self._cancelled = True
                self._terminate(cancelled=True)
            return


class Server:
    """Serves registered methods on one listening socket; each call runs on
    a pool of ``max_workers`` threads (32, the JAX worker's)."""

    def __init__(self, max_workers: int = 32):
        self._handlers: dict[str, tuple[str, Callable, Any, Any]] = {}
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="worker-rpc")
        self._listener: Optional[socket.socket] = None
        self._active: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._stopping = False
        self._idle = threading.Condition(self._lock)

    def add_method(self, path: str, kind: str, fn: Callable,
                   req_t: Any, resp_t: Any) -> None:
        self._handlers[path] = (kind, fn, req_t, resp_t)

    def add_insecure_port(self, addr: str) -> int:
        """Bind ``host:port`` (port 0: a free one); returns the port."""
        host, port = _split_address(addr)
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(128)
        self._listener = sock
        return sock.getsockname()[1]

    def start(self) -> "Server":
        threading.Thread(target=self._accept, daemon=True,
                         name="worker-rpc-accept").start()
        return self

    def _accept(self) -> None:
        listener = self._listener
        while True:
            try:
                conn, peer = listener.accept()
            except OSError:
                return              # the listener closed: stop() ran
            with self._lock:
                if self._stopping:
                    conn.close()
                    continue
                self._active.add(conn)
            self._pool.submit(self._serve_call, conn,
                              f"ipv4:{peer[0]}:{peer[1]}")

    def stop(self, grace: Optional[float] = None) -> threading.Event:
        """Stop accepting; let calls in flight end for ``grace`` seconds,
        then cut their connections. The event is set once all ended."""
        done = threading.Event()
        with self._lock:
            self._stopping = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()

        def finish():
            deadline = time.monotonic() + (grace or 0.0)
            with self._idle:
                while self._active and time.monotonic() < deadline:
                    self._idle.wait(max(0.0, deadline - time.monotonic()))
                for conn in list(self._active):
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
            self._pool.shutdown(wait=False)
            done.set()

        threading.Thread(target=finish, daemon=True,
                         name="worker-rpc-stop").start()
        return done

    def _release(self, conn: socket.socket) -> None:
        with self._idle:
            self._active.discard(conn)
            self._idle.notify_all()

    def _serve_call(self, conn: socket.socket, peer: str) -> None:
        ctx = None
        try:
            _tune(conn)
            conn.settimeout(_NO_DEADLINE_S)
            head = _recv_frame(conn)
            if head is None or head[0] != _HEADER_FLAG:
                return
            headers = _decode_headers(head[1])
            meta = dict(headers)
            path = meta.get(":path", "")
            deadline = None
            if "grpc-timeout" in meta:
                remaining = _parse_timeout(meta["grpc-timeout"])
                deadline = time.monotonic() + remaining
                conn.settimeout(max(remaining, 1e-3))
            metadata = [(k, v) for k, v in headers
                        if not k.startswith(":") and not k.startswith("grpc-")]
            ctx = ServicerContext(conn, metadata, deadline)
            handler = self._handlers.get(path)
            if handler is None:
                self._drain(conn)
                self._trailer(conn, StatusCode.UNIMPLEMENTED,
                              "Method not found!")
                return
            self._run(conn, ctx, *handler)
        except (OSError, ConnectionError, RpcError) as e:
            log.debug("call from %s ended: %s", peer, e)
            if ctx is not None:
                ctx._terminate(cancelled=True)
        finally:
            if ctx is not None:
                ctx._terminate(cancelled=False)
            self._close(conn)

    def _requests(self, conn: socket.socket, req_t: Any) -> Iterator:
        """The request stream up to its end-of-stream frame."""
        while True:
            frame = _recv_frame(conn)
            if frame is None:
                raise ConnectionError("client closed the request stream")
            flag, payload = frame
            if flag == _HEADER_FLAG:
                return
            yield req_t.FromString(payload)

    @staticmethod
    def _drain(conn: socket.socket) -> None:
        while True:
            frame = _recv_frame(conn)
            if frame is None or frame[0] == _HEADER_FLAG:
                return

    def _run(self, conn, ctx: ServicerContext, kind: str, fn: Callable,
             req_t: Any, resp_t: Any) -> None:
        if kind == CLIENT_STREAM:
            requests = self._requests(conn, req_t)
            try:
                resp = fn(requests, ctx)
                for _ in requests:      # what the servicer left unread
                    pass
            except _Abort as e:
                return self._trailer(conn, e.code, e.details)
            except Exception as e:  # noqa: BLE001 — the client's status
                log.exception("%s failed", fn.__name__)
                return self._trailer(conn, StatusCode.UNKNOWN,
                                     f"Exception calling application: {e}")
            _send_frame(conn, 0, resp.SerializeToString())
            return self._trailer(conn, StatusCode.OK, "")
        try:
            reqs = list(self._requests(conn, req_t))
        except pb.DecodeError:
            self._drain(conn)
            return self._trailer(conn, StatusCode.INTERNAL,
                                 "Exception deserializing request!")
        if len(reqs) != 1:
            return self._trailer(conn, StatusCode.INTERNAL,
                                 f"expected one request, got {len(reqs)}")
        threading.Thread(target=ctx._watch, daemon=True,
                         name="worker-rpc-watch").start()
        if kind == UNARY:
            try:
                resp = fn(reqs[0], ctx)
            except _Abort as e:
                return self._trailer(conn, e.code, e.details)
            except Exception as e:  # noqa: BLE001
                log.exception("%s failed", fn.__name__)
                return self._trailer(conn, StatusCode.UNKNOWN,
                                     f"Exception calling application: {e}")
            _send_frame(conn, 0, resp.SerializeToString())
            return self._trailer(conn, StatusCode.OK, "")
        gen = fn(reqs[0], ctx)
        try:
            for resp in gen:
                _send_frame(conn, 0, resp.SerializeToString())
        except _Abort as e:
            return self._trailer(conn, e.code, e.details)
        except OSError:
            # the client went away mid-stream: the servicer's finally sees
            # an inactive context
            ctx._cancelled = True
            gen.close()
            raise
        except Exception as e:  # noqa: BLE001
            log.exception("%s failed", fn.__name__)
            return self._trailer(conn, StatusCode.UNKNOWN,
                                 f"Exception iterating responses: {e}")
        self._trailer(conn, StatusCode.OK, "")

    @staticmethod
    def _trailer(conn, code: StatusCode, details: str) -> None:
        _send_frame(conn, _HEADER_FLAG, _encode_headers(
            (("grpc-status", int(code)), ("grpc-message", details))))

    def _close(self, conn: socket.socket) -> None:
        """A lingering close: FIN after the trailer, then wait (briefly)
        for the client's close, so no unread byte turns it into a reset
        that could cost the client the trailer."""
        try:
            conn.shutdown(socket.SHUT_WR)
            conn.settimeout(5.0)
            while conn.recv(65536):
                pass
        except OSError:
            pass
        finally:
            conn.close()
            self._release(conn)


def add_servicer(server: Server, servicer: Any) -> None:
    """Register every METHODS entry; those the servicer lacks answer
    UNIMPLEMENTED (the JAX package's ``add_servicer``)."""
    for name, (kind, req_t, resp_t) in METHODS.items():
        fn = getattr(servicer, name, None)
        if fn is None:
            fn = _unimplemented(name, kind)
        server.add_method(f"/{SERVICE}/{name}", kind, fn, req_t, resp_t)


def _unimplemented(name: str, kind: str) -> Callable:
    def fn(request, context):
        context.abort(StatusCode.UNIMPLEMENTED,
                      f"{name} not implemented by this worker")

    if kind == SERVER_STREAM:
        def stream(request, context):
            fn(request, context)
            yield  # pragma: no cover — abort raised above

        stream.__name__ = name
        return stream
    fn.__name__ = name
    return fn


# -- the client --------------------------------------------------------------


class Channel:
    """A worker's address, and the connections of its calls in flight
    (``close()`` cuts them, as grpcio's channel close cancels its calls)."""

    def __init__(self, address: str):
        self.address = address
        self._host, self._port = _split_address(address)
        self._open: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._closed = False

    def _connect(self, deadline: Optional[float]) -> socket.socket:
        if self._closed:
            raise RpcError(StatusCode.CANCELLED, "Channel closed!")
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded")
        try:
            sock = socket.create_connection((self._host, self._port),
                                            timeout=left)
        except socket.timeout:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to {self.address}: {e}") \
                from None
        _tune(sock)
        with self._lock:
            self._open.add(sock)
        return sock

    def _forget(self, sock: socket.socket) -> None:
        with self._lock:
            self._open.discard(sock)
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            open_, self._open = list(self._open), set()
        for sock in open_:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _Call:
    """One call's connection on the client side."""

    def __init__(self, channel: Channel, path: str,
                 timeout: Optional[float], metadata):
        self.deadline = (None if timeout is None
                         else time.monotonic() + timeout)
        self.channel = channel
        self.sock = channel._connect(self.deadline)
        headers = [(":path", path)]
        if timeout is not None:
            headers.append(("grpc-timeout", _timeout_header(timeout)))
        headers += list(metadata or ())
        try:
            self._guard(lambda: _send_frame(self.sock, _HEADER_FLAG,
                                            _encode_headers(headers)))
        except BaseException:
            self.close()
            raise

    def _settime(self) -> None:
        if self.deadline is None:
            self.sock.settimeout(None)
            return
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise socket.timeout()
        self.sock.settimeout(left)

    def _guard(self, fn: Callable):
        """Run a socket step, mapping transport failures to RpcError."""
        try:
            self._settime()
            return fn()
        except RpcError:
            raise
        except socket.timeout:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except (OSError, ConnectionError) as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connection to {self.channel.address} lost: "
                           f"{e}") from None

    def send(self, msg) -> None:
        self._guard(lambda: _send_frame(self.sock, 0,
                                        msg.SerializeToString()))

    def end(self) -> None:
        self._guard(lambda: _send_frame(self.sock, _HEADER_FLAG, b""))

    def replies(self, resp_t: Any) -> Iterator:
        """The response messages; raises RpcError on a status other than
        OK or a connection that ends without a trailer."""
        while True:
            frame = self._guard(lambda: _recv_frame(self.sock))
            if frame is None:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"{self.channel.address} closed the call "
                               "without a status")
            flag, payload = frame
            if flag == _HEADER_FLAG:
                trailer = dict(_decode_headers(payload))
                code = StatusCode(int(trailer.get("grpc-status", 2)))
                if code != StatusCode.OK:
                    raise RpcError(code, trailer.get("grpc-message", ""))
                return
            yield resp_t.FromString(payload)

    def status_after_send_failure(self, err: RpcError) -> RpcError:
        """A send that failed because the server already ended the call:
        its trailer, when it got through, names the real status."""
        try:
            for _ in self.replies(pb.Result):
                pass
        except RpcError as status:
            if status.code() != StatusCode.UNAVAILABLE:
                return status
        return err

    def close(self) -> None:
        self.channel._forget(self.sock)


class _StreamReplies:
    """A server stream's responses: an iterator whose ``cancel()`` (or
    ``close()``, or being dropped) ends the call, which cancels it on the
    server."""

    def __init__(self, call: _Call, resp_t: Any):
        self._call = call
        self._it = call.replies(resp_t)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RpcError(StatusCode.CANCELLED,
                           "Locally cancelled by application!")
        try:
            return next(self._it)
        except StopIteration:
            self.cancel()
            raise
        except RpcError:
            cancelled = self._closed
            self.cancel()
            if cancelled:           # cancel() from another thread
                raise RpcError(StatusCode.CANCELLED,
                               "Locally cancelled by application!") \
                    from None
            raise

    def cancel(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._call.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._call.close()

    close = cancel

    def __del__(self):
        self.cancel()


class BackendStub:
    """Client stub: one callable per METHODS entry, typed by it."""

    def __init__(self, channel: Channel):
        for name, (kind, req_t, resp_t) in METHODS.items():
            setattr(self, name, self._method(channel, f"/{SERVICE}/{name}",
                                             kind, resp_t))

    @staticmethod
    def _method(channel: Channel, path: str, kind: str, resp_t: Any):
        if kind == UNARY:
            def unary(request, timeout=None, metadata=None):
                call = _Call(channel, path, timeout, metadata)
                try:
                    call.send(request)
                    call.end()
                    out = list(call.replies(resp_t))
                finally:
                    call.close()
                if len(out) != 1:
                    raise RpcError(StatusCode.INTERNAL,
                                   f"expected one response, got {len(out)}")
                return out[0]
            return unary
        if kind == SERVER_STREAM:
            def server_stream(request, timeout=None, metadata=None):
                call = _Call(channel, path, timeout, metadata)
                try:
                    call.send(request)
                    call.end()
                except BaseException:
                    call.close()
                    raise
                return _StreamReplies(call, resp_t)
            return server_stream

        def client_stream(request_iterator, timeout=None, metadata=None):
            call = _Call(channel, path, timeout, metadata)
            try:
                try:
                    for req in request_iterator:
                        call.send(req)
                    call.end()
                except RpcError as e:
                    if e.code() != StatusCode.UNAVAILABLE:
                        raise
                    raise call.status_after_send_failure(e) from None
                out = list(call.replies(resp_t))
            finally:
                call.close()
            if len(out) != 1:
                raise RpcError(StatusCode.INTERNAL,
                               f"expected one response, got {len(out)}")
            return out[0]
        return client_stream
