"""Federated serving: an HTTP router balancing requests over many
instances of the server.

Port of ``localai_tpu/federation/server.py`` on the standard library
(``http.server`` threads to listen, ``http.client`` to forward):

  * a registry of instances (``http://host:port``), from a static peer
    list or from instances announcing themselves with
    ``POST /federated/register`` (``{"address"}``; the shared
    ``peer_token`` as a bearer token when one is set, else a 401; an
    address unroutable by construction is a 400);
  * selection: the ``worker_target`` override pins all traffic to one
    node (none while it is offline); otherwise the least-used online
    node (``load_balanced``), ties and the random mode broken at random;
  * a health thread that GETs each node's ``/healthz`` every
    ``health_interval`` seconds, flipping it offline (failures counted)
    and back online (count reset, as a re-registration resets it);
  * every other request, of any method, proxied to the selected node
    with its path, query, headers (but the hop-by-hop ones) and body; a
    node that cannot be connected to is marked offline and the request
    retried on another before any byte went out; once the request was
    sent, a failure is a 502 (retrying could run it twice). The answer
    streams through as it arrives (an SSE stream chunk by chunk, never
    buffered whole), tagged ``X-Federated-Node``; no online node is a
    503. Each request opens its own connection to the node and closes
    both ends after the answer (the JAX router pools node connections in
    one aiohttp session): a connect that fails then means the node never
    saw the request, which is what makes the retry safe;
  * ``GET /federated/nodes``: the registry, ``load_balanced`` and
    ``worker_target``.

:func:`announce` registers an instance with a router from a background
thread, retrying until the router answers.
"""

from __future__ import annotations

import hmac
import http.client
import json
import logging
import random
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlsplit

log = logging.getLogger(__name__)

# connect, read-idle and health-check bounds of the JAX package's client
CONNECT_TIMEOUT_S = 5.0
READ_IDLE_TIMEOUT_S = 600.0
HEALTH_TIMEOUT_S = 3.0
MAX_BODY_BYTES = 64 << 20


def validate_advertised_address(address: str) -> str:
    """Refuse an advertised address that is unroutable by construction:
    no host, a missing, zero, out-of-range or non-numeric port, or a
    wildcard bind address (0.0.0.0, ::, *). A peer advertising one could
    never be dialed back. Returns the address unchanged; raises
    ValueError. Whether a well-formed address answers is the health
    thread's business, not registration's."""
    hostport = address
    for scheme in ("http://", "https://"):
        if hostport.startswith(scheme):
            hostport = hostport[len(scheme):]
            break
    hostport = hostport.split("/", 1)[0]
    if hostport.startswith("["):            # an IPv6 literal: [::1]:8080
        host, _, rest = hostport[1:].partition("]")
        port_s = rest.removeprefix(":")
    else:
        host, _, port_s = hostport.rpartition(":")
    if not host:
        raise ValueError(f"advertised address {address!r} has no host")
    if host in ("0.0.0.0", "::", "*"):
        raise ValueError(
            f"advertised address {address!r} is a wildcard bind address, "
            "not a routable peer address")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"advertised address {address!r} has no numeric port") from None
    if not 1 <= port <= 65535:
        raise ValueError(
            f"advertised address {address!r} has out-of-range port {port}")
    return address


# hop-by-hop headers never forwarded by an HTTP proxy (RFC 9110 §7.6.1),
# and those the forwarding connection sets itself
HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "te", "trailers", "transfer-encoding",
    "upgrade", "host", "content-length",
}


@dataclass
class FederatedNode:
    """One backing instance."""

    id: str
    address: str                    # http://host:port
    online: bool = True
    requests_served: int = 0
    failures: int = 0
    last_seen: float = field(default_factory=time.monotonic)

    def snapshot(self) -> dict:
        return {"id": self.id, "address": self.address,
                "online": self.online,
                "requests_served": self.requests_served}


class FederatedServer:
    """The request router over a registry of instances. ``start`` serves
    it on a thread (port 0 binds a free port: read ``.port``), ``serve``
    blocks; ``shutdown`` stops the listener and the health thread."""

    def __init__(self, nodes: Optional[list[str]] = None, *,
                 load_balanced: bool = True, worker_target: str = "",
                 peer_token: str = "", health_interval: float = 5.0):
        self.load_balanced = load_balanced
        self.worker_target = worker_target
        self.peer_token = peer_token
        self.health_interval = health_interval
        self._lock = threading.Lock()
        self._nodes: dict[str, FederatedNode] = {}
        for addr in nodes or []:
            self.register(addr)
        if worker_target:
            # the pin target must be in the registry, or select() would
            # answer 503 forever when it was not also listed as a peer
            self.register(worker_target)
        self._stop = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: list[threading.Thread] = []
        self.address, self.port = "", 0

    # -- registry -----------------------------------------------------------

    @staticmethod
    def _node_id(address: str) -> str:
        return address.removeprefix("http://").removeprefix("https://")

    def register(self, address: str) -> FederatedNode:
        if not address.startswith(("http://", "https://")):
            address = f"http://{address}"
        nid = self._node_id(address)
        with self._lock:
            node = self._nodes.get(nid)
            if node is None:
                node = FederatedNode(id=nid, address=address)
                self._nodes[nid] = node
                log.info("federation: registered node %s", nid)
            node.online = True
            # a node registering again rejoins: its failure count starts
            # over, as the fleet pool's rejoin resets its backoff
            node.failures = 0
            node.last_seen = time.monotonic()
            return node

    def nodes(self) -> list[FederatedNode]:
        with self._lock:
            return list(self._nodes.values())

    def online_nodes(self) -> list[FederatedNode]:
        return [n for n in self.nodes() if n.online]

    # -- selection ----------------------------------------------------------

    def select(self, exclude: frozenset[str] = frozenset()
               ) -> Optional[FederatedNode]:
        if self.worker_target:
            with self._lock:
                n = self._nodes.get(self._node_id(self.worker_target))
            if n is not None and n.online and n.id not in exclude:
                return n
            return None
        candidates = [n for n in self.online_nodes() if n.id not in exclude]
        if not candidates:
            return None
        if self.load_balanced:
            low = min(n.requests_served for n in candidates)
            candidates = [n for n in candidates if n.requests_served == low]
        return random.choice(candidates)

    def record_request(self, node: FederatedNode) -> None:
        with self._lock:
            node.requests_served += 1

    def mark_offline(self, node: FederatedNode) -> None:
        with self._lock:
            node.online = False
            node.failures += 1
        log.warning("federation: node %s marked offline", node.id)

    # -- health -------------------------------------------------------------

    def check_health(self) -> None:
        """One sweep: GET each node's ``/healthz`` (200 = online)."""
        for node in self.nodes():
            try:
                with urllib.request.urlopen(f"{node.address}/healthz",
                                            timeout=HEALTH_TIMEOUT_S) as r:
                    ok = r.status == 200
            except Exception:  # noqa: BLE001 — any failure means offline
                ok = False
            with self._lock:
                if ok:
                    if not node.online:
                        log.info("federation: node %s back online", node.id)
                        node.failures = 0
                    node.online = True
                    node.last_seen = time.monotonic()
                else:
                    node.online = False
                    node.failures += 1

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval):
            self.check_health()

    # -- serving ------------------------------------------------------------

    def start(self, address: str = "127.0.0.1",
              port: int = 0) -> "FederatedServer":
        self._httpd = _RouterHTTPServer((address, port), self)
        self.address, self.port = self._httpd.server_address[:2]
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever,
                             name="federation-http", daemon=True),
            threading.Thread(target=self._health_loop,
                             name="federation-health", daemon=True)]
        for t in self._threads:
            t.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.address}:{self.port}"

    def serve(self, address: str = "0.0.0.0", port: int = 8080) -> None:
        """Serve until interrupted."""
        self.start(address, port)
        log.info("federated router on %s:%d (%d nodes)", self.address,
                 self.port, len(self.nodes()))
        try:
            while self._threads[0].is_alive():
                self._threads[0].join(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(HEALTH_TIMEOUT_S * 2)
        self._threads = []


class _RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, fed: FederatedServer):
        super().__init__(addr, _RouterHandler)
        self.fed = fed


def _json_body(payload: dict) -> bytes:
    return json.dumps(payload).encode("utf-8")


class _RouterHandler(BaseHTTPRequestHandler):
    server: _RouterHTTPServer

    def log_message(self, fmt, *args):  # access logs to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, status: int, payload: dict) -> None:
        body = _json_body(payload)
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            out = bytearray()
            while True:
                size = int(self.rfile.readline().split(b";")[0].strip()
                           or b"0", 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n",
                                                        b""):
                        pass        # trailers
                    return bytes(out)
                out += self.rfile.read(size)
                self.rfile.readline()
                if len(out) > MAX_BODY_BYTES:
                    raise ValueError("request body too large")
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_BODY_BYTES:
            raise ValueError("request body too large")
        return self.rfile.read(n) if n else b""

    def _dispatch(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/federated/nodes" and self.command == "GET":
            return self._nodes()
        if path == "/federated/register" and self.command == "POST":
            return self._register()
        self._proxy()

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _dispatch  # noqa: N815
    do_OPTIONS = do_HEAD = _dispatch  # noqa: N815

    def _nodes(self) -> None:
        fed = self.server.fed
        self._json(200, {"nodes": [n.snapshot() for n in fed.nodes()],
                         "load_balanced": fed.load_balanced,
                         "worker_target": fed.worker_target})

    def _register(self) -> None:
        fed = self.server.fed
        try:
            raw = self._read_body()
        except ValueError:
            return self._json(400, {"error": "address is required"})
        if fed.peer_token:
            token = self.headers.get("Authorization", "").removeprefix(
                "Bearer ").strip()
            if not hmac.compare_digest(token, fed.peer_token):
                return self._json(401, {"error": "invalid peer token"})
        try:
            address = str(json.loads(raw)["address"])
        except Exception:  # noqa: BLE001 — any unusable body
            return self._json(400, {"error": "address is required"})
        try:
            validate_advertised_address(address)
        except ValueError as e:
            return self._json(400, {"error": str(e)})
        self._json(200, fed.register(address).snapshot())

    def _proxy(self) -> None:
        """Forward to a selected node and stream its answer through. A
        node that cannot be connected to is marked offline and the
        request retried on another: nothing reached it, so nothing can
        run twice."""
        fed = self.server.fed
        try:
            body = self._read_body()
        except ValueError as e:
            return self._json(413, {"error": {
                "message": str(e), "type": "federation_error",
                "code": 413}})
        headers = {k: v for k, v in self.headers.items()
                   if k.lower() not in HOP_HEADERS}
        tried: set[str] = set()
        while True:
            node = fed.select(exclude=frozenset(tried))
            if node is None:
                return self._json(503, {"error": {
                    "message": "no online federation nodes",
                    "type": "federation_error", "code": 503}})
            tried.add(node.id)
            fed.record_request(node)
            parts = urlsplit(node.address)
            conn_cls = (http.client.HTTPSConnection
                        if parts.scheme == "https"
                        else http.client.HTTPConnection)
            conn = conn_cls(parts.hostname, parts.port,
                            timeout=CONNECT_TIMEOUT_S)
            try:
                conn.connect()
            except OSError as e:
                conn.close()
                fed.mark_offline(node)
                log.warning("federation: %s unreachable (%s); failing over",
                            node.id, e)
                continue
            try:
                conn.sock.settimeout(READ_IDLE_TIMEOUT_S)
                conn.request(self.command, self.path,
                             body=body if body else None, headers=headers)
                upstream = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                # the request may have reached the node: retrying could
                # run a call that is not idempotent twice
                conn.close()
                fed.mark_offline(node)
                log.warning("federation: %s failed mid-request (%s)",
                            node.id, e)
                return self._json(502, {"error": {
                    "message": f"federation node {node.id} failed "
                               f"mid-request: {e}",
                    "type": "federation_error", "code": 502}})
            try:
                self._stream(upstream, node)
            finally:
                conn.close()
            return

    def _stream(self, upstream: http.client.HTTPResponse,
                node: FederatedNode) -> None:
        """The node's answer, as it arrives: with its length when it has
        one, else delimited by the connection's close."""
        self.send_response(upstream.status, upstream.reason)
        length = upstream.getheader("Content-Length")
        for k, v in upstream.getheaders():
            if k.lower() not in HOP_HEADERS and k.lower() not in (
                    "server", "date"):
                self.send_header(k, v)
        if length is not None:
            self.send_header("Content-Length", length)
        self.send_header("X-Federated-Node", node.id)
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        if self.command == "HEAD":
            return
        try:
            while True:
                chunk = upstream.read1(65536)
                if not chunk:
                    break
                self.wfile.write(chunk)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass            # the client went away: drop the node's answer
        except (OSError, http.client.HTTPException) as e:
            log.warning("federation: %s failed while streaming (%s)",
                        node.id, e)


def announce(router: str, own_address: str, peer_token: str = "", *,
             retries: int = 30, interval: float = 2.0) -> threading.Thread:
    """Register this instance with a federated router, retrying in the
    background until the router answers. Returns the announcing
    thread."""

    def run() -> None:
        url = f"{router.rstrip('/')}/federated/register"
        payload = json.dumps({"address": own_address}).encode()
        for _ in range(retries):
            try:
                req = urllib.request.Request(
                    url, data=payload,
                    headers={"Content-Type": "application/json",
                             **({"Authorization": f"Bearer {peer_token}"}
                                if peer_token else {})})
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    if resp.status == 200:
                        log.info("announced %s to federation router %s",
                                 own_address, router)
                        return
            except Exception as e:  # noqa: BLE001
                log.debug("federation announce retry: %s", e)
            time.sleep(interval)
        log.warning("could not announce to federation router %s", router)

    t = threading.Thread(target=run, name="fed-announce", daemon=True)
    t.start()
    return t
