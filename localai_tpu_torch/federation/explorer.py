"""Explorer: a discovery dashboard over many federation routers.

Port of ``localai_tpu/federation/explorer.py`` on the standard library.
A network is a federation router's URL (its node registry is the
network): :class:`ExplorerDB` persists the tracked routers as JSON, a
:class:`DiscoveryMonitor` thread dial-tests each one's
``/federated/nodes`` on an interval, keeps a snapshot of its nodes, and
evicts a router after ``failure_threshold`` consecutive failed sweeps.
The HTTP side (:class:`ExplorerServer`, ``http.server`` threads):

  * ``GET /``: the dashboard (refreshes itself every 10 s); routers not
    checked yet are dial-tested at once, together, under one 2 s
    deadline, without counting a failure (a page load is not a sweep);
  * ``GET /api/networks``: every tracked router with its snapshot;
    ``POST /api/networks`` ``{"url", "name"}`` tracks one (an URL that is
    not http(s) is a 400); ``DELETE /api/networks?url=`` forgets one
    (404 if it was not tracked);
  * ``GET /api/nodes``: the nodes of the router given at start (502 when
    it does not answer).
"""

from __future__ import annotations

import html
import json
import logging
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor, wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)


def fetch_nodes(router: str, timeout: float = 5.0) -> dict:
    url = f"{router.rstrip('/')}/federated/nodes"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


class ExplorerDB:
    """The tracked routers with their failure counts, as JSON on disk
    (none with no path), thread-safe."""

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        if self.path and self.path.exists():
            try:
                self._entries = json.loads(self.path.read_text())
            except (OSError, ValueError):
                log.warning("explorer db %s unreadable; starting empty",
                            self.path)

    def _persist(self) -> None:  # jaxlint: guarded-by(_lock)
        if self.path is None:
            return
        try:
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._entries))
            tmp.replace(self.path)
        except OSError as e:
            # a full disk must not kill the monitor thread: the db keeps
            # working in memory and is written again at the next change
            log.warning("explorer db persist failed: %s", e)

    def add(self, url: str, name: str = "") -> None:
        url = url.rstrip("/")
        with self._lock:
            self._entries.setdefault(url, {
                "name": name or url, "failures": 0, "added_at": time.time()})
            if name:
                self._entries[url]["name"] = name
            self._persist()

    def remove(self, url: str) -> bool:
        with self._lock:
            gone = self._entries.pop(url.rstrip("/"), None) is not None
            self._persist()
            return gone

    def routers(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def entries(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def mark_ok(self, url: str) -> None:
        with self._lock:
            if url in self._entries:
                self._entries[url]["failures"] = 0
                self._persist()

    def mark_failed(self, url: str, threshold: int) -> bool:
        """One more failure; at ``threshold`` the router is evicted (and
        True returned)."""
        with self._lock:
            e = self._entries.get(url)
            if e is None:
                return False
            e["failures"] = int(e.get("failures", 0)) + 1
            if e["failures"] >= threshold:
                del self._entries[url]
                self._persist()
                log.info("explorer: evicting %s after %d failures",
                         url, threshold)
                return True
            self._persist()
            return False


class DiscoveryMonitor:
    """The background dial-tester: one router after another, each with a
    deadline, counting failures toward eviction and keeping a snapshot of
    the nodes each answered with."""

    def __init__(self, db: ExplorerDB, *, interval: float = 50.0,
                 failure_threshold: int = 3, timeout: float = 5.0):
        self.db = db
        self.interval = interval
        self.failure_threshold = failure_threshold
        self.timeout = timeout
        self._lock = threading.Lock()
        self._state: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self, only: Optional[set] = None,
                  count_failures: bool = True) -> None:
        """One sweep (of the routers in ``only`` when given);
        ``count_failures=False`` updates the snapshots without moving the
        eviction counts."""
        for url in self.db.routers():
            if only is not None and url not in only:
                continue
            self._dial_one(url, count_failures)

    def _dial_one(self, url: str, count_failures: bool = True,
                  timeout: Optional[float] = None) -> None:
        """Dial-test one router and fold the result into the snapshot."""
        # durations from the monotonic clock; checked_at is for display
        t0 = time.monotonic()
        try:
            data = fetch_nodes(url, timeout=timeout or self.timeout)
            dial = time.monotonic() - t0
            nodes = data.get("nodes", [])
            if url not in self.db.routers():
                return  # forgotten while the dial was in flight
            with self._lock:
                self._state[url] = {
                    "ok": True, "nodes": nodes,
                    "online": sum(1 for n in nodes if n.get("online")),
                    "checked_at": time.time(),
                    "checked_mono": time.monotonic(),
                    "dial_seconds": round(dial, 3)}
            self.db.mark_ok(url)
        except Exception as e:  # noqa: BLE001 — the dial test failed
            dial = time.monotonic() - t0
            evicted = (count_failures and self.db.mark_failed(
                url, self.failure_threshold))
            with self._lock:
                if evicted or url not in self.db.routers():
                    self._state.pop(url, None)
                else:
                    self._state[url] = {
                        "ok": False, "error": str(e), "nodes": [],
                        "online": 0, "checked_at": time.time(),
                        "checked_mono": time.monotonic(),
                        "dial_seconds": round(dial, 3)}

    def warmup(self, urls: set, *, deadline: float = 2.0,
               count_failures: bool = False) -> None:
        """Dial-test ``urls`` together under one overall ``deadline``:
        those that answer in time show at once, the rest stay "not checked
        yet" while their dials finish on pool threads (each with the
        monitor's full timeout) and fold in for the next refresh."""
        urls = {u for u in urls if u in self.db.routers()}
        if not urls:
            return
        pool = ThreadPoolExecutor(max_workers=min(8, len(urls)),
                                  thread_name_prefix="explorer-warmup")
        futures = [pool.submit(self._dial_one, u, count_failures,
                               self.timeout) for u in urls]
        wait(futures, timeout=deadline)
        # never join the stragglers: that would serialize the page again
        pool.shutdown(wait=False)

    def state(self) -> dict[str, dict]:
        now = time.monotonic()
        out: dict[str, dict] = {}
        with self._lock:
            for url, snap in self._state.items():
                d = dict(snap)
                mono = d.pop("checked_mono", None)
                if mono is not None:
                    d["age_seconds"] = round(now - mono, 1)
                out[url] = d
        return out

    def forget(self, url: str) -> None:
        """Drop a router's snapshot (a router tracked again is dial-tested
        afresh)."""
        with self._lock:
            self._state.pop(url.rstrip("/"), None)

    def start(self) -> None:
        if self._thread is not None:
            return

        def run():
            while not self._stop.is_set():
                self.poll_once()
                self._stop.wait(self.interval)

        self._stop.clear()
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="explorer-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def render_index(mon: DiscoveryMonitor) -> str:
    """The dashboard: routers not checked yet are dial-tested first."""
    entries = mon.db.entries()
    state = mon.state()
    missing = {url for url in entries if url not in state}
    if missing:
        mon.warmup(missing, deadline=2.0, count_failures=False)
        entries = mon.db.entries()
        state = mon.state()
    sections = []
    for url, meta in sorted(entries.items()):
        st = state.get(url, {})
        rows = "".join(
            f"<tr><td>{html.escape(str(n.get('id', '?')))}</td>"
            f"<td>{'🟢 online' if n.get('online') else '🔴 offline'}</td>"
            f"<td>{n.get('requests_served', 0)}</td></tr>"
            for n in st.get("nodes", []))
        status = ("not checked yet" if not st else
                  f"{st.get('online', 0)}/{len(st.get('nodes', []))} online"
                  if st.get("ok") else
                  f"unreachable ({html.escape(str(st.get('error', '')))}), "
                  f"failures {meta.get('failures', 0)}"
                  f"/{mon.failure_threshold}")
        sections.append(
            f"<h3>{html.escape(meta.get('name', url))}</h3>"
            f"<p><code>{html.escape(url)}</code> — {status}</p>"
            f"<table><tr><th>Node</th><th>Status</th><th>Requests</th></tr>"
            f"{rows or '<tr><td colspan=3>no nodes</td></tr>'}</table>")
    return f"""<!doctype html><html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="10">
<title>LocalAI-TPU explorer</title>
<style>body{{font:15px system-ui;background:#0f1217;color:#e6e9ee;
margin:2rem auto;max-width:760px}}td,th{{padding:.4rem .6rem;text-align:
left;border-bottom:1px solid #2a3240}}table{{width:100%;border-collapse:
collapse}}code{{color:#8fd0ff}}</style></head><body>
<h2>Federation explorer</h2>
<p style="color:#8b95a5">{len(entries)} network(s) tracked; dial-tested
every {int(mon.interval)}s; evicted after
{mon.failure_threshold} consecutive failures.
Register: <code>POST /api/networks {{"url": "http://router:8080"}}</code></p>
{''.join(sections) or '<p>no networks registered</p>'}
</body></html>"""


class ExplorerServer:
    """The explorer's HTTP side over a monitor (``start`` on a thread,
    port 0 binds a free port; ``serve`` blocks; ``shutdown``)."""

    def __init__(self, router: str = "", *, db_path: Optional[str] = None,
                 interval: float = 50.0, failure_threshold: int = 3,
                 start_monitor: bool = False):
        self.router = router
        db = ExplorerDB(db_path)
        if router:
            db.add(router)
        self.monitor = DiscoveryMonitor(db, interval=interval,
                                        failure_threshold=failure_threshold)
        self.start_monitor = start_monitor
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.address, self.port = "", 0

    @property
    def url(self) -> str:
        return f"http://{self.address}:{self.port}"

    def start(self, address: str = "127.0.0.1",
              port: int = 0) -> "ExplorerServer":
        self._httpd = ThreadingHTTPServer((address, port), _ExplorerHandler)
        self._httpd.daemon_threads = True
        self._httpd.explorer = self
        self.address, self.port = self._httpd.server_address[:2]
        if self.start_monitor:
            self.monitor.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="explorer-http", daemon=True)
        self._thread.start()
        return self

    def serve(self, address: str = "0.0.0.0", port: int = 8085) -> None:
        self.start(address, port)
        try:
            while self._thread.is_alive():
                self._thread.join(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None
        self.monitor.stop()


class _ExplorerHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # access logs to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, payload: dict) -> None:
        self._send(status, json.dumps(payload).encode("utf-8"),
                   "application/json; charset=utf-8")

    def _text(self, status: int, text: str) -> None:
        self._send(status, text.encode("utf-8"), "text/plain; charset=utf-8")

    def _route(self):
        path, _, qs = self.path.partition("?")
        ex: ExplorerServer = self.server.explorer
        query = {k: v[-1] for k, v in urllib.parse.parse_qs(qs).items()}
        routes = {("GET", "/"): self._index,
                  ("GET", "/api/networks"): self._networks,
                  ("POST", "/api/networks"): self._add_network,
                  ("DELETE", "/api/networks"): self._del_network,
                  ("GET", "/api/nodes"): self._nodes}
        fn = routes.get((self.command, path))
        if fn is not None:
            return fn(ex, query)
        if any(p == path for _, p in routes):
            return self._text(405, "405: Method Not Allowed")
        self._text(404, "404: Not Found")

    do_GET = do_POST = do_DELETE = _route  # noqa: N815

    def _index(self, ex: "ExplorerServer", query: dict) -> None:
        self._send(200, render_index(ex.monitor).encode("utf-8"),
                   "text/html; charset=utf-8")

    def _networks(self, ex: "ExplorerServer", query: dict) -> None:
        mon = ex.monitor
        entries, state = mon.db.entries(), mon.state()
        self._json(200, {"networks": [{"url": url, **meta,
                                       **state.get(url, {})}
                                      for url, meta in entries.items()]})

    def _add_network(self, ex: "ExplorerServer", query: dict) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(n))
            if not isinstance(body, dict):
                raise ValueError("not an object")
        except ValueError:
            return self._text(400, "body must be JSON")
        url = str(body.get("url", "")).strip()
        if not url.startswith(("http://", "https://")):
            return self._text(400, "url must be http(s)")
        ex.monitor.db.add(url, name=str(body.get("name", "")))
        self._json(200, {"ok": True, "tracked": len(ex.monitor.db.routers())})

    def _del_network(self, ex: "ExplorerServer", query: dict) -> None:
        url = query.get("url", "")
        if not ex.monitor.db.remove(url):
            return self._text(404, "network not tracked")
        ex.monitor.forget(url)
        self._json(200, {"ok": True})

    def _nodes(self, ex: "ExplorerServer", query: dict) -> None:
        try:
            self._json(200, fetch_nodes(ex.router))
        except Exception as e:  # noqa: BLE001 — the router's failure
            self._json(502, {"error": str(e)})


def serve_explorer(router: str, address: str = "0.0.0.0", port: int = 8085,
                   *, db_path: Optional[str] = None, interval: float = 50.0,
                   failure_threshold: int = 3) -> None:
    """The ``explorer`` command: the dashboard with its monitor running,
    until interrupted."""
    log.info("explorer on %s:%d over router %s (db=%s)",
             address, port, router, db_path or "<memory>")
    ExplorerServer(router, db_path=db_path, interval=interval,
                   failure_threshold=failure_threshold,
                   start_monitor=True).serve(address, port)
