"""The port's federation router and explorer against the JAX package's, on
the CPU.

Mirrors ``tests/test_federation.py`` for the port's stdlib router and
explorer, and holds them against the JAX package's aiohttp ones:

  * ``validate_advertised_address`` and the swarm page's ``_norm_router``
    answer one table of addresses alike (equal results, or the same
    error);
  * selection, offline exclusion, the target pin and re-registration
    answer as the JAX router's over the same registry;
  * both routers in front of the same two stub instances: equal
    least-used spreads, ``/federated/nodes`` bodies, peer-token refusals,
    unroutable-address refusals, failover to the live stub, eviction by
    health checks, and the 503 with every node down; the port's router
    passes an SSE stream through frame by frame (a frame arrives while
    the stub still holds the next one);
  * a tiny model's streamed chat through the port's router, through the
    JAX router and direct from the port's server: the same text;
  * the explorer: its database (a file written by either package read
    by the other), the monitor's failure-count eviction, the dashboard
    and the ``/api/*`` routes with the JAX explorer's status codes, and
    the warm-up bounded by one deadline over routers that never answer
    (local sockets that accept and stay silent).
"""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")
httpx = pytest.importorskip("httpx")

from localai_tpu.api import ui as jui  # noqa: E402
from localai_tpu.federation import FederatedServer as JaxFed  # noqa: E402
from localai_tpu.federation import explorer as jexplorer  # noqa: E402
from localai_tpu.federation import server as jserver  # noqa: E402
from localai_tpu_torch.api import ui  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.federation import FederatedServer, announce  # noqa: E402
from localai_tpu_torch.federation import explorer  # noqa: E402
from localai_tpu_torch.federation import server as fserver  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from test_federation import _AppThread, _instance_app, _one_health_pass  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

WAIT = 30.0

ADDRESSES = [
    "127.0.0.1:8080", "http://node-7:9090", "https://node-7:443/x",
    "[::1]:9001", "http://[::1]:9001", "", ":1", ":8080", "host:", "host:0",
    "0.0.0.0:5", "*:5", "[::]:8080", "https://:8080", "host:-1",
    "127.0.0.1", "127.0.0.1:http", "127.0.0.1:70000", "HTTP://Router:80/",
    "http://router", "https://router/", "http://u:p@10.0.0.1:80",
    "http://127.0.0.1:x@10.99.0.1:8500", "ftp://x", "http://h:notaport",
    "http://h/x?q", "http://Host:8080/a/b/",
]


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("address", ADDRESSES)
def test_address_checks_as_the_jax_package(address):
    assert _outcome(fserver.validate_advertised_address, address) == \
        _outcome(jserver.validate_advertised_address, address)
    assert ui._norm_router(address) == jui._norm_router(address)


# -- selection over one registry -------------------------------------------

def test_least_used_selection_as_the_jax_router():
    for cls in (FederatedServer, JaxFed):
        fed = cls(["n1:1", "n2:1"], load_balanced=True)
        n1, n2 = fed.nodes()
        n1.requests_served = 5
        assert fed.select() is n2
        n2.requests_served = 9
        assert fed.select() is n1


def test_offline_exclusion_and_target_pin_as_the_jax_router():
    seen = []
    for cls in (FederatedServer, JaxFed):
        fed = cls(["n1:1", "n2:1"], load_balanced=True)
        n1, n2 = fed.nodes()
        fed.mark_offline(n1)
        got = [fed.select().id]
        fed.mark_offline(n2)
        got.append(fed.select())
        pinned = cls(["n1:1", "n2:1"], worker_target="n2:1")
        got.append(pinned.select().id)
        pinned.mark_offline(pinned.select())
        got.append(pinned.select())
        # a pin target not among the peers joins the registry
        solo = cls([], worker_target="n3:1")
        got.append([n.snapshot() for n in solo.nodes()])
        seen.append(got)
    assert seen[0] == seen[1] == [
        "n2:1", None, "n2:1", None,
        [{"id": "n3:1", "address": "http://n3:1", "online": True,
          "requests_served": 0}]]


def test_register_revives_and_resets_failures_as_the_jax_router():
    seen = []
    for cls in (FederatedServer, JaxFed):
        fed = cls([])
        n = fed.register("127.0.0.1:9000")
        fed.mark_offline(n)
        fed.mark_offline(n)
        failures = n.failures
        again = fed.register("http://127.0.0.1:9000")
        seen.append((again is n, failures, n.online, n.failures,
                     len(fed.nodes()), n.snapshot()))
    assert seen[0] == seen[1]
    assert seen[0][:5] == (True, 2, True, 0, 1)


# -- both routers over the same two stubs ----------------------------------

@pytest.fixture()
def stubs():
    a, b = _AppThread(_instance_app("a")), _AppThread(_instance_app("b"))
    yield a, b
    for s in (a, b):
        s.stop()


class _Routers:
    """The port's and the JAX router over the same peers."""

    def __init__(self, peers, **kw):
        self.port = FederatedServer(list(peers), **kw).start()
        self.jfed = JaxFed(list(peers), **kw)
        self.jax = _AppThread(self.jfed.create_app())

    def each(self):
        return ((self.port, self.port.url),
                (self.jfed, f"http://{self.jax.addr}"))

    def stop(self):
        self.port.shutdown()
        self.jax.stop()


@pytest.fixture()
def routers(stubs):
    a, b = stubs
    r = _Routers([a.addr, b.addr], load_balanced=True, health_interval=3600)
    yield a, b, r
    r.stop()


def test_routers_spread_and_pass_through_alike(routers):
    a, b, r = routers
    out = []
    for fed, base in r.each():
        with httpx.Client(base_url=base, timeout=WAIT) as c:
            seen, nodes = [], []
            for _ in range(6):
                resp = c.post("/v1/chat/completions", json={"x": 1})
                assert resp.status_code == 200
                seen.append(resp.json()["instance"])
                nodes.append(resp.headers["X-Federated-Node"])
            echo = c.post("/v1/some/path?q=2", content=b"payload").json()
            listed = c.get("/federated/nodes").json()
        # the seventh request breaks a tie at random: its node is not
        # compared, its counts are
        echo.pop("instance")
        out.append((sorted(seen), sorted(nodes), echo,
                    sorted(n["id"] for n in listed["nodes"]),
                    sorted(n["requests_served"] for n in listed["nodes"]),
                    sorted(listed), listed["load_balanced"],
                    listed["worker_target"]))
    assert out[0] == out[1]
    # least-used over two equal nodes alternates: three each
    assert out[0][0] == ["a"] * 3 + ["b"] * 3
    assert out[0][2] == {"path": "/v1/some/path?q=2", "echo": "payload"}
    assert out[0][4] == [3, 4]


def test_registration_token_and_refusals_as_the_jax_router(routers):
    a, b, r = routers
    bad = [":8080", "127.0.0.1:0", "127.0.0.1", "127.0.0.1:http",
           "127.0.0.1:70000", "0.0.0.0:8080", "[::]:8080"]
    out = []
    for fed, base in r.each():
        fed.peer_token = "sekrit"
        auth = {"Authorization": "Bearer sekrit"}
        with httpx.Client(base_url=base, timeout=WAIT) as c:
            calls = [c.post("/federated/register",
                            json={"address": "127.0.0.1:1"}),
                     c.post("/federated/register",
                            json={"address": "127.0.0.1:1"},
                            headers={"Authorization": "Bearer wrong"}),
                     c.post("/federated/register", json={"nope": 1},
                            headers=auth),
                     c.post("/federated/register", content=b"{",
                            headers=auth)]
            calls += [c.post("/federated/register", json={"address": x},
                             headers=auth) for x in bad]
            calls.append(c.post("/federated/register",
                                json={"address": "[::1]:9001"},
                                headers=auth))
        out.append(([(x.status_code, x.json()) for x in calls],
                    sorted(n.id for n in fed.nodes())))
    assert out[0] == out[1]
    codes = [s for s, _ in out[0][0]]
    assert codes == [401, 401, 400, 400] + [400] * len(bad) + [200]
    assert out[0][1] == sorted([a.addr, b.addr, "[::1]:9001"])


def test_failover_and_eviction_as_the_jax_router(routers):
    a, b, r = routers
    b.stop()
    out = []
    for fed, base in r.each():
        b_node = next(n for n in fed.nodes() if n.id == b.addr)
        for n in fed.nodes():
            n.requests_served = 0
        b_node.requests_served = -1      # the dead node is chosen first
        with httpx.Client(base_url=base, timeout=WAIT) as c:
            resp = c.get("/v1/anything")
            out.append([resp.status_code, resp.json()["instance"],
                        b_node.online, b_node.failures])
    assert out[0] == out[1] == [200, "a", False, 1]
    # health checks evict the dead node and keep the live one, alike
    r.port.check_health()
    asyncio.run(_one_health_pass(r.jfed))
    states = [sorted((n.id, n.online, n.failures) for n in fed.nodes())
              for fed, _ in r.each()]
    assert states[0] == states[1] == sorted([(a.addr, True, 0),
                                             (b.addr, False, 2)])
    # every node down: a clean 503 with the same body
    a.stop()
    bodies = []
    for fed, base in r.each():
        with httpx.Client(base_url=base, timeout=WAIT) as c:
            resp = c.get("/v1/anything")
            bodies.append((resp.status_code, resp.json()))
    assert bodies[0] == bodies[1]
    assert bodies[0][0] == 503


def test_health_revives_a_node_and_counts_failures_as_the_jax_router():
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))       # bound, never listening: refused
    port = dead.getsockname()[1]
    try:
        out = []
        for fed, sweep in ((FederatedServer([f"127.0.0.1:{port}"]),
                            lambda f: f.check_health()),
                           (JaxFed([f"127.0.0.1:{port}"]),
                            lambda f: asyncio.run(_one_health_pass(f)))):
            node = fed.nodes()[0]
            sweep(fed)
            sweep(fed)
            out.append((node.online, node.failures))
        assert out[0] == out[1] == (False, 2)
    finally:
        dead.close()
    stub = _AppThread(_instance_app("up"))
    try:
        out = []
        for fed, sweep in ((FederatedServer([stub.addr]),
                            lambda f: f.check_health()),
                           (JaxFed([stub.addr]),
                            lambda f: asyncio.run(_one_health_pass(f)))):
            node = fed.nodes()[0]
            fed.mark_offline(node)
            before = node.failures
            sweep(fed)
            out.append((before, node.online, node.failures))
        assert out[0] == out[1] == (1, True, 0)
    finally:
        stub.stop()


def test_port_router_streams_frame_by_frame():
    """The answer passes through as it arrives: the client reads the first
    SSE frame while the instance still holds the second."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    release = threading.Event()

    class Slow(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                body = b'{"status": "ok"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            self.wfile.write(b"data: one\n\n")
            self.wfile.flush()
            release.wait(WAIT)
            self.wfile.write(b"data: two\n\n")

    slow = ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    slow.daemon_threads = True
    threading.Thread(target=slow.serve_forever, daemon=True).start()
    fed = FederatedServer([f"127.0.0.1:{slow.server_address[1]}"],
                          health_interval=3600).start()
    try:
        with urllib.request.urlopen(fed.url + "/sse", timeout=WAIT) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            first = r.readline()
            released_before = release.is_set()
            release.set()
            rest = r.read()
        assert first == b"data: one\n" and not released_before
        assert rest == b"\ndata: two\n\n"
    finally:
        release.set()
        fed.shutdown()
        slow.shutdown()
        slow.server_close()


def test_announce_registers_with_the_port_router():
    stub = _AppThread(_instance_app("solo"))
    fed = FederatedServer([], peer_token="tok", health_interval=3600)
    try:
        # the router comes up after the first attempts failed
        port = _free_port()
        t = announce(f"http://127.0.0.1:{port}", f"http://{stub.addr}",
                     peer_token="tok", retries=40, interval=0.1)
        time.sleep(0.3)
        fed.start("127.0.0.1", port)
        t.join(WAIT)
        assert [n.id for n in fed.nodes()] == [stub.addr]
    finally:
        fed.shutdown()
        stub.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- a model behind both routers -------------------------------------------

def _chat_text(url: str, body: dict) -> str:
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    text = ""
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            line = line.strip()
            if line.startswith(b"data: {"):
                frame = json.loads(line[6:])
                if frame.get("choices"):
                    text += frame["choices"][0]["delta"].get("content") or ""
    return text


def test_streamed_chat_through_both_routers_equals_direct(tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    (models / "tiny.yaml").write_text(json.dumps({
        "name": "tiny", "model": "debug:tiny", "context_size": 128,
        "engine": {"dtype": "float32", "kv_dtype": "float32",
                   "max_slots": 2, "spec": False}}))
    loader = ConfigLoader(str(models))
    loader.load_from_path()
    app = AppConfig(model_path=str(models), device="cpu",
                    config_path=str(tmp_path / "conf"),
                    upload_path=str(tmp_path / "up"))
    srv = APIServer(ModelManager(app, loader), "127.0.0.1", 0).start()
    host = f"127.0.0.1:{srv.port}"
    fed = FederatedServer([host], health_interval=3600).start()
    jfed = JaxFed([host], health_interval=3600)
    jrouter = _AppThread(jfed.create_app())
    body = {"model": "tiny", "stream": True, "max_tokens": 12,
            "temperature": 0, "messages": [{"role": "user",
                                            "content": "federate me"}]}
    try:
        direct = _chat_text(srv.url, body)
        assert direct
        assert _chat_text(fed.url, body) == direct
        assert _chat_text(f"http://{jrouter.addr}", body) == direct
        assert [n.requests_served for n in fed.nodes()] == \
            [n.requests_served for n in jfed.nodes()] == [1]
    finally:
        jrouter.stop()
        fed.shutdown()
        srv.shutdown()


# -- the explorer ----------------------------------------------------------

def test_explorer_db_files_are_shared(tmp_path):
    for write, read in ((explorer.ExplorerDB, jexplorer.ExplorerDB),
                        (jexplorer.ExplorerDB, explorer.ExplorerDB)):
        path = tmp_path / f"{write.__module__.split('.')[0]}.json"
        db = write(path)
        db.add("http://r1:1/", name="one")
        db.add("http://r2:2")
        assert not db.mark_failed("http://r2:2", 3)
        other = read(path)
        assert other.routers() == db.routers() == ["http://r1:1",
                                                   "http://r2:2"]
        assert {u: (e["name"], e["failures"])
                for u, e in other.entries().items()} == {
            "http://r1:1": ("one", 0), "http://r2:2": ("http://r2:2", 1)}


def test_monitor_evicts_as_the_jax_monitor(tmp_path):
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_url = f"http://127.0.0.1:{dead.getsockname()[1]}"
    fed = FederatedServer(["live:9993"], health_interval=3600).start()
    try:
        out = []
        for mod in (explorer, jexplorer):
            db = mod.ExplorerDB(tmp_path / f"{mod.__name__}.json")
            db.add(dead_url, name="dead")
            db.add(fed.url, name="live-net")
            mon = mod.DiscoveryMonitor(db, interval=3600,
                                       failure_threshold=3, timeout=2.0)
            mon.poll_once()
            st = mon.state()
            first = (st[fed.url]["ok"], st[fed.url]["nodes"],
                     db.entries()[dead_url]["failures"],
                     sorted(st[dead_url]))
            mon.poll_once(count_failures=False)
            mon.poll_once()
            mon.poll_once()
            out.append((first, db.routers(),
                        mod.ExplorerDB(db.path).routers()))
        assert out[0] == out[1]
        assert out[0][1] == [fed.url]
    finally:
        fed.shutdown()
        dead.close()


def test_explorer_routes_as_the_jax_explorer(tmp_path):
    fed = FederatedServer(["apinode:9994"], health_interval=3600).start()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_url = f"http://127.0.0.1:{dead.getsockname()[1]}"
    port = explorer.ExplorerServer(
        db_path=str(tmp_path / "port.json"), interval=3600).start()
    jax = _AppThread(jexplorer.create_explorer_app(
        db_path=str(tmp_path / "jax.json"), interval=3600))
    single = explorer.ExplorerServer(fed.url, interval=3600).start()
    jsingle = _AppThread(jexplorer.create_explorer_app(fed.url,
                                                       interval=3600))
    gone = explorer.ExplorerServer(dead_url, interval=3600).start()
    jgone = _AppThread(jexplorer.create_explorer_app(dead_url,
                                                     interval=3600))
    try:
        out = []
        with httpx.Client(timeout=WAIT) as c:
            for base, one, off in (
                    (port.url, single.url, gone.url),
                    (f"http://{jax.addr}", f"http://{jsingle.addr}",
                     f"http://{jgone.addr}")):
                calls = [
                    c.post(f"{base}/api/networks",
                           json={"url": fed.url, "name": "test-net"}),
                    c.post(f"{base}/api/networks",
                           json={"url": "ftp://nope"}),
                    c.post(f"{base}/api/networks", content=b"{"),
                    c.delete(f"{base}/api/networks",
                             params={"url": "http://never:1"})]
                page = c.get(f"{base}/")
                nets = c.get(f"{base}/api/networks").json()["networks"]
                gone_del = c.delete(f"{base}/api/networks",
                                    params={"url": fed.url})
                after = c.get(f"{base}/api/networks").json()
                nodes = c.get(f"{one}/api/nodes")
                down = c.get(f"{off}/api/nodes")
                out.append((
                    [x.status_code for x in calls], calls[0].json(),
                    page.status_code,
                    page.headers["content-type"].split(";")[0],
                    "test-net" in page.text and "apinode:9994" in page.text,
                    [(n["url"], n["name"], n["ok"], n["nodes"])
                     for n in nets],
                    gone_del.status_code, gone_del.json(), after,
                    nodes.status_code, nodes.json(), down.status_code,
                    sorted(down.json())))
        assert out[0] == out[1]
        assert out[0][0] == [200, 400, 400, 404]
        assert out[0][9] == 200 and out[0][11] == 502
    finally:
        for s in (port, single, gone):
            s.shutdown()
        for s in (jax, jsingle, jgone):
            s.stop()
        fed.shutdown()
        dead.close()


def test_explorer_warmup_is_bounded_by_one_deadline(tmp_path):
    """Routers that accept a connection and never answer: the warm-up
    returns at its deadline, not after one dial timeout per router, and
    counts no failure."""
    silent = []
    for _ in range(4):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(8)
        silent.append(s)
    urls = [f"http://127.0.0.1:{s.getsockname()[1]}" for s in silent]
    try:
        db = explorer.ExplorerDB(tmp_path / "warm.json")
        for u in urls:
            db.add(u)
        mon = explorer.DiscoveryMonitor(db, interval=3600,
                                        failure_threshold=3, timeout=5.0)
        t0 = time.monotonic()
        mon.warmup(set(urls), deadline=1.0, count_failures=False)
        assert time.monotonic() - t0 < 3.0
        assert all(db.entries()[u]["failures"] == 0 for u in urls)
    finally:
        for s in silent:
            s.close()


def test_explorer_page_warms_a_live_router(tmp_path):
    fed = FederatedServer(["warm:9995"], health_interval=3600).start()
    ex = explorer.ExplorerServer(fed.url, interval=3600).start()
    try:
        assert ex.monitor.state() == {}
        with urllib.request.urlopen(ex.url + "/", timeout=WAIT) as r:
            page = r.read().decode()
        assert "warm:9995" in page and "1/1 online" in page
        assert ex.monitor.state()[fed.url]["ok"]
        # the server's own JSON for an unknown path and a wrong method
        for path, method, code in (("/nope", "GET", 404),
                                   ("/api/nodes", "POST", 405)):
            req = urllib.request.Request(ex.url + path, method=method,
                                         data=b"" if method == "POST"
                                         else None)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=WAIT)
            assert e.value.code == code
    finally:
        ex.shutdown()
        fed.shutdown()
