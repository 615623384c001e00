"""The port's web UI against the JAX package's, on the CPU.

Mirrors ``tests/test_ui.py`` on both HTTP servers over one models dir:

  * ``/`` answers JSON to an API client and the home page to a browser;
  * every page answers 200 as ``text/html``, its script calls the same
    JSON routes as the JAX package's page, and it names no host but
    loopback (the pages are self-contained);
  * ``disable_webui`` takes the same routes away (404, and ``/`` answers
    JSON to a browser too);
  * with API keys the pages stay open and their JSON routes do not;
  * ``/swarm/nodes`` refuses, fetches and fails on one table of router
    URLs with the JAX server's status codes and bodies (a live router is
    the port's ``FederatedServer``; no URL outside loopback is fetched:
    those are refused before any fetch).
"""

import re
import socket

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")
httpx = pytest.importorskip("httpx")

from localai_tpu_torch.api import server as tserver  # noqa: E402
from localai_tpu_torch.api import ui  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.federation import FederatedServer  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

WAIT = 60.0
PAGES = ["/browse", "/chat/", "/chat/tiny", "/text2image/",
         "/text2image/tiny", "/tts/", "/tts/tiny", "/talk/", "/talk/tiny",
         "/swarm", "/slo", "/fleet", "/usage", "/batches"]
LOOPBACK = {"127.0.0.1", "localhost", "::1", "[::1]"}


class _Both:
    """The JAX server and the port's over one models dir."""

    def __init__(self, root, **settings):
        models = root / "models"
        models.mkdir()
        state = make_state(models, write_tiny=True)
        for k, v in settings.items():
            setattr(state.config, k, v)
        self.ref = _ServerThread(state)
        loader = ConfigLoader(str(models))
        loader.load_from_path()
        self.app = AppConfig(model_path=str(models), device="cpu",
                             upload_path=str(root / "port_up"),
                             config_path=str(root / "port_conf"),
                             **settings)
        self.port = APIServer(ModelManager(self.app, loader), "127.0.0.1",
                              0).start()

    def get(self, path, **kw):
        """(port answer, JAX answer)."""
        with httpx.Client(timeout=WAIT) as c:
            return (c.get(self.port.url + path, **kw),
                    c.get(self.ref.base + path, **kw))

    def stop(self):
        self.ref.stop()
        self.port.shutdown()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    b = _Both(tmp_path_factory.mktemp("ui"))
    yield b
    b.stop()


def _fetched(page: str) -> set:
    """The JSON routes a page's script fetches (their literal part)."""
    return set(re.findall(r"fetch\(\s*'([^']+)'", page))


def _hosts(page: str) -> set:
    """Every host an absolute or scheme-relative URL of the page names."""
    return set(re.findall(r"(?:https?:)?//([\w.\-\[\]:]+?)(?::\d+)?[/\"'\s]",
                          page))


def test_home_content_negotiation_as_the_jax_server(both):
    api, japi = both.get("/")
    assert api.headers["content-type"].startswith("application/json")
    assert japi.headers["content-type"].startswith("application/json")
    page, jpage = both.get("/", headers={"Accept": "text/html"})
    for r in (page, jpage):
        assert r.status_code == 200
        assert r.headers["content-type"].startswith("text/html")
        assert "tiny" in r.text and "LocalAI-TPU" in r.text
        assert 'href="/talk/"' in r.text and 'href="/swarm"' in r.text
    assert re.findall(r'href="([^"]+)"', page.text) == \
        re.findall(r'href="([^"]+)"', jpage.text)


@pytest.mark.parametrize("path", PAGES)
def test_page_as_the_jax_page(both, path):
    page, jpage = both.get(path)
    for r in (page, jpage):
        assert r.status_code == 200, path
        assert r.headers["content-type"].startswith("text/html"), path
    assert _fetched(page.text) == _fetched(jpage.text)
    assert re.findall(r"<title>(.*?)</title>", page.text) == \
        re.findall(r"<title>(.*?)</title>", jpage.text)
    assert _hosts(page.text) <= LOOPBACK, _hosts(page.text)


def test_pages_call_the_jax_routes(both):
    """The pages, together, call the JSON routes the JAX package's call,
    and each of those routes is one the port serves."""
    routes = set()
    for path in PAGES:
        routes |= _fetched(both.get(path)[0].text)
    assert {"/v1/chat/completions", "/v1/images/generations", "/tts",
            "/v1/audio/transcriptions", "/v1/audio/speech",
            "/models/available", "/models/apply", "/models/jobs/",
            "/models/delete/", "/swarm/nodes?router=", "/v1/slo",
            "/debug/flight?limit=64", "/debug/anatomy", "/v1/fleet",
            "/v1/usage", "/v1/batches"} == routes
    for r in routes:
        path = r.split("?")[0]
        path += "x" if path.endswith("/") else ""
        assert any(tserver._route(m, path) for m in ("GET", "POST")), r


def test_chat_page_preselects_the_model(both):
    page, jpage = both.get("/chat/tiny")
    assert "selected>tiny" in page.text and "selected>tiny" in jpage.text


def test_disable_webui_hides_the_same_routes(tmp_path):
    b = _Both(tmp_path, disable_webui=True)
    try:
        for path in PAGES + ["/swarm/nodes"]:
            r, jr = b.get(path)
            assert r.status_code == jr.status_code == 404, path
        r, jr = b.get("/", headers={"Accept": "text/html"})
        for x in (r, jr):
            assert x.headers["content-type"].startswith("application/json")
        ui_paths = {*ui.GET, *(p for p, _ in ui.GET_PARAM)}
        assert not ui_paths & set(r.json()["endpoints"])
        assert not ui_paths & set(jr.json()["endpoints"])
        # the rest of the API is still served
        assert b.get("/v1/models")[0].status_code == 200
    finally:
        b.stop()


def test_pages_keyless_apis_protected_as_the_jax_server(tmp_path):
    b = _Both(tmp_path, api_keys=["sekrit"])
    try:
        for path, code in (("/chat/", 200), ("/swarm", 200),
                           ("/v1/models", 401), ("/models/available", 401),
                           ("/swarm/nodes?router=http://127.0.0.1:1", 401),
                           ("/swagger", 200)):
            r, jr = b.get(path)
            assert r.status_code == jr.status_code == code, path
        key = {"Authorization": "Bearer sekrit"}
        r, jr = b.get("/swarm/nodes?router=http://h/x?", headers=key)
        assert r.status_code == jr.status_code == 400
        assert r.json() == jr.json()
    finally:
        b.stop()


@pytest.fixture(scope="module")
def swarm(tmp_path_factory):
    """Both servers with a live router and a dead one in the allowlist."""
    router = FederatedServer(["127.0.0.1:9"], health_interval=3600).start()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))          # bound, never listening
    dead_url = f"http://127.0.0.1:{dead.getsockname()[1]}"
    b = _Both(tmp_path_factory.mktemp("swarm"),
              swarm_routers=f"HTTP://127.0.0.1:{router.port}/,{dead_url}")
    yield b, router, dead_url
    b.stop()
    router.shutdown()
    dead.close()


SWARM_CASES = [
    ("live", 200), ("live-variant", 200), ("dead", 502), ("own-port", None),
    ("default", None), ("ftp://x", 400), ("http://h/x?", 400),
    ("http://h/x#frag", 400), ("http://127.0.0.1:x@10.99.0.1:8500", 400),
    ("http://10.99.0.1:8500", 403), ("http://127.0.0.1:1", 403),
    ("http://localhost:1/", 403), ("https://127.0.0.1:8080", None),
]


@pytest.mark.parametrize("router,code", SWARM_CASES,
                         ids=[c for c, _ in SWARM_CASES])
def test_swarm_nodes_allowlist_as_the_jax_server(swarm, router, code):
    b, live, dead_url = swarm
    url = {"live": live.url, "live-variant": live.url + "/",
           "dead": dead_url,
           # this server's own configured port on loopback (the default
           # 8080, where nothing of the test listens: a 502 or the
           # answer of whatever does, on both alike)
           "own-port": "http://localhost:8080"}.get(router, router)
    params = {} if router == "default" else {"router": url}
    r, jr = b.get("/swarm/nodes", params=params)
    assert r.status_code == jr.status_code, (r.text, jr.text)
    if code is not None:
        assert r.status_code == code
    assert r.json() == jr.json()
    if code == 200:
        assert [n["address"] for n in r.json()["nodes"]] == [
            "http://127.0.0.1:9"]
