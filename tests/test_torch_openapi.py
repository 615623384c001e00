"""The port's OpenAPI document and Swagger page against the JAX server's,
on the CPU.

Mirrors the Swagger cases of ``tests/test_ui.py``: ``/swagger/doc.json``
of both servers for one configuration (the UI on, and off) lists the same
paths with the same methods, but one: the JAX server's own ``POST
/federated/register``, which adopts remote workers as fleet replicas and
waits for the port's worker tier (ROADMAP item 23 part 2). Path
parameters are declared, the hand-written request bodies are the JAX
package's, ``/swagger`` is a self-contained page, both stay open with API
keys, and the port's welcome lists exactly the document's paths.
"""

import re

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")
httpx = pytest.importorskip("httpx")

from localai_tpu.api import openapi as jopenapi  # noqa: E402
from localai_tpu_torch.api import openapi  # noqa: E402
from test_torch_ui import _Both, _hosts  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

# routes of the JAX server the port does not serve: none since the worker
# tier brought POST /federated/register
WORKER_TIER = set()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    b = _Both(tmp_path_factory.mktemp("openapi"))
    yield b
    b.stop()


def _ops(spec: dict) -> set:
    return {(path, method) for path, ops in spec["paths"].items()
            for method in ops}


def _specs(b) -> tuple:
    r, jr = b.get("/swagger/doc.json")
    assert r.status_code == jr.status_code == 200
    assert r.headers["content-type"].startswith("application/json")
    return r.json(), jr.json()


def test_spec_lists_the_jax_servers_paths_and_methods(both):
    spec, jspec = _specs(both)
    assert _ops(jspec) - _ops(spec) == WORKER_TIER
    assert _ops(spec) - _ops(jspec) == set()


def test_spec_without_the_ui_lists_the_jax_servers_paths(tmp_path):
    b = _Both(tmp_path, disable_webui=True)
    try:
        spec, jspec = _specs(b)
        assert _ops(jspec) - _ops(spec) == WORKER_TIER
        assert _ops(spec) == _ops(jspec) - WORKER_TIER
        assert "/browse" not in spec["paths"]
        assert "/swagger" in spec["paths"]
    finally:
        b.stop()


def test_spec_shape_as_the_jax_servers(both):
    spec, jspec = _specs(both)
    assert spec["openapi"] == jspec["openapi"] == "3.0.3"
    assert set(spec) == set(jspec)
    assert spec["security"] == jspec["security"]
    assert spec["components"] == jspec["components"]
    assert spec["info"]["title"] == jspec["info"]["title"]
    assert "PyTorch" in spec["info"]["description"]
    assert openapi._DOCS == jopenapi._DOCS
    for path, method in _ops(spec):
        op, jop = spec["paths"][path][method], jspec["paths"][path][method]
        assert op["summary"]
        assert op.get("requestBody") == jop.get("requestBody"), (path,
                                                                  method)
        assert op.get("parameters") == jop.get("parameters"), (path, method)
        assert op["responses"] == jop["responses"]
    body = spec["paths"]["/v1/chat/completions"]["post"]["requestBody"]
    assert "messages" in body["content"]["application/json"]["schema"][
        "properties"]
    params = spec["paths"]["/v1/assistants/{assistant_id}/files/{file_id}"][
        "delete"]["parameters"]
    assert [p["name"] for p in params] == ["assistant_id", "file_id"]


def test_swagger_page_as_the_jax_page(both):
    page, jpage = both.get("/swagger")
    for r in (page, jpage):
        assert r.status_code == 200
        assert r.headers["content-type"].startswith("text/html")
        assert "doc.json" in r.text
    assert re.findall(r"fetch\('([^']+)'", page.text) == \
        re.findall(r"fetch\('([^']+)'", jpage.text) == ["/swagger/doc.json"]
    assert _hosts(page.text) == set()


def test_swagger_reachable_with_api_keys(tmp_path):
    b = _Both(tmp_path, api_keys=["sekrit"])
    try:
        for path in ("/swagger", "/swagger/doc.json"):
            r, jr = b.get(path)
            assert r.status_code == jr.status_code == 200, path
    finally:
        b.stop()


def test_welcome_lists_the_spec_paths(both):
    spec, _ = _specs(both)
    welcome = both.get("/", headers={"Accept": "application/json"})[0]
    assert welcome.json()["endpoints"] == sorted(spec["paths"])
