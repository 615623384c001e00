"""The port's Assistants API against the JAX server's, on the CPU.

Mirrors ``tests/test_assistants.py``: one script of calls — creates
(valid, and refused by every validation rule), lists with their order,
cursors and limits, gets, modifies, a file uploaded and attached,
listed, got and detached, deletes, each also under its unversioned
alias — runs on both HTTP servers and answers with the same status codes
and bodies (ids minted alike; the times of both stores read one fake
clock, and ``created_at`` of the uploaded file is left out). The stores
persist where the JAX package's persist: restarted servers list the same
assistants, and a directory written by either package's store is read by
the other's.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")
httpx = pytest.importorskip("httpx")

from localai_tpu.api import assistants as jassistants  # noqa: E402
from localai_tpu.batch.store import FileRegistry as JaxRegistry  # noqa: E402
from localai_tpu_torch.api import assistants  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.batch.store import FileRegistry  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

WAIT = 60.0
RAW = object()       # a script entry whose body is sent as raw bytes


class _Pair:
    """Both servers over one models dir, each with its own config and
    upload dirs (kept across a restart)."""

    def __init__(self, root):
        self.root = root
        self.models = root / "models"
        if not self.models.exists():
            self.models.mkdir()
            self.ref = _ServerThread(make_state(self.models, write_tiny=True))
        else:
            self.ref = _ServerThread(make_state(self.models))
        loader = ConfigLoader(str(self.models))
        loader.load_from_path()
        self.app = AppConfig(model_path=str(self.models), device="cpu",
                             upload_path=str(root / "port_up"),
                             config_path=str(root / "port_conf"))
        self.port = APIServer(ModelManager(self.app, loader), "127.0.0.1",
                              0).start()

    @property
    def jax_dirs(self):
        cfg = self.ref.state.config
        return cfg.config_path, cfg.upload_path

    def call(self, method, path, body=None, raw=None, files=None):
        """[(status, JSON body) of the port, of the JAX server]."""
        out = []
        with httpx.Client(timeout=WAIT) as c:
            for base in (self.port.url, self.ref.base):
                kw = {}
                if files is not None:
                    kw = {"files": files[0], "data": files[1]}
                elif raw is not None:
                    kw = {"content": raw,
                          "headers": {"Content-Type": "application/json"}}
                elif body is not None:
                    kw = {"json": body}
                r = c.request(method, base + path, **kw)
                out.append((r.status_code, r.json()))
        return out

    def stop(self):
        self.ref.stop()
        self.port.shutdown()


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    clock = SimpleNamespace(time=lambda: 1_790_000_000.0)
    monkeypatch.setattr(assistants, "time", clock)
    monkeypatch.setattr(jassistants, "time", clock)
    p = _Pair(tmp_path)
    yield p
    p.stop()


SCRIPT = [
    ("POST", "/v1/assistants", {"model": "tiny", "name": "helper",
                                "instructions": "be brief",
                                "tools": [{"type": "retrieval"}],
                                "metadata": {"k": "v"}}),
    ("POST", "/v1/assistants", {"name": "no model"}),
    ("POST", "/v1/assistants", {"model": "nope"}),
    ("POST", "/v1/assistants", {"model": "tiny", "name": "n" * 257}),
    ("POST", "/v1/assistants", {"model": "tiny", "description": "d" * 513}),
    ("POST", "/v1/assistants", {"model": "tiny",
                                "instructions": "i" * 32769}),
    ("POST", "/v1/assistants", {"model": "tiny",
                                "tools": [{"type": "bogus"}]}),
    ("POST", "/v1/assistants", {"model": "tiny", "tools": ["x"]}),
    ("POST", "/v1/assistants", {"model": "tiny",
                                "tools": [{"type": "function"}] * 129}),
    ("POST", "/v1/assistants", {"model": "tiny", "file_ids": ["f"] * 21}),
    ("POST", "/v1/assistants", [1, 2]),
    ("POST", "/v1/assistants", (RAW, b"{not json")),
    ("POST", "/v1/assistants", (RAW, b"")),
    ("POST", "/assistants", {"model": "tiny", "name": "second"}),
    ("GET", "/v1/assistants", None),
    ("GET", "/v1/assistants?order=asc", None),
    ("GET", "/v1/assistants?after=asst_1", None),
    ("GET", "/v1/assistants?before=2", None),
    ("GET", "/v1/assistants?limit=1&order=asc", None),
    ("GET", "/v1/assistants?limit=x", None),
    ("GET", "/v1/assistants/asst_1", None),
    ("GET", "/assistants/asst_9", None),
    ("POST", "/v1/assistants/asst_1", {"model": "tiny", "name": "renamed",
                                       "file_ids": []}),
    ("POST", "/v1/assistants/asst_9", {"model": "tiny"}),
    ("POST", "/v1/assistants/asst_1", {"model": "nope"}),
    ("POST", "/v1/assistants/asst_1", (RAW, b"[")),
    ("UPLOAD", "/v1/files", ("notes.txt", b"hello assistants")),
    ("POST", "/v1/assistants/asst_1/files", {"file_id": "file-1"}),
    ("POST", "/assistants/asst_1/files", {"file_id": "file-1"}),
    ("POST", "/v1/assistants/asst_9/files", {"file_id": "file-1"}),
    ("POST", "/v1/assistants/asst_1/files", {"file_id": "file-9"}),
    ("POST", "/v1/assistants/asst_1/files", {}),
    ("POST", "/v1/assistants/asst_1/files", (RAW, b"")),
    ("GET", "/v1/assistants/asst_1/files", None),
    ("GET", "/v1/assistants/asst_1/files?limit=1", None),
    ("GET", "/v1/assistants/asst_1/files?limit=zz", None),
    ("GET", "/v1/assistants/asst_9/files", None),
    ("GET", "/v1/assistants/asst_1/files/file-1", None),
    ("GET", "/assistants/asst_1/files/file-9", None),
    ("GET", "/v1/assistants/asst_1", None),
    ("DELETE", "/v1/assistants/asst_1/files/file-1", None),
    ("DELETE", "/v1/assistants/asst_1/files/file-1", None),
    ("GET", "/v1/assistants/asst_1", None),
    ("DELETE", "/assistants/asst_2", None),
    ("DELETE", "/v1/assistants/asst_2", None),
    ("GET", "/v1/assistants", None),
]


def _drop_upload_time(answer):
    status, body = answer
    if isinstance(body, dict) and body.get("object") == "file":
        body = {k: v for k, v in body.items() if k != "created_at"}
    return status, body


def _run(pair, script):
    out = []
    for method, path, body in script:
        if method == "UPLOAD":
            got = pair.call("POST", path, files=(
                {"file": body}, {"purpose": "assistants"}))
        elif isinstance(body, tuple) and body[0] is RAW:
            got = pair.call(method, path, raw=body[1])
        else:
            got = pair.call(method, path, body)
        out.append((method, path, [_drop_upload_time(a) for a in got]))
    return out


def test_script_answers_as_the_jax_server(pair):
    out = _run(pair, SCRIPT)
    for method, path, (port, ref) in out:
        assert port == ref, (method, path)
    codes = [port[0] for _, _, (port, _) in out]
    assert codes == [200] + [400] * 12 + [200] * 6 + [
        400, 200, 404, 200, 404, 400, 400, 200, 200, 200, 404, 404, 404,
        400, 200, 200, 400, 404, 200, 404, 200, 200, 200, 200, 200, 404, 200]
    created = out[0][2][0][1]
    assert created["id"] == "asst_1" and created["object"] == "assistant"


def test_assistants_persist_and_reload_as_the_jax_server(pair):
    _run(pair, SCRIPT[:1] + SCRIPT[13:14] + SCRIPT[26:28])
    listed = pair.call("GET", "/v1/assistants")
    assert listed[0] == listed[1] and len(listed[0][1]) == 2
    pair.stop()
    again = _Pair(pair.root)
    pair.ref, pair.port = again.ref, again.port
    after = pair.call("GET", "/v1/assistants")
    assert after == listed
    files = pair.call("GET", "/v1/assistants/asst_1/files")
    assert files[0] == files[1] and len(files[0][1]["data"]) == 1
    # ids continue past the reloaded ones, alike
    made = pair.call("POST", "/v1/assistants", {"model": "tiny"})
    assert made[0] == made[1] and made[0][1]["id"] == "asst_3"


def test_stores_read_each_others_directories(pair):
    _run(pair, SCRIPT[:1] + SCRIPT[26:28])
    conf, up = pair.jax_dirs
    port_conf, port_up = pair.app.config_path, pair.app.upload_path
    mine = assistants.AssistantStore(conf, up, registry=FileRegistry(up))
    theirs = jassistants.AssistantStore(
        port_conf, port_up, registry=JaxRegistry(port_up))
    for a, b in ((mine, jassistants.AssistantStore(
            conf, up, registry=JaxRegistry(up))),
            (theirs, assistants.AssistantStore(
                port_conf, port_up, registry=FileRegistry(port_up)))):
        assert a.assistants == b.assistants
        assert a.assistant_files == b.assistant_files
        assert a.next_id() == b.next_id() == 2
        assert a.file("file-1")["filename"] == "notes.txt"
    saved = json.loads((Path(port_conf)
                        / assistants.ASSISTANTS_FILE).read_text())
    assert [a["id"] for a in saved] == ["asst_1"]
