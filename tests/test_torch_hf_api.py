"""The PyTorch port's remote inference-API client against the JAX
package's ``models/hf_api.py``, over a stdlib HTTP stub this test starts
on 127.0.0.1 (nothing leaves the machine).

Both clients post to the stub for the same requests: the path, the JSON
body (prompt text from the byte tokenizer, parameters, stop strings
capped at four) and the bearer token must be equal, and so must the text
and finish reason each hands back, for the answer forms the API uses (a
list, an object, an ``error`` object, an HTTP failure). The token comes
from ``api_token`` in the config, else ``HUGGINGFACEHUB_API_TOKEN``, else
``HF_TOKEN``; with none the model fails at load on both. Through the
port's HTTP server a ``backend: huggingface`` YAML serves chats (plain
and streamed) from the stub, and a remote failure answers 502.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.models import hf_api as jh  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models import hf_api as ph  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.templates.cache import TemplateCache  # noqa: E402
from localai_tpu_torch.templates.chat import build_chat_prompt  # noqa: E402

ANSWERS = {
    "list": (200, [{"generated_text": "Paris is the capital."}]),
    "object": (200, {"generated_text": "an object answer"}),
    "empty-list": (200, []),
    "error-object": (200, {"error": "Model is loading"}),
    "http-500": (500, {"error": "internal"}),
}


class Stub:
    """An inference API on 127.0.0.1: records each request (path, auth
    header, JSON body) and answers with ``self.answer``."""

    def __init__(self):
        self.calls: list = []
        self.answer = ANSWERS["list"]
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                stub.calls.append({
                    "path": self.path,
                    "auth": self.headers.get("Authorization"),
                    "type": self.headers.get("Content-Type"),
                    "body": json.loads(self.rfile.read(n))})
                code, body = stub.answer
                raw = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_port}/models"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def stub():
    s = Stub()
    yield s
    s.close()


@pytest.fixture(autouse=True)
def no_env_token(monkeypatch):
    for env in ph.TOKEN_ENV:
        monkeypatch.delenv(env, raising=False)


def _request(cls, tok, **kw):
    return cls(prompt=tok.encode("Question: the capital of France?"),
               **{"max_new_tokens": 7, **kw})


SAMPLING = [dict(temperature=0.0),
            dict(temperature=0.7, top_p=0.9, top_k=5,
                 stop=("\n", "Q:", "###", "a", "b"))]


@pytest.mark.parametrize("answer", sorted(ANSWERS))
@pytest.mark.parametrize("k", range(len(SAMPLING)), ids=["greedy",
                                                         "sampled"])
def test_round_trip_equals_the_reference(stub, answer, k):
    stub.answer = ANSWERS[answer]
    ours = ph.HFApiScheduler("org/model", "tok", stub.base + "/")
    ref = jh.HFApiScheduler("org/model", "tok", stub.base + "/")
    got = ours.submit(_request(GenRequest, ours._tok, **SAMPLING[k]))
    got.result(30)
    want = ref.submit(_request(JaxGenRequest, ref._tok, **SAMPLING[k]))
    want.result(30)
    assert stub.calls[0] == stub.calls[1]
    call = stub.calls[0]
    assert call["path"] == "/models/org/model"
    assert call["auth"] == "Bearer tok"
    assert call["type"] == "application/json"
    assert call["body"]["inputs"] == "Question: the capital of France?"
    assert (got.text, got.finish_reason) == (want.text, want.finish_reason)
    assert got.finish_reason == ("error" if answer in ("error-object",
                                                       "http-500")
                                 else "stop")
    assert not ours.busy and ours.metrics() == {
        "type": "hf-api", "inflight": 0, "repo": "org/model"}


@pytest.mark.parametrize("source", ["config", "HUGGINGFACEHUB_API_TOKEN",
                                    "HF_TOKEN", "both-envs"])
def test_token_comes_from_the_config_or_the_environment(stub, monkeypatch,
                                                        tmp_path, source):
    doc = {"name": "remote", "backend": "huggingface", "model": "org/m",
           "api_base": stub.base}
    if source == "config":
        doc["api_token"] = "from-config"
        monkeypatch.setenv("HF_TOKEN", "ignored")
    elif source == "both-envs":
        monkeypatch.setenv("HUGGINGFACEHUB_API_TOKEN", "first")
        monkeypatch.setenv("HF_TOKEN", "second")
    else:
        monkeypatch.setenv(source, "from-env")
    ours = ph.HFApiServingModel(ModelConfig.from_dict(doc),
                                AppConfig(model_path=str(tmp_path),
                                          device="cpu"))
    ref = jh.HFApiServingModel(JaxModelConfig(**doc),
                               JaxAppConfig(model_path=str(tmp_path)))
    assert ours.scheduler.token == ref.scheduler.token == {
        "config": "from-config", "both-envs": "first"}.get(source,
                                                           "from-env")
    assert ours.scheduler.api_base == ref.scheduler.api_base == stub.base
    for sm in (ours, ref):
        sm.scheduler.submit(_request(
            GenRequest if sm is ours else JaxGenRequest,
            sm.tokenizer)).result(30)
    assert stub.calls[0]["auth"] == stub.calls[1]["auth"] == \
        f"Bearer {ref.scheduler.token}"
    assert (ours.vision, ours.image_token_id, ours.alive(), ours.busy) == (
        None, 0, True, False)


def test_a_model_without_a_token_fails_at_load(tmp_path):
    doc = {"name": "remote", "backend": "langchain-huggingface",
           "model": "org/m"}
    with pytest.raises(ValueError, match="needs an API token"):
        jh.HFApiServingModel(JaxModelConfig(**doc),
                             JaxAppConfig(model_path=str(tmp_path)))
    with pytest.raises(ValueError, match="needs an API token"):
        ph.HFApiServingModel(ModelConfig.from_dict(doc),
                             AppConfig(model_path=str(tmp_path),
                                       device="cpu"))
    assert ph.DEFAULT_API_BASE == jh.DEFAULT_API_BASE
    assert ph.TOKEN_ENV == jh.TOKEN_ENV


@pytest.fixture()
def served(stub, tmp_path):
    models = tmp_path / "models"
    models.mkdir()
    (models / "remote.yaml").write_text(yaml.safe_dump(
        {"name": "remote", "backend": "huggingface", "model": "org/chat",
         "api_token": "secret", "api_base": stub.base,
         "parameters": {"max_tokens": 9}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    server = APIServer(ModelManager(AppConfig(model_path=str(models),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    yield server, loader, models
    server.shutdown()


def _chat(server, **extra):
    body = {"model": "remote", "temperature": 0,
            "messages": [{"role": "user", "content": "capital of France?"}],
            **extra}
    req = urllib.request.Request(server.url + "/v1/chat/completions",
                                 data=json.dumps(body).encode())
    return urllib.request.urlopen(req, timeout=60)


def test_chat_is_answered_by_the_remote_model(served, stub):
    server, loader, models = served
    out = json.loads(_chat(server).read())
    assert out["choices"][0]["message"]["content"] == \
        "Paris is the capital."
    assert out["choices"][0]["finish_reason"] == "stop"
    prompt = build_chat_prompt(TemplateCache(models), loader.get("remote"),
                               [{"role": "user",
                                 "content": "capital of France?"}])
    call = stub.calls[-1]
    assert call["body"] == {"inputs": prompt, "parameters": {
        "max_new_tokens": 9, "return_full_text": False, "top_p": 0.95,
        "top_k": 40}}
    assert call["auth"] == "Bearer secret"
    with _chat(server, stream=True) as r:
        frames = [json.loads(line[6:]) for line in r.read().split(b"\n")
                  if line.startswith(b"data: {")]
    assert "".join(f["choices"][0]["delta"].get("content") or ""
                   for f in frames if f["choices"]) == \
        "Paris is the capital."
    sm = server.manager.get("remote")
    assert type(sm).__name__ == "HFApiServingModel"
    assert not hasattr(sm, "runner")


@pytest.mark.parametrize("answer", ["error-object", "http-500"])
def test_a_remote_failure_is_a_502(served, stub, answer):
    server = served[0]
    stub.answer = ANSWERS[answer]
    with pytest.raises(urllib.error.HTTPError) as e:
        _chat(server)
    assert e.value.code == 502
    # the JAX package's client finishes the same request with "error"
    ref = jh.HFApiScheduler("org/chat", "secret", stub.base)
    h = ref.submit(_request(JaxGenRequest, ref._tok)).result(30)
    assert h.finish_reason == "error" and h.text == ""


def test_embeddings_on_a_remote_model_are_refused(served, tmp_path):
    """A remote model has no llama engine to embed with: 400 (the
    usecase gate answers first unless ``embeddings: true``)."""
    server, loader, models = served
    (models / "remote-emb.yaml").write_text(yaml.safe_dump(
        {"name": "remote-emb", "backend": "huggingface", "model": "org/e",
         "api_token": "secret", "embeddings": True}))
    loader.load_from_path()
    for name in ("remote", "remote-emb"):
        req = urllib.request.Request(
            server.url + "/v1/embeddings",
            data=json.dumps({"model": name, "input": "x"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400
