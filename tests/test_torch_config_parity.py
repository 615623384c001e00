"""The PyTorch port's model config against the JAX package's, on the CPU.

Each test reads one YAML into both packages and holds what they build
against each other: engine knobs that reach the scheduler and the paged
pool (pipeline_depth, stream_latency_ms, kv_num_blocks), ``f16: false``,
completion text shaping (cutstrings, extract_regex, trimspace, trimsuffix,
``echo``) over both HTTP servers on a tiny checkpoint written here, and
the port's refusals of what it cannot serve yet (the prompt cache, the
backends the JAX package serves with another engine than the llama
runner), which stay until the port has them, and of what the JAX package
accepts and ignores (a raw ``grammar`` string, constraints on
``/v1/completions``), the ``function:`` section read into equal fields
by both packages, and the choice of speculative decoding (on by default for a paged engine, off
under ``spec: false`` or ``LOCALAI_SPEC=0``, its knobs honoured). Then
prompt templates over HTTP: one models dir with a Go-template YAML and a
Jinja ``chat_template`` YAML, served by both packages — templated,
multi-turn, chat_template and tools chats, ``n: 2`` streamed and not,
list-prompt completions, edits, ``ignore_eos``, the unversioned aliases
and the models filter.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")

import jax  # noqa: E402

from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.manager import build_serving_model as jax_build  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader, load_config_file  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager, build_serving_model  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)

ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32", spec=False)


def _both(doc: dict):
    """(port ServingModel, JAX ServingModel) built from one YAML document
    on the CPU."""
    sm = build_serving_model(ModelConfig.from_dict(dict(doc)),
                             AppConfig(device="cpu"))
    jsm = jax_build(JaxModelConfig(**doc), JaxAppConfig())
    return sm, jsm


def test_pipeline_depth_and_stream_latency_reach_the_scheduler():
    doc = {"name": "p", "model": "debug:tiny", "context_size": 64,
           "engine": {**ENGINE, "pipeline_depth": 1,
                      "stream_latency_ms": 20}}
    sm, jsm = _both(doc)
    try:
        for s in (sm.scheduler, jsm.scheduler):
            assert s.pipeline_depth == 1
            assert s.stream_latency_target == pytest.approx(0.02)
    finally:
        sm.close()
        jsm.close()


def _spec_of(sm):
    """(drafter name, gamma, layout) of a serving model's spec lane, or
    None when it serves without speculation."""
    spec = sm.scheduler.spec
    if spec is None:
        return None
    return spec.drafter.name, spec.gamma, spec.paged


SPEC_ENGINE = {k: v for k, v in ENGINE.items() if k != "spec"}


@pytest.mark.parametrize("extra,env,want", [
    # no spec key: a paged engine speculates with the n-gram drafter
    ({}, None, ("ngram", 4, True)),
    ({"spec": False}, None, None),
    ({}, "0", None),
    # spec: true turns it on for a contiguous engine as well
    ({"spec": True, "kv_paged": False}, None, ("ngram", 4, False)),
    # contiguous engines stay plain by default
    ({"kv_paged": False}, None, None),
], ids=["default", "spec-false", "kill-switch", "spec-true-contiguous",
        "contiguous-default"])
def test_speculation_is_chosen_as_on_the_reference(monkeypatch, extra, env,
                                                   want):
    monkeypatch.delenv("LOCALAI_SPEC", raising=False)
    if env is not None:
        monkeypatch.setenv("LOCALAI_SPEC", env)
    doc = {"name": "s", "model": "debug:tiny", "context_size": 64,
           "engine": {**SPEC_ENGINE, **extra}}
    sm, jsm = _both(doc)
    try:
        assert _spec_of(sm) == _spec_of(jsm) == want
    finally:
        sm.close()
        jsm.close()


@pytest.mark.parametrize("extra,want", [
    ({"spec_gamma": 3, "spec_drafter": "ngram"}, ("ngram", 3, True)),
    # a draft model takes n_draft as its window unless spec_gamma is set
    ({"draft_model": "debug:tiny", "n_draft": 2}, ("model", 2, True)),
    ({"draft_model": "debug:tiny", "n_draft": 2, "spec_gamma": 5,
      "kv_paged": False}, ("model", 5, False)),
    # spec_drafter model without a draft model falls back to n-gram
    ({"spec_drafter": "model"}, ("ngram", 4, True)),
], ids=["gamma-ngram", "draft-n_draft", "draft-contiguous",
        "model-without-draft"])
def test_spec_knobs_reach_the_engine(monkeypatch, extra, want):
    monkeypatch.delenv("LOCALAI_SPEC", raising=False)
    monkeypatch.delenv("LOCALAI_SPEC_GAMMA", raising=False)
    doc = {"name": "k", "model": "debug:tiny", "context_size": 64,
           "engine": {**SPEC_ENGINE, **extra}}
    sm, jsm = _both(doc)
    try:
        assert _spec_of(sm) == _spec_of(jsm) == want
        if want[0] == "model":
            draft = sm.scheduler.spec.drafter.runner
            assert not draft.paged and draft.device == sm.runner.device
            assert draft.num_slots == sm.runner.num_slots
    finally:
        sm.close()
        jsm.close()


def test_speculating_engine_serves_the_plain_engines_tokens(monkeypatch):
    """The default (speculating) paged engine and a ``spec: false`` one
    built from the same YAML return the same greedy tokens, and the
    speculating one ran verify windows."""
    monkeypatch.delenv("LOCALAI_SPEC", raising=False)
    doc = {"name": "t", "model": "debug:tiny", "context_size": 128,
           "engine": SPEC_ENGINE}
    spec = build_serving_model(ModelConfig.from_dict(dict(doc)),
                               AppConfig(device="cpu"))
    plain = build_serving_model(
        ModelConfig.from_dict({**doc, "engine": ENGINE}),
        AppConfig(device="cpu"))
    try:
        req = dict(prompt=list(b"abcabcabcabcabcabc"), max_new_tokens=24,
                   temperature=0.0, logit_bias={97: 1e4})
        a = spec.scheduler.generate(GenRequest(**req), timeout=120)
        b = plain.scheduler.generate(GenRequest(**req), timeout=120)
        assert a.token_ids == b.token_ids
        assert spec.scheduler.metrics()["spec_windows"] > 0
        assert plain.scheduler.spec is None
    finally:
        spec.close()
        plain.close()


def _held_while_first_runs(sched, first, second) -> bool:
    """True once ``second`` sits in the scheduler's hold while ``first``
    is still decoding (polled: the engine thread admits them)."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and first.finish_reason is None:
        if sched._held is second:
            return True
        time.sleep(0.0005)
    return False


def test_kv_num_blocks_sizes_the_pool_and_holds_admissions():
    """kv_num_blocks: 9 with 2 slots of 8 blocks each: a pool of 9 (8
    usable). A request that reserves the whole context takes all 8, so a
    second such request waits in the hold on both packages, then runs."""
    doc = {"name": "k", "model": "debug:tiny", "context_size": 128,
           "engine": {**ENGINE, "kv_num_blocks": 9}}
    sm, jsm = _both(doc)
    try:
        assert sm.runner.allocator.num_blocks == 9
        assert jsm.runner.allocator.num_blocks == 9
        prompt = list(b"a long story")
        for sched, req in ((sm.scheduler, GenRequest),
                           (jsm.scheduler, JaxGenRequest)):
            first = sched.submit(req(prompt=prompt, max_new_tokens=120,
                                     temperature=0.0))
            second = sched.submit(req(prompt=prompt, max_new_tokens=120,
                                      temperature=0.0))
            assert _held_while_first_runs(sched, first, second)
            assert first.result(300).completion_tokens > 0
            assert second.result(300).completion_tokens > 0
    finally:
        sm.close()
        jsm.close()


def test_f16_false_computes_in_float32():
    doc = {"name": "f", "model": "debug:tiny", "f16": False}
    assert ModelConfig.from_dict(dict(doc)).engine.dtype == "float32"
    assert JaxModelConfig(**doc).engine.dtype == "float32"
    assert ModelConfig.from_dict({"model": "x"}).engine.dtype == "bfloat16"


SHAPED = {"cutstrings": ["a"], "extract_regex": ["(?s)b(.*)"],
          "trimspace": [" "], "trimsuffix": ["."]}


@pytest.fixture(scope="module")
def two_servers(tmp_path_factory):
    """The port's and the JAX package's HTTP servers over one models dir
    holding one YAML (with text shaping) on a tiny random checkpoint."""
    root = tmp_path_factory.mktemp("shaping")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(3), cfg))
    models = root / "models"
    models.mkdir()
    (models / "s.yaml").write_text(yaml.safe_dump({
        "name": "s", "model": str(ckpt), "context_size": 128,
        "engine": ENGINE, **SHAPED}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield port.url, ref.base
    ref.stop()
    port.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("echo", [True, False])
def test_completion_text_is_shaped_as_the_jax_server_shapes_it(two_servers,
                                                                echo):
    body = {"model": "s", "prompt": "a banana, a cab.", "max_tokens": 10,
            "temperature": 0, "echo": echo}
    got = [_post(url + "/v1/completions", body)["choices"][0]["text"]
           for url in two_servers]
    assert got[0] == got[1]
    if echo:  # the echoed prompt went through cutstrings and the regex
        assert got[0].startswith("nn,  cb.")


@pytest.mark.parametrize("field,value", [
    ("grammar", "root ::= \"x\""),
])
def test_chat_asking_for_constrained_decoding_is_refused(two_servers, field,
                                                         value):
    """A raw grammar string: the JAX package declares the request field
    and reads it nowhere (it decodes unconstrained), so the port refuses
    it rather than serve something else than was asked for. Tools and
    JSON mode are served (tests/test_torch_constrained.py)."""
    body = {"model": "s", "max_tokens": 2, field: value,
            "messages": [{"role": "user", "content": "hi"}]}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(two_servers[0] + "/v1/chat/completions", body)
    assert e.value.code == 400
    assert field in json.loads(e.value.read())["error"]["message"]


@pytest.mark.parametrize("field,value", [
    ("tools", [{"type": "function", "function": {"name": "f",
                                                 "parameters": {}}}]),
    ("tool_choice", "required"),
    ("response_format", {"type": "json_object"}),
    ("grammar", "root ::= \"x\""),
])
def test_completion_asking_for_constrained_decoding_is_refused(
        two_servers, field, value):
    """The JAX package constrains chat completions only and ignores these
    on /v1/completions; the port refuses them there."""
    body = {"model": "s", "max_tokens": 2, "prompt": "hi", field: value}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(two_servers[0] + "/v1/completions", body)
    assert e.value.code == 400
    assert field in json.loads(e.value.read())["error"]["message"]


def test_text_response_format_is_served(two_servers):
    out = _post(two_servers[0] + "/v1/chat/completions", {
        "model": "s", "max_tokens": 2, "response_format": {"type": "text"},
        "messages": [{"role": "user", "content": "hi"}]})
    assert out["usage"]["completion_tokens"] > 0


@pytest.mark.parametrize("doc,what", [
    # the prompt cache, refused once, now loads into the JAX package's
    # fields (what None)
    ({"prompt_cache_path": "cache", "prompt_cache_all": True,
      "prompt_cache_ro": True}, None),
    # a divergence: the JAX package declares the key and reads it nowhere
    ({"grammar": "root ::= \"x\""}, "reads it nowhere"),
], ids=["doc0-prompt cache", "doc1-reads it nowhere"])
def test_config_for_unported_features_fails_at_load(tmp_path, doc, what):
    p = tmp_path / "u.yaml"
    p.write_text(yaml.safe_dump({"name": "u", "model": "debug:tiny", **doc}))
    if what is None:
        cfg = load_config_file(p)
        jcfg = JaxModelConfig(**yaml.safe_load(p.read_text()))
        assert (cfg.prompt_cache_path, cfg.prompt_cache_all,
                cfg.prompt_cache_ro) == (jcfg.prompt_cache_path,
                                         jcfg.prompt_cache_all,
                                         jcfg.prompt_cache_ro)
        return
    with pytest.raises(ValueError, match=what):
        load_config_file(p)


@pytest.mark.parametrize("function", [
    {},
    {"disable_no_action": True, "no_action_function_name": "reply",
     "no_action_description_name": "say it", "function_name_key": "fn",
     "function_arguments_key": "args",
     "response_regex": [r"(?P<fn>\w+)"], "json_regex_match": ["(.*)"],
     "replace_function_results": [{"key": "'", "value": '"'}],
     "replace_llm_results": [{"key": "x", "value": "y"}],
     "capture_llm_results": ["<a>(.*)</a>"],
     "grammar": {"parallel_calls": True, "mixed_mode": True,
                 "prefix": "CALL: "}},
], ids=["defaults", "every-field"])
def test_function_section_loads_into_equal_fields(tmp_path, function):
    p = tmp_path / "fn.yaml"
    p.write_text(yaml.safe_dump({"name": "fn", "model": "debug:tiny",
                                 "function": function}))
    ours = load_config_file(p).function
    ref = JaxModelConfig(**yaml.safe_load(p.read_text())).function
    assert dataclasses.asdict(ours) == ref.model_dump()


UNPORTED = ("mamba", "rwkv", "huggingface", "langchain-huggingface")
# each backend's model ref: the recurrent presets, a remote repo name
BACKEND_MODEL = {"mamba": "debug:mamba-tiny", "rwkv": "debug:rwkv-tiny",
                 "huggingface": "org/remote-model",
                 "langchain-huggingface": "org/remote-model"}


def _both_managers(models):
    """The port's and the JAX package's manager over one models dir."""
    from localai_tpu.config.loader import ConfigLoader as JaxConfigLoader
    from localai_tpu.models.manager import ModelManager as JaxManager

    loader = JaxConfigLoader(models)
    loader.load_from_path()
    jm = JaxManager(JaxAppConfig(model_path=str(models)), loader)
    port_loader = ConfigLoader(models)
    port_loader.load_from_path()
    pm = ModelManager(AppConfig(model_path=str(models), device="cpu"),
                      port_loader)
    return pm, jm


@pytest.mark.parametrize("backend", UNPORTED)
def test_backend_of_another_engine_fails_at_load(tmp_path, backend):
    """The JAX package routes these backends away from the llama runner
    (to the recurrent-state engine or to a remote-API client); the port
    loads the YAML and its manager builds the same kind of serving model
    (a remote client holds its ``api_token``; it contacts nothing until a
    request comes)."""
    doc = {"name": "b", "model": BACKEND_MODEL[backend], "backend": backend,
           "api_token": "tok", "api_base": "http://127.0.0.1:9"}
    (tmp_path / "b.yaml").write_text(yaml.safe_dump(doc))
    cfg = load_config_file(tmp_path / "b.yaml")
    assert (cfg.backend, cfg.api_token, cfg.api_base) == (
        backend, "tok", "http://127.0.0.1:9")
    pm, jm = _both_managers(tmp_path)
    try:
        ours, ref = pm.get("b"), jm.get("b")
        assert type(ours).__name__ == type(ref).__name__ == (
            "MambaServingModel" if backend in ("mamba", "rwkv")
            else "HFApiServingModel")
        assert not hasattr(ours, "runner")
        assert (ours.vision, ours.image_token_id) == (None, 0)
        assert pm.loaded_names() == ["b"]
    finally:
        pm.shutdown()
        jm.shutdown_all()


def test_mamba_yaml_builds_the_recurrent_engine_on_the_reference(tmp_path):
    """One YAML with ``backend: mamba``: both packages serve it with their
    MambaServingModel, and the port's answers a greedy generation through
    its scheduler (the two presets draw different random weights; token
    parity on shared weights is tests/test_torch_mamba.py's)."""
    from localai_tpu.models.mamba_serving import MambaServingModel as JaxMamba
    from localai_tpu_torch.models.mamba_serving import MambaServingModel

    (tmp_path / "m.yaml").write_text(yaml.safe_dump(
        {"name": "m", "model": "debug:mamba-tiny", "backend": "mamba"}))
    pm, jm = _both_managers(tmp_path)
    try:
        assert isinstance(jm.get("m"), JaxMamba)
        sm = pm.get("m")
        assert isinstance(sm, MambaServingModel)
        h = sm.scheduler.submit(GenRequest(
            prompt=sm.tokenizer.encode("hello", add_bos=True),
            max_new_tokens=8, temperature=0.0)).result(60)
        assert h.finish_reason in ("length", "stop")
        assert len(h.token_ids) <= 8 and not sm.busy
    finally:
        pm.shutdown()
        jm.shutdown_all()


# -- prompt templates over HTTP ---------------------------------------------

TEMPLATED_DOC = {
    "context_size": 512, "system_prompt": "Be kind.",
    "engine": ENGINE,
    "template": {
        "chat_message": "<|{{.RoleName}}|>{{if .Content}}{{.Content}}"
                        "{{else if .FunctionCall}}{{toJson .FunctionCall}}"
                        "{{end}}<|end|>",
        "chat": "{{.Input}}\n<|assistant|>",
        "functions": "{{.SystemPrompt}} tools:{{range .Functions}}"
                     "{{toJson .}}{{end}}\n{{.Input}}\n<|assistant|>",
        "completion": "Q: {{.Input}}\nA:",
        "edit": "{{.Instruction}}\n---\n{{.Input}}\n---\n"}}
CHAT_TEMPLATE_DOC = {
    "context_size": 512, "engine": ENGINE,
    "template": {"chat_template":
                 "{% for m in messages %}[{{ m['role'] }}] "
                 "{{ m['content'] | trim }}\n{% endfor %}"
                 "{% if add_generation_prompt %}[assistant] {% endif %}"}}
SMALL_TOOL = [{"type": "function", "function": {
    "name": "set_mode", "parameters": {
        "type": "object", "properties": {"on": {"type": "boolean"}},
        "required": ["on"]}}}]
HELLO = [{"role": "system", "content": "Answer briefly."},
         {"role": "user", "content": "hello there"}]


@pytest.fixture(scope="module")
def templated_servers(tmp_path_factory):
    """Both HTTP servers over one models dir: a YAML with Go templates
    (``t``), one with a Jinja chat_template (``ct``), on a tiny random
    checkpoint."""
    root = tmp_path_factory.mktemp("templated")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(7), cfg))
    models = root / "models"
    models.mkdir()
    for name, doc in (("t", TEMPLATED_DOC), ("ct", CHAT_TEMPLATE_DOC)):
        (models / f"{name}.yaml").write_text(yaml.safe_dump(
            {"name": name, "model": str(ckpt), **doc}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield port.url, ref.base
    ref.stop()
    port.shutdown()


def _post_any(url, body):
    """JSON, or the list of SSE frames of a streamed answer."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if body.get("stream"):
            return [json.loads(line[6:]) for line in r.read().splitlines()
                    if line.startswith(b"data: {")]
        return json.loads(r.read())


def _stable(out):
    """An answer with its random parts (ids, timestamps) taken out."""
    out = json.loads(json.dumps(out))
    out.pop("id", None)
    out.pop("created", None)
    for c in out.get("choices", []):
        for tc in (c.get("message") or {}).get("tool_calls") or []:
            tc.pop("id", None)
    return out


def _per_choice(frames):
    """Streamed chat frames → {index: (text, finish)} and the usage."""
    text, finish, used = {}, {}, None
    for f in frames:
        if "usage" in f:
            used = f["usage"]
        for c in f["choices"]:
            i = c["index"]
            text[i] = text.get(i, "") + (c.get("delta", {}).get("content")
                                         or c.get("text") or "")
            if c["finish_reason"] is not None:
                finish[i] = c["finish_reason"]
    return text, finish, used


CHAT_BODIES = {
    "templated-chat": {"model": "t", "messages": HELLO},
    "multi-turn": {"model": "t", "messages": HELLO + [
        {"role": "assistant", "content": "hi!"},
        {"role": "user", "content": "and now?"}]},
    "chat-template": {"model": "ct", "messages": HELLO},
    "tools-functions": {"model": "t", "messages": HELLO, "tools": SMALL_TOOL,
                        "tool_choice": "required"},
    "n2": {"model": "t", "messages": HELLO, "n": 2},
    "n2-chat-template": {"model": "ct", "messages": HELLO, "n": 2},
}


@pytest.mark.parametrize("name", sorted(CHAT_BODIES))
def test_templated_chat_answers_as_the_jax_server(templated_servers, name):
    """The same prompt tokens and the same greedy text (or the same
    seeded choices) from both servers."""
    body = {"max_tokens": 24, "temperature": 0, **CHAT_BODIES[name]}
    if name.startswith("tools"):
        body["max_tokens"] = 60
    got = [_stable(_post_any(url + "/v1/chat/completions", body))
           for url in templated_servers]
    assert got[0] == got[1]
    assert len(got[0]["choices"]) == body.get("n", 1)
    if name.startswith("n2"):
        assert got[0]["choices"][0]["message"] == \
            got[0]["choices"][1]["message"]


def test_extra_choices_sample_with_seed_plus_index(templated_servers):
    """Choice i of a seeded ``n`` > 1 request samples as a single request
    with ``seed + i`` does (the JAX package's rule; its sampler draws
    from another generator, so the texts are compared on the port)."""
    body = {"model": "ct", "messages": HELLO, "max_tokens": 12,
            "temperature": 0.9, "seed": 5}
    port = templated_servers[0] + "/v1/chat/completions"
    both = _post_any(port, dict(body, n=2))["choices"]
    for i in (0, 1):
        one = _post_any(port, dict(body, seed=5 + i))["choices"][0]
        assert both[i]["message"] == one["message"]


@pytest.mark.parametrize("model", ["t", "ct"])
def test_streamed_n2_chat_answers_as_the_jax_server(templated_servers,
                                                    model):
    body = {"model": model, "messages": HELLO, "n": 2, "max_tokens": 16,
            "temperature": 0, "stream": True}
    got = [_per_choice(_post_any(url + "/v1/chat/completions", body))
           for url in templated_servers]
    assert got[0] == got[1]
    text, finish, used = got[0]
    assert sorted(text) == [0, 1] and text[0] == text[1]
    assert finish[0] == finish[1] and used["completion_tokens"] > 0


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "stream"])
def test_list_prompt_completion_with_n2_as_the_jax_server(templated_servers,
                                                          stream):
    body = {"model": "t", "prompt": ["the sky is", "two plus two"], "n": 2,
            "max_tokens": 12, "temperature": 0, "stream": stream}
    got = [_post_any(url + "/v1/completions", body)
           for url in templated_servers]
    if stream:
        got = [_per_choice(frames)[:2] for frames in got]
        assert got[0] == got[1]
        text = got[0][0]
    else:
        got = [_stable(g) for g in got]
        assert got[0] == got[1]
        text = {c["index"]: c["text"] for c in got[0]["choices"]}
    assert sorted(text) == [0, 1, 2, 3]
    assert text[0] == text[1] and text[2] == text[3]


@pytest.mark.parametrize("prompt", ["teh cat sat", ["one", "two"]])
def test_edits_answer_as_the_jax_server(templated_servers, prompt):
    body = {"model": "t", "prompt": prompt, "instruction": "Fix it.",
            "max_tokens": 12, "temperature": 0}
    got = [_stable(_post_any(url + "/v1/edits", body))
           for url in templated_servers]
    assert got[0] == got[1]
    assert got[0]["object"] == "edit"


@pytest.mark.parametrize("ignore_eos", [False, True])
def test_ignore_eos_runs_to_max_tokens_as_on_the_jax_server(
        templated_servers, ignore_eos):
    """A logit bias makes EOS the greedy pick: without ``ignore_eos``
    both servers stop at once, with it both run to ``max_tokens``."""
    body = {"model": "t", "prompt": "x", "max_tokens": 6, "temperature": 0,
            "logit_bias": {"257": 100}, "ignore_eos": ignore_eos}
    got = [_stable(_post_any(url + "/v1/completions", body))
           for url in templated_servers]
    assert got[0] == got[1]
    assert got[0]["usage"]["completion_tokens"] == (6 if ignore_eos else 0)


@pytest.mark.parametrize("path,body", [
    ("/chat/completions", {"model": "t", "messages": HELLO}),
    ("/completions", {"model": "t", "prompt": "the sky is"}),
    ("/edits", {"model": "t", "prompt": "teh", "instruction": "Fix."}),
])
def test_unversioned_aliases_answer_as_the_jax_server(templated_servers,
                                                      path, body):
    body = {"max_tokens": 8, "temperature": 0, **body}
    got = [_stable(_post_any(url + path, body)) for url in templated_servers]
    assert got[0] == got[1]
    assert got[0] == _stable(_post_any(templated_servers[0] + "/v1" + path,
                                       body))


@pytest.mark.parametrize("query,want", [("", ["ct", "t"]),
                                        ("?filter=^c", ["ct"]),
                                        ("?filter=[", ["ct", "t"])])
def test_models_list_and_filter_as_on_the_jax_server(templated_servers,
                                                     query, want):
    for base in templated_servers:
        for path in ("/v1/models", "/models"):
            with urllib.request.urlopen(base + path + query) as r:
                names = [m["id"] for m in json.loads(r.read())["data"]]
            assert names == want


# ---------------------------------------------------------------------------
# LOCALAI_KV_PAGED / LOCALAI_KV_DTYPE (ROADMAP §C 10)

KV_ENGINE = dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
                 dtype="float32", spec=False)


@pytest.mark.parametrize("extra,env,want", [
    ({}, {}, (True, "bfloat16")),
    ({}, {"LOCALAI_KV_PAGED": "0"}, (False, "bfloat16")),
    ({}, {"LOCALAI_KV_PAGED": "1"}, (True, "bfloat16")),
    ({"kv_paged": True}, {"LOCALAI_KV_PAGED": "0"}, (True, "bfloat16")),
    ({}, {"LOCALAI_KV_DTYPE": "int8"}, (True, "int8")),
    ({}, {"LOCALAI_KV_DTYPE": "int4"}, (True, "int4")),
    ({"kv_dtype": "float32"}, {"LOCALAI_KV_DTYPE": "int8"},
     (True, "float32")),
    ({}, {"LOCALAI_KV_PAGED": "0", "LOCALAI_KV_DTYPE": "int8"},
     (False, "int8")),
    ({}, {"LOCALAI_KV_PAGED": "0", "LOCALAI_KV_DTYPE": "int4"},
     (False, "bfloat16")),
    ({"kv_paged": False}, {"LOCALAI_KV_DTYPE": "int4"}, (False, "bfloat16")),
], ids=["default", "paged-0", "paged-1", "explicit-paged-wins", "dtype-int8",
        "dtype-int4", "explicit-dtype-wins", "contiguous-int8",
        "contiguous-int4-kept", "explicit-contiguous-int4-kept"])
def test_kv_environment_settings_as_on_the_reference(monkeypatch, extra, env,
                                                     want):
    """One YAML, one environment: the runner's layout and KV dtype on both
    packages (an explicit per-model setting wins; int4 on a contiguous
    engine keeps its dtype)."""
    from localai_tpu.models.manager import build_runner as jax_build_runner
    from localai_tpu_torch.models.manager import build_runner

    for k in ("LOCALAI_KV_PAGED", "LOCALAI_KV_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    doc = {"name": "kv", "model": "debug:tiny", "context_size": 64,
           "engine": {**KV_ENGINE, **extra}}
    _, runner = build_runner(ModelConfig.from_dict(dict(doc)),
                             AppConfig(device="cpu"))
    _, jrunner = jax_build_runner(JaxModelConfig(**doc), JaxAppConfig())
    assert (runner.paged, runner.kv_dtype) == want
    assert (bool(jrunner.paged), str(jrunner.kv_dtype)) == want


# ---------------------------------------------------------------------------
# multimodal message parts, text half (ROADMAP §C 8)

MM_GO = ("{{ range .Images }}<image {{.ID}}>{{end}}"
         "{{ range .Video }}<video {{.ID}}>{{end}} {{.Text}}")
IMG = {"type": "image_url", "image_url": {"url": "https://h.invalid/a.png"}}
VID = {"type": "video_url", "video_url": {"url": "https://h.invalid/v.mp4"}}
MM_CHATS = {
    "text+image": [{"role": "user", "content": [
        {"type": "text", "text": "describe this"}, IMG]}],
    "images+video,several-messages": [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": [IMG, {"type": "text", "text": "one"},
                                     IMG]},
        {"role": "assistant", "content": "ok"},
        {"role": "user", "content": [VID, {"type": "text", "text": "two"},
                                     {"image_url": "data:image/png;base64,"
                                                   "iVBORw0KGgo="}]},
        {"role": "user", "content": [{"type": "text", "text": "plain"}]}],
}


@pytest.fixture(scope="module")
def multimodal_servers(tmp_path_factory):
    """Both HTTP servers over one models dir: ``mm`` with Go templates and
    a Go ``multimodal`` template, ``l3`` with the llama3 family
    chat_template (and the default placeholders)."""
    from localai_tpu.config.guesser import FAMILY_SETTINGS

    root = tmp_path_factory.mktemp("multimodal")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(3), cfg))
    models = root / "models"
    models.mkdir()
    docs = {"mm": {**TEMPLATED_DOC, "template": {
                **TEMPLATED_DOC["template"], "multimodal": MM_GO}},
            "l3": {"context_size": 512, "engine": ENGINE, "template": {
                "chat_template":
                    FAMILY_SETTINGS["llama3"]["chat_template"]}}}
    for name, doc in docs.items():
        (models / f"{name}.yaml").write_text(yaml.safe_dump(
            {"name": name, "model": str(ckpt), **doc}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield port, ref.base
    ref.stop()
    port.shutdown()


@pytest.mark.parametrize("model", ["mm", "l3"])
@pytest.mark.parametrize("chat", sorted(MM_CHATS))
def test_multimodal_chat_renders_as_on_the_reference(multimodal_servers,
                                                     model, chat):
    """Image and video parts become [img-N]/[vid-N] placeholders (running
    ids across messages) through the model's multimodal template, on the
    Go-template and the chat_template path alike: the same prompt tokens
    and greedy text from both servers, and the port's prompt holds the
    placeholders and no part of the request's JSON."""
    port, ref = multimodal_servers
    body = {"model": model, "messages": MM_CHATS[chat], "max_tokens": 8,
            "temperature": 0}
    sm = port.manager.get(model)
    prompts = []
    submit = sm.scheduler.submit
    sm.scheduler.submit = lambda req: prompts.append(
        sm.tokenizer.decode(list(req.prompt))) or submit(req)
    try:
        got = [_stable(_post_any(url + "/v1/chat/completions", body))
               for url in (port.url, ref)]
    finally:
        sm.scheduler.submit = submit
    assert got[0] == got[1]
    prompt = prompts[-1]
    assert "image_url" not in prompt and "h.invalid" not in prompt
    if model == "mm":
        assert "<image 0> describe this" in prompt or "<image 0><image 1>" \
            " one" in prompt
    else:
        assert "[img-0]describe this" in prompt or "[img-0][img-1]one" in \
            prompt
    if chat != "text+image":
        assert ("[img-2][vid-0]two" in prompt
                or "<image 2><video 0> two" in prompt)


@pytest.mark.parametrize("template", ["", MM_GO,
                                      "{% for i in Images %}<{{ i.ID }}>"
                                      "{% endfor %}{{ Text }}"])
@pytest.mark.parametrize("counts", [(1, 0, 0, 0, 0), (2, 1, 1, 3, 2),
                                    (0, 0, 2, 0, 5)])
def test_multimodal_placeholders_equal_the_reference(template, counts):
    from localai_tpu.templates.chat import (
        multimodal_placeholders as jax_placeholders,
    )
    from localai_tpu_torch.templates.chat import multimodal_placeholders

    n_img, n_audio, n_vid, first_img, first_vid = counts
    kw = dict(n_images=n_img, n_audio=n_audio, n_video=n_vid,
              first_image_id=first_img, first_video_id=first_vid)
    assert multimodal_placeholders(template, "txt é", **kw) == \
        jax_placeholders(template, "txt é", **kw)
