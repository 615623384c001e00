"""HTTP server of the PyTorch port, on the CPU, against the JAX engine.

One HF-layout checkpoint (random JAX weights, float32) is loaded by both
packages: the port serves it through its stdlib HTTP server with
``device="cpu"``; the JAX side runs its paged ``ModelRunner`` (XLA
attention) under its ``Scheduler``. Greedy chat completions — streamed and
not — must return exactly the JAX text for the same prompt.
"""

import json
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax  # noqa: E402

from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import resolve_model as jax_resolve  # noqa: E402
from localai_tpu.templates.cache import TemplateCache  # noqa: E402
from localai_tpu.templates.chat import build_chat_prompt as jax_chat_prompt  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader, load_config_file  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.templates.cache import TemplateCache as PortTemplates  # noqa: E402
from localai_tpu_torch.templates.chat import build_chat_prompt  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)

ROLES = {"system": "SYSTEM: ", "user": "USER: ", "assistant": "ASSISTANT: "}
ENGINE = dict(max_slots=4, kv_block_tokens=16, prefill_chunk=32,
              dtype="float32", kv_dtype="float32")
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello there, tell me a story"}]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(9), cfg))
    models = root / "models"
    models.mkdir()
    (models / "m.yaml").write_text(yaml.safe_dump({
        "name": "m", "model": str(ckpt), "context_size": 128,
        "roles": ROLES, "engine": ENGINE}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    server = APIServer(ModelManager(AppConfig(model_path=str(models),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    jm = jax_resolve(str(ckpt), dtype="float32")
    # the port's default prefill buckets, cut at max_ctx, are [128]
    jr = JaxRunner(jm.cfg, jm.params, num_slots=4, max_ctx=128,
                   prefill_buckets=[128], kv_dtype="float32", paged=True,
                   attn_impl="xla", kv_block_tokens=16, prefill_chunk=32)
    sched = JaxScheduler(jr, jm.tokenizer)
    yield server, sched, jm.tokenizer, loader
    sched.shutdown()
    server.shutdown()


def _post(server, path, body):
    req = urllib.request.Request(server.url + path,
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _jax_text(served, prompt, n):
    _, sched, tok, _ = served
    h = sched.generate(JaxGenRequest(prompt=tok.encode(prompt, add_bos=True),
                                     max_new_tokens=n, temperature=0.0))
    return h.text, h.completion_tokens, h.finish_reason


def test_chat_prompt_matches_jax(served):
    mcfg = served[3].get("m")
    jcfg = JaxModelConfig(name="m", roles=ROLES)
    assert build_chat_prompt(PortTemplates("."), mcfg, MESSAGES) == jax_chat_prompt(
        TemplateCache("."), jcfg, MESSAGES)


def test_chat_completion_matches_jax_greedy(served):
    server = served[0]
    prompt = build_chat_prompt(PortTemplates("."), served[3].get("m"), MESSAGES)
    want, ntok, finish = _jax_text(served, prompt, 12)
    out = json.loads(_post(server, "/v1/chat/completions", {
        "model": "m", "messages": MESSAGES, "max_tokens": 12,
        "temperature": 0}))
    assert out["object"] == "chat.completion" and out["model"] == "m"
    choice = out["choices"][0]
    assert choice["message"] == {"role": "assistant", "content": want}
    assert choice["finish_reason"] == finish
    assert out["usage"]["completion_tokens"] == ntok
    assert out["usage"]["total_tokens"] == (out["usage"]["prompt_tokens"]
                                            + ntok)


def test_streamed_chat_matches_jax_greedy(served):
    server = served[0]
    prompt = build_chat_prompt(PortTemplates("."), served[3].get("m"), MESSAGES)
    want, ntok, finish = _jax_text(served, prompt, 12)
    raw = _post(server, "/v1/chat/completions", {
        "model": "m", "messages": MESSAGES, "max_tokens": 12,
        "temperature": 0, "stream": True}).decode()
    events = [e for e in raw.split("\n\n") if e]
    assert events[-1] == "data: [DONE]"
    frames = [json.loads(e[len("data: "):]) for e in events[:-1]]
    assert all(f["object"] == "chat.completion.chunk" for f in frames)
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant",
                                                "content": ""}
    text = "".join(f["choices"][0]["delta"].get("content", "")
                   for f in frames)
    assert text == want
    assert frames[-1]["choices"][0]["finish_reason"] == finish
    assert frames[-1]["usage"]["completion_tokens"] == ntok


def test_completions_stream_and_plain_agree(served):
    server = served[0]
    body = {"model": "m", "prompt": "once upon a time", "max_tokens": 8,
            "temperature": 0}
    plain = json.loads(_post(server, "/v1/completions", body))
    assert plain["object"] == "text_completion"
    raw = _post(server, "/v1/completions", {**body, "stream": True})
    frames = [json.loads(e[6:]) for e in raw.decode().split("\n\n")
              if e.startswith("data: {")]
    assert "".join(f["choices"][0]["text"] for f in frames) == \
        plain["choices"][0]["text"]
    want, _, _ = _jax_text(served, "once upon a time", 8)
    assert plain["choices"][0]["text"] == want


def test_models_readyz_and_errors(served):
    server = served[0]
    models = json.loads(urllib.request.urlopen(server.url + "/v1/models")
                        .read())
    assert [m["id"] for m in models["data"]] == ["m"]
    ready = json.loads(urllib.request.urlopen(server.url + "/readyz").read())
    assert ready["status"] == "ok" and ready["models_configured"] == 1
    for body, code in (({"model": "nope", "messages": []}, 404),
                       ({"model": "m", "messages": "x"}, 400),
                       ({"model": "m", "messages": [], "n": 2,
                         "max_tokens": 3, "temperature": 0}, 200)):
        if code == 200:  # n > 1 is served: one choice per index
            out = json.loads(_post(server, "/v1/chat/completions", body))
            assert [c["index"] for c in out["choices"]] == [0, 1]
            assert out["choices"][0]["message"] == \
                out["choices"][1]["message"]
            continue
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/v1/chat/completions", body)
        assert e.value.code == code
    req = urllib.request.Request(server.url + "/v1/chat/completions",
                                 data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400


def test_config_with_named_template_loads_and_renders_as_on_jax(tmp_path):
    """A named template loads (the port used to refuse it) and renders
    the prompt the JAX package renders from the same YAML."""
    p = tmp_path / "t.yaml"
    p.write_text(yaml.safe_dump({"name": "t", "model": "debug:tiny",
                                 "template": {"chat": "chatml"}}))
    cfg = load_config_file(p)
    assert cfg.template.chat == "chatml"
    (tmp_path / "chatml.tmpl").write_text(
        "{{.Input}}\n<|im_start|>assistant\n")
    jcfg = JaxModelConfig(**yaml.safe_load(p.read_text()))
    assert build_chat_prompt(PortTemplates(tmp_path), cfg, MESSAGES) == \
        jax_chat_prompt(TemplateCache(tmp_path), jcfg, MESSAGES) == \
        "be brief\nhello there, tell me a story\n<|im_start|>assistant\n"
    p.write_text(yaml.safe_dump({"name": "t", "model": "debug:tiny",
                                 "engine": {"max_slots": 2, "unknown": 1},
                                 "parameters": {"temperature": 0.2}}))
    cfg = load_config_file(p)
    assert cfg.engine.max_slots == 2 and cfg.parameters.temperature == 0.2


@pytest.mark.parametrize("quant", ["int8", "int4", "int8_w8a8"])
def test_quantization_config_is_read_or_refused(tmp_path, quant):
    """Every quantization the JAX package serves loads (int8_w8a8 was
    refused once); an unknown kv_dtype is refused."""
    p = tmp_path / "q.yaml"
    p.write_text(yaml.safe_dump({"name": "q", "model": "debug:tiny",
                                 "engine": {"quantization": quant,
                                            "kv_dtype": quant[:4]}}))
    cfg = load_config_file(p)
    assert (cfg.engine.quantization, cfg.engine.kv_dtype) == (quant,
                                                             quant[:4])
    p.write_text(yaml.safe_dump({"name": "q", "model": "debug:tiny",
                                 "engine": {"kv_dtype": "int2"}}))
    with pytest.raises(ValueError, match="kv_dtype"):
        load_config_file(p)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_model_serves_jax_greedy_text(served, tmp_path, quant):
    """A YAML with ``engine: {quantization, kv_dtype}`` serves the same
    greedy chat text as the JAX scheduler over the JAX-quantized weights
    and pool."""
    from localai_tpu.models import quant as jq

    ckpt = served[3].get("m").model
    models = tmp_path / "models"
    models.mkdir()
    (models / "q.yaml").write_text(yaml.safe_dump({
        "name": "q", "model": ckpt, "context_size": 128, "roles": ROLES,
        "engine": {**ENGINE, "quantization": quant, "kv_dtype": quant}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    server = APIServer(ModelManager(AppConfig(model_path=str(models),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    jm = jax_resolve(ckpt, dtype="float32")
    jr = JaxRunner(jm.cfg, jq.quantize_params(jm.params, quant), num_slots=4,
                   max_ctx=128, prefill_buckets=[128], kv_dtype=quant,
                   paged=True, attn_impl="xla", kv_block_tokens=16,
                   prefill_chunk=32)
    sched = JaxScheduler(jr, jm.tokenizer)
    try:
        prompt = build_chat_prompt(PortTemplates("."), loader.get("q"), MESSAGES)
        want, ntok, _ = _jax_text((None, sched, jm.tokenizer, None), prompt,
                                  12)
        out = json.loads(_post(server, "/v1/chat/completions", {
            "model": "q", "messages": MESSAGES, "max_tokens": 12,
            "temperature": 0}))
        assert out["choices"][0]["message"]["content"] == want
        assert out["usage"]["completion_tokens"] == ntok
        runner = server.manager.get("q").runner
        assert runner.kv.k_scale is not None
        assert runner.params["layers"]["wq"].mode == (
            "w4" if quant == "int4" else "w8")
    finally:
        sched.shutdown()
        server.shutdown()


def _chat_text(server, messages, n, **extra):
    out = json.loads(_post(server, "/v1/chat/completions", {
        "model": "m", "max_tokens": n, "temperature": 0,
        "messages": messages, **extra}))
    return out["choices"][0]["message"]["content"], \
        out["choices"][0]["finish_reason"]


def test_concurrent_chats_each_match_jax(served):
    """Requests batched together (interleaved chunked prefill + multi-step
    decode) each decode exactly as the JAX engine decodes them."""
    import threading

    server, mcfg = served[0], served[3].get("m")
    asks = [("a much longer question that needs several prefill chunks "
             "before it can start to decode anything at all", 9),
            ("short", 5), ("middle sized prompt here", 14)]
    got: dict = {}

    def run(i):
        content, n = asks[i]
        got[i] = _chat_text(server, [{"role": "user", "content": content}],
                            n)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(asks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for i, (content, n) in enumerate(asks):
        prompt = build_chat_prompt(PortTemplates("."), mcfg, [{"role": "user",
                                           "content": content}])
        want, _, finish = _jax_text(served, prompt, n)
        assert got[i] == (want, finish)


def test_stop_string_matches_jax(served):
    server, sched, tok, loader = served
    prompt = build_chat_prompt(PortTemplates("."), loader.get("m"), MESSAGES)
    full, _, _ = _jax_text(served, prompt, 12)
    stop = next(c for c in full[1:] if c != "\ufffd")
    h = sched.generate(JaxGenRequest(prompt=tok.encode(prompt, add_bos=True),
                                     max_new_tokens=12, temperature=0.0,
                                     stop=(stop,)))
    text, finish = _chat_text(server, MESSAGES, 12, stop=stop)
    assert (text, finish) == (h.text, h.finish_reason) == (
        full[:full.index(stop)], "stop")


def test_cancel_frees_the_slot_and_its_blocks(served):
    from localai_tpu_torch.engine.scheduler import GenRequest

    sm = served[0].manager.get("m")
    h = sm.scheduler.submit(GenRequest(prompt=list(b"cancel me"),
                                       max_new_tokens=100, temperature=0.0))
    for item in h:              # first streamed item: the slot is live
        break
    h.cancel()
    assert h.result(60).finish_reason == "cancelled"
    assert 0 < h.completion_tokens < 100
    runner = sm.runner
    st = runner.allocator.stats()
    assert st.used == 0 and runner.allocator.check_invariants() == []
    assert sorted(runner.free_slots()) == list(range(runner.num_slots))


@pytest.mark.parametrize("seed", range(3))
def test_stream_copy_matches_jax(seed):
    """The port's detokenizer/stop-checker copy emits exactly what the JAX
    package's does on random byte streams with multi-byte characters."""
    import numpy as np

    from localai_tpu.engine import stream as jstream
    from localai_tpu.utils.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine import stream as tstream

    rng = np.random.default_rng(seed)
    text = "".join(rng.choice(list("ab é€ stop𝄞\n"), 60))
    ids = list(text.encode())
    stops = ["stop", "é€"]
    dec = ByteTokenizer().decode
    outs = []
    for mod in (jstream, tstream):
        detok = mod.IncrementalDetokenizer(dec)
        stopper = mod.StopChecker(stops)
        emitted = [stopper.push(detok.push(i)) for i in ids]
        outs.append((emitted, stopper.flush(), stopper.stopped))
    assert outs[0] == outs[1]
