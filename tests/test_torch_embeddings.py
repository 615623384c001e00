"""Embeddings and rerank of the PyTorch port, on the CPU, against the JAX
package.

``runner.embed`` (mean-pooled final hidden state, the prefill kernel's
plain version on the CPU) must match the JAX runner's ``embed`` within
atol 1e-5 in float32 on both KV layouts, at prompt lengths 1, a bucket
edge and one past it. Over HTTP, ``/v1/embeddings`` returns exactly the
runner's vectors for every input form with the right usage counts,
``/v1/rerank`` orders documents by the cosine of those vectors, and a
model served with ``kv_paged: false`` returns the JAX scheduler's greedy
chat text.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax  # noqa: E402

from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import resolve_model as jax_resolve  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.templates.cache import TemplateCache as PortTemplates  # noqa: E402
from localai_tpu_torch.templates.chat import build_chat_prompt  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)
from test_torch_reranker import (  # noqa: E402
    CKPT_CFG,
    _jax_params,
    write_bert_checkpoint,
)
from test_torch_runner import _model  # noqa: E402
from test_torch_tokenizer import _wordpiece  # noqa: E402

RUNNER_KW = dict(num_slots=2, max_ctx=160, prefill_buckets=[32],
                 kv_dtype="float32")
_JAX_RUNNERS: dict = {}


def _jax_runner(paged: bool):
    if paged not in _JAX_RUNNERS:
        cfg_j, params_j, _, _ = _model("tiny")
        # the paged runner embeds through XLA attention with the prefill
        # mask, the contiguous one through the Pallas prefill kernel
        _JAX_RUNNERS[paged] = JaxRunner(
            cfg_j, params_j, paged=paged,
            attn_impl="xla" if paged else "pallas_interpret", **RUNNER_KW)
    return _JAX_RUNNERS[paged]


@pytest.mark.parametrize("n", [1, 32, 33])
@pytest.mark.parametrize("paged", [True, False])
def test_embed_matches_jax(paged, n):
    _, _, cfg_t, params_t = _model("tiny")
    r = ModelRunner(cfg_t, params_t, paged=paged, device="cpu", **RUNNER_KW)
    prompt = [int(t) for t in np.random.default_rng(n).integers(3, 258, n)]
    kv_before = [t.clone() for t in r.kv.stacked()]
    got = r.embed(prompt)
    want = np.asarray(_jax_runner(paged).embed(prompt))
    assert got.dtype == np.float32 and got.shape == (cfg_t.hidden_size,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # embed reads no serving state
    assert all(torch.equal(a, b) for a, b in zip(kv_before, r.kv.stacked()))
    assert not r.any_active and r.decode_steps == 0


def test_embed_refuses_an_input_past_the_context():
    _, _, cfg_t, params_t = _model("tiny")
    r = ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW)
    with pytest.raises(ValueError, match="exceeds context"):
        r.embed(list(range(161)))


def test_usecases_follow_the_jax_guess():
    assert ModelConfig.from_dict({"model": "x"}).guess_usecases() == {
        "chat", "completion", "edit"}
    emb = ModelConfig.from_dict({"model": "x", "embeddings": True})
    assert emb.guess_usecases() == {"chat", "completion", "edit",
                                    "embeddings", "rerank"}
    assert ModelConfig.from_dict(
        {"model": "x", "backend": "reranker"}).guess_usecases() == {"rerank"}
    known = ModelConfig.from_dict({"model": "x", "embeddings": True,
                                   "known_usecases": ["chat"]})
    assert known.has_usecase("chat") and not known.has_usecase("embeddings")


ROLES = {"system": "SYSTEM: ", "user": "USER: ", "assistant": "ASSISTANT: "}
ENGINE = dict(max_slots=4, dtype="float32", kv_dtype="float32")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("emb")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(11), cfg))
    bert = write_bert_checkpoint(root / "bert", CKPT_CFG,
                                 _jax_params(CKPT_CFG, 3),
                                 _wordpiece(lowercase=True,
                                            strip_accents=None))
    models = root / "models"
    models.mkdir()
    base = {"model": str(ckpt), "context_size": 128, "roles": ROLES}
    docs = {
        "e": {"embeddings": True, "engine": ENGINE},
        # small buckets: a reused prefix leaves room for the tail's bucket
        "c": {"embeddings": True,
              "engine": {**ENGINE, "kv_paged": False,
                         "prefill_buckets": [32, 64]}},
        "m": {"engine": ENGINE},
        "r": {"backend": "reranker", "model": str(bert)},
    }
    for name, extra in docs.items():
        (models / f"{name}.yaml").write_text(yaml.safe_dump(
            {"name": name, **base, **extra}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    server = APIServer(ModelManager(AppConfig(model_path=str(models),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    yield server, str(ckpt), loader, str(bert)
    server.shutdown()


def _post(server, path, body):
    req = urllib.request.Request(server.url + path,
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _vectors(out):
    return [np.asarray(d["embedding"], np.float32) for d in out["data"]]


def test_embeddings_every_input_form_equals_runner_embed(served):
    server = served[0]
    sm = server.manager.get("e")
    tok = sm.tokenizer
    texts = ["hello", "a somewhat longer sentence to embed here", ""]
    forms = [("hello", [tok.encode("hello", add_bos=True)]),
             (texts, [tok.encode(t, add_bos=True) for t in texts]),
             ([5, 6, 7], [[5, 6, 7]]),
             ([[5, 6], [7, 8, 9]], [[5, 6], [7, 8, 9]])]
    for i, (inp, toks) in enumerate(forms):
        path = "/v1/embeddings" if i % 2 == 0 else "/embeddings"
        out = _post(server, path, {"model": "e", "input": inp})
        assert out["object"] == "list" and out["model"] == "e"
        assert [d["index"] for d in out["data"]] == list(range(len(toks)))
        for got, t in zip(_vectors(out), toks):
            np.testing.assert_array_equal(got, sm.runner.embed(t))
        n = sum(len(t) for t in toks)
        assert out["usage"] == {"prompt_tokens": n, "completion_tokens": 0,
                                "total_tokens": n}


def test_embeddings_need_the_usecase(served):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served[0], "/v1/embeddings", {"model": "m", "input": "x"})
    assert e.value.code == 400
    assert "embeddings" in json.loads(e.value.read())["error"]["message"]


@pytest.mark.parametrize("inp", [[3, 10 ** 6], [[5], [-1]], 7])
def test_embeddings_refuse_bad_input(served, inp):
    """Token ids outside the vocabulary and inputs of no listed form get a
    400 (an id past the embedding table must never reach the card)."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served[0], "/v1/embeddings", {"model": "e", "input": inp})
    assert e.value.code == 400


def test_rerank_orders_by_embedding_cosine(served):
    server = served[0]
    sm = server.manager.get("c")
    query = "where is the cat"
    docs = ["the cat sat on the mat", "stock prices fell today",
            "a kitten is on the rug", "where"]
    out = _post(server, "/v1/rerank", {"model": "c", "query": query,
                                       "documents": docs, "top_n": 3})

    def unit(t):
        v = sm.runner.embed(sm.tokenizer.encode(t, add_bos=True))
        return v / np.linalg.norm(v)

    q = unit(query)
    cos = [float(q @ unit(d)) for d in docs]
    want = sorted(range(len(docs)), key=lambda i: -cos[i])[:3]
    assert [r["index"] for r in out["results"]] == want
    for r in out["results"]:
        assert r["document"]["text"] == docs[r["index"]]
        assert r["relevance_score"] == pytest.approx(cos[r["index"]],
                                                     abs=1e-6)
    n = sum(len(sm.tokenizer.encode(t, add_bos=True)) for t in [query, *docs])
    assert out["usage"] == {"total_tokens": n, "prompt_tokens": n}


def test_rerank_refuses_a_cross_encoder(served):
    """A ``backend: reranker`` model used to be refused here; it now scores
    (query, document) pairs with the cross-encoder, as the JAX package's
    ``/v1/rerank`` does."""
    from localai_tpu.models.reranker import resolve_reranker

    docs = ["a cat sat on the mat", "the processor", "caches"]
    out = _post(served[0], "/rerank", {"model": "r", "query": "cat",
                                       "documents": docs})
    want, n = resolve_reranker(served[3]).score_with_usage("cat", docs)
    order = sorted(range(len(docs)), key=lambda i: -want[i])
    assert [r["index"] for r in out["results"]] == order
    got = [r["relevance_score"] for r in out["results"]]
    np.testing.assert_allclose(got, [want[i] for i in order], atol=1e-5)
    assert out["usage"] == {"total_tokens": n, "prompt_tokens": n}
    assert "r" in served[0].manager.loaded_names()


def test_contiguous_chat_matches_jax_and_embeds_beside_it(served):
    """``kv_paged: false`` serves the JAX contiguous scheduler's greedy
    text, while embeddings requests run on their own threads beside the
    engine thread's decode steps."""
    server, ckpt, loader, _ = served
    sm = server.manager.get("c")
    assert not sm.runner.paged
    messages = [{"role": "user", "content": "tell me a story about a dog"}]
    prompt = build_chat_prompt(PortTemplates("."), loader.get("c"), messages)
    jm = jax_resolve(ckpt, dtype="float32")
    jr = JaxRunner(jm.cfg, jm.params, num_slots=4, max_ctx=128,
                   prefill_buckets=[32, 64], kv_dtype="float32", paged=False,
                   attn_impl="xla")
    sched = JaxScheduler(jr, jm.tokenizer)
    try:
        h = sched.generate(JaxGenRequest(
            prompt=jm.tokenizer.encode(prompt, add_bos=True),
            max_new_tokens=16, temperature=0.0))
    finally:
        sched.shutdown()
    texts = ["one", "two words", "three little words"]
    want = [sm.runner.embed(sm.tokenizer.encode(t, add_bos=True))
            for t in texts]
    got: dict = {}

    def chat():
        got["chat"] = _post(server, "/v1/chat/completions", {
            "model": "c", "messages": messages, "max_tokens": 16,
            "temperature": 0})

    def embed(i):
        got[i] = _vectors(_post(server, "/v1/embeddings",
                                {"model": "c", "input": texts[i]}))[0]

    threads = [threading.Thread(target=chat)] + [
        threading.Thread(target=embed, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    choice = got["chat"]["choices"][0]
    assert choice["message"]["content"] == h.text
    assert choice["finish_reason"] == h.finish_reason
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
    # a second identical chat reuses the released slot's prefix
    again = _post(server, "/v1/chat/completions", {
        "model": "c", "messages": messages, "max_tokens": 16,
        "temperature": 0})
    assert again["choices"][0]["message"]["content"] == h.text
    assert sm.runner.last_prefill_path == "resume"
