"""The PyTorch port's BERT cross-encoder and sentence encoder against the
JAX package's ``models/reranker.py``, on the CPU.

Parameters drawn by the JAX package are carried across with
``params_from_numpy``; the same seeded inputs then go through both. Held
equal in float32 within 1e-5: ``encode_hidden`` / ``forward`` /
``embed_forward`` (a row of all pad keys included), the debug presets'
scores and vectors with their usage counts, the pair packer's truncation
of a long document and of a long query, and a tiny HF BERT checkpoint the
test writes (with and without the ``bert.`` root and the scoring head,
with a WordPiece ``tokenizer.json`` trained by ``tokenizers``) loaded by
both packages. Over the port's HTTP server: ``/v1/rerank`` on a
cross-encoder (explicit and autodetected) and ``/v1/embeddings`` on a
sentence encoder give the JAX package's scores and vectors, a token array
is refused; the manager keeps the encoders under one lifecycle (kind
switch, single-active eviction, shutdown, preload, the cached checkpoint
sniff).
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
tokenizers = pytest.importorskip("tokenizers")

import jax  # noqa: E402

from localai_tpu.models import reranker as jr  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.models import manager as port_manager  # noqa: E402
from localai_tpu_torch.models import reranker as pr  # noqa: E402
from localai_tpu_torch.models.loader import write_checkpoint  # noqa: E402
from localai_tpu_torch.models.manager import (  # noqa: E402
    EmbeddingServingModel,
    ModelManager,
    RerankServingModel,
)
from localai_tpu_torch.utils.device import params_from_numpy  # noqa: E402
from test_torch_tokenizer import _wordpiece  # noqa: E402

TINY = pr.DEBUG_RERANKERS["reranker-tiny"]
CKPT_CFG = pr.BertConfig(vocab_size=2100, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         max_position_embeddings=128)
QUERY = "what keeps the hot set close to the processor"
DOCS = ["A cache keeps the hot set of a program close to the processor.",
        "The scheduler admits new requests between steps.",
        "", "caches caches caches",
        "Each decode step reads the whole context of every slot once " * 6]


class _Bytes:
    """The debug presets' tokenizer on both sides (UTF-8 bytes)."""

    vocab_size = 258

    @staticmethod
    def encode(text):
        return list(text.encode("utf-8"))


def _jax_params(cfg, seed=0):
    """The JAX package's random tree with every bias and layer-norm
    vector moved off its constant, so no term of the trunk is trivial."""
    tree = jax.tree.map(np.asarray, jr.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, tree)


def _pair(cls_j, cls_p, cfg, seed=0):
    tree = _jax_params(cfg, seed)
    return (cls_j(cfg, jax.tree.map(jax.numpy.asarray, tree), _Bytes()),
            cls_p(cfg, params_from_numpy(tree, "cpu"), _Bytes()))


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("B,L,all_pad", [(1, 8, False), (3, 17, False),
                                         (4, 32, True)])
def test_trunk_and_heads_equal_the_reference(B, L, all_pad):
    tree = _jax_params(TINY, 1)
    tp = params_from_numpy(tree, "cpu")
    jp = jax.tree.map(jax.numpy.asarray, tree)
    rng = np.random.default_rng(B * L)
    ids = rng.integers(0, TINY.vocab_size, (B, L))
    seg = rng.integers(0, 2, (B, L))
    mask = rng.random((B, L)) < 0.8
    mask[:, 0] = True
    if all_pad:
        mask[-1] = False    # a row of pad keys only stays finite
    t = [torch.from_numpy(x) for x in (ids, seg, mask)]
    for jf, pf in ((jr.encode_hidden, pr.encode_hidden),
                   (jr.forward, pr.forward),
                   (jr.embed_forward, pr.embed_forward)):
        want = np.asarray(jf(jp, TINY, ids, seg, mask))
        got = pf(tp, TINY, *t).numpy()
        assert np.isfinite(got).all()
        _close(got, want)


@pytest.mark.parametrize("query,docs", [
    (QUERY, DOCS),
    ("x", ["y"]),
    ("q" * 300, ["d" * 40, "short"]),             # a query over half the
    ("short query", ["long document " * 40]),     # budget; a long document
], ids=["mixed", "one-byte", "long-query", "long-doc"])
def test_debug_cross_encoder_scores_as_the_reference(query, docs):
    je, pe = _pair(jr.CrossEncoder, pr.CrossEncoder, TINY)
    want, n_want = je.score_with_usage(query, docs)
    got, n_got = pe.score_with_usage(query, docs)
    assert got.dtype == np.float32 and n_got == n_want
    _close(got, want)
    # the packer's rows (truncation and segments) are the reference's
    L = pr._pick_bucket(pe.buckets, [len(query.encode()) + len(d.encode())
                                     + 3 for d in docs])
    for d in docs:
        a = je._pair(list(query.encode()), list(d.encode()), L)
        b = pe._pair(list(query.encode()), list(d.encode()), L)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x, np.int64),
                                  np.asarray(y, np.int64))


@pytest.mark.parametrize("texts", [DOCS, ["one"], ["z" * 400, "tiny"]],
                         ids=["mixed", "one", "over-the-bucket"])
def test_debug_sentence_encoder_embeds_as_the_reference(texts):
    je, pe = _pair(jr.SentenceEncoder, pr.SentenceEncoder, TINY)
    want, n_want = je.embed_with_usage(texts)
    got, n_got = pe.embed_with_usage(texts)
    assert got.shape == (len(texts), TINY.hidden_size) and n_got == n_want
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    _close(got, want)


@pytest.mark.parametrize("lengths", [[3], [64], [65, 2], [700]])
def test_pick_bucket_equals_the_reference(lengths):
    buckets = (64, 128, 256)
    assert pr._pick_bucket(buckets, lengths) == jr._pick_bucket(buckets,
                                                                lengths)


def test_debug_resolve_draws_from_the_seed():
    a = pr.resolve_reranker("debug:reranker-tiny", seed=3, device="cpu")
    b = pr.resolve_reranker("debug:reranker-tiny", seed=3, device="cpu")
    c = pr.resolve_sentence_encoder("debug:bert-tiny", seed=4, device="cpu")
    assert np.array_equal(a.score("q", ["d"]), b.score("q", ["d"]))
    assert c.embed(["t"]).shape == (1, TINY.hidden_size)
    for bad in ("debug:nope", "debug:bert-tiny"):
        with pytest.raises(ValueError, match="unknown debug"):
            pr.resolve_reranker(bad, device="cpu")
    with pytest.raises(FileNotFoundError, match="not found"):
        pr.resolve_reranker("nowhere", device="cpu")


# -- HF checkpoints ------------------------------------------------------


@pytest.fixture(scope="module")
def wordpiece():
    return _wordpiece(lowercase=True, strip_accents=None)


def write_bert_checkpoint(path, cfg, tree, wordpiece, *, root="bert.",
                          head=True, hf_extra=None):
    """A tiny HF BERT checkpoint: ``config.json``, the tree's tensors under
    HF names (``root`` trunk, pooler and classifier with ``head``) and the
    WordPiece ``tokenizer.json``."""
    tensors = pr.hf_tensors(params_from_numpy(tree, "cpu"), root=root,
                            head=head)
    write_checkpoint(path, cfg.to_hf(**(hf_extra or {})), tensors)
    (path / "tokenizer.json").write_text(json.dumps(wordpiece))
    return path


@pytest.mark.parametrize("root,head", [("bert.", True), ("", True),
                                       ("bert.", False), ("", False)],
                         ids=["bert-root-head", "no-root-head",
                              "bert-root-trunk", "no-root-trunk"])
def test_checkpoint_loads_as_the_reference(tmp_path, wordpiece, root, head):
    d = write_bert_checkpoint(tmp_path / "ckpt", CKPT_CFG,
                              _jax_params(CKPT_CFG, 5), wordpiece,
                              root=root, head=head)
    texts = ["The cache keeps the hot set close.", "Tokens, tokens!",
             "naïve résumé 東京", "[CLS] already special [SEP]",
             "supercalifragilisticexpialidocious " * 30]
    je = jr.resolve_sentence_encoder(str(d))
    pe = pr.resolve_sentence_encoder(str(d), device="cpu")
    assert dataclasses.asdict(pe.cfg) == dataclasses.asdict(je.cfg)
    assert (pe.cfg.cls_id, pe.cfg.sep_id, pe.cfg.pad_id) == tuple(
        wordpiece["model"]["vocab"][t] for t in ("[CLS]", "[SEP]", "[PAD]"))
    want, n_want = je.embed_with_usage(texts)
    got, n_got = pe.embed_with_usage(texts)
    assert n_got == n_want
    _close(got, want)
    if not head:
        assert "pooler" not in pe.params and "classifier" not in pe.params
        return
    je = jr.resolve_reranker(str(d))
    pe = pr.resolve_reranker(str(d), device="cpu")
    want, n_want = je.score_with_usage(texts[0], texts)
    got, n_got = pe.score_with_usage(texts[0], texts)
    assert n_got == n_want
    _close(got, want)


def test_special_ids_outside_the_vocabulary_are_refused(tmp_path, wordpiece):
    """A config whose vocabulary is smaller than the tokenizer's special
    ids fails at load (the JAX package's cross-encoder check; the port's
    sentence encoder checks too: on the card the lookup would fault)."""
    small = pr.BertConfig(**{**CKPT_CFG.__dict__, "vocab_size": 3})
    d = write_bert_checkpoint(tmp_path / "ckpt", small,
                              _jax_params(small, 2), wordpiece)
    with pytest.raises(ValueError, match="exceed vocab_size"):
        jr.resolve_reranker(str(d))
    for resolve in (pr.resolve_reranker, pr.resolve_sentence_encoder):
        with pytest.raises(ValueError, match="exceed vocab_size=3"):
            resolve(str(d), device="cpu")


@pytest.mark.parametrize("model_type,want", [("bert", True),
                                             ("xlm-roberta", True),
                                             ("llama", False), (None, False)])
def test_checkpoint_sniff_equals_the_reference(tmp_path, model_type, want):
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text(
        "{not json" if model_type is None
        else json.dumps({"model_type": model_type}))
    for ref in ("m", str(d), "debug:reranker-tiny", "debug:bert-tiny",
                "missing"):
        got = pr.is_reranker_checkpoint(ref, tmp_path)
        assert got == jr.is_reranker_checkpoint(ref, tmp_path)
    assert pr.is_reranker_checkpoint("m", tmp_path) is want


# -- the HTTP routes and the manager -------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory, wordpiece):
    root = tmp_path_factory.mktemp("encoders")
    ce = write_bert_checkpoint(root / "ce", CKPT_CFG,
                               _jax_params(CKPT_CFG, 7), wordpiece)
    st = write_bert_checkpoint(root / "st", CKPT_CFG,
                               _jax_params(CKPT_CFG, 8), wordpiece, root="",
                               head=False)
    models = root / "models"
    models.mkdir()
    docs = {"rr": {"backend": "reranker", "model": str(ce)},
            "auto": {"model": str(ce)},          # detected: a classifier
            "emb": {"backend": "bert-embeddings", "model": str(st)},
            "st": {"backend": "sentencetransformers", "model": str(st)},
            "llm": {"model": "debug:tiny", "embeddings": True,
                    "engine": {"dtype": "float32", "kv_dtype": "float32",
                               "max_slots": 2}}}
    for name, doc in docs.items():
        (models / f"{name}.yaml").write_text(yaml.safe_dump(
            {"name": name, **doc}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    server = APIServer(ModelManager(AppConfig(model_path=str(models),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    yield server, ce, st
    server.shutdown()


def _post(server, path, body):
    req = urllib.request.Request(server.url + path,
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("name", ["rr", "auto"])
def test_rerank_route_scores_as_the_reference(served, name):
    server, ce, _ = served
    assert server.manager.loader.get("auto").backend == "reranker"
    docs = DOCS[:2] + ["naïve caches", "the processor"]
    out = _post(server, "/v1/rerank", {"model": name, "query": QUERY,
                                       "documents": docs, "top_n": 3})
    want, n = jr.resolve_reranker(str(ce)).score_with_usage(QUERY, docs)
    order = sorted(range(len(docs)), key=lambda i: -want[i])[:3]
    assert [r["index"] for r in out["results"]] == order
    got = [r["relevance_score"] for r in out["results"]]
    _close(got, [want[i] for i in order])
    assert out["usage"] == {"total_tokens": n, "prompt_tokens": n}
    assert out["results"][0]["document"] == {"text": docs[order[0]]}
    assert isinstance(server.manager.get_reranker(name), RerankServingModel)


@pytest.mark.parametrize("name", ["emb", "st"])
def test_embeddings_route_embeds_as_the_reference(served, name):
    server, _, st = served
    texts = ["one sentence", "and another, longer sentence to embed", ""]
    want, n = jr.resolve_sentence_encoder(str(st)).embed_with_usage(texts)
    out = _post(server, "/v1/embeddings", {"model": name, "input": texts})
    _close([d["embedding"] for d in out["data"]], want)
    assert out["usage"]["prompt_tokens"] == n
    one = _post(server, "/v1/embeddings", {"model": name,
                                           "input": texts[1]})
    _close(one["data"][0]["embedding"], want[1])
    for tokens in ([1, 2, 3], [[1, 2], [3]]):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/v1/embeddings", {"model": name,
                                             "input": tokens})
        assert e.value.code == 400
        assert "token-array" in json.loads(e.value.read())["error"][
            "message"]
    em = server.manager.get_embedder(name)
    assert isinstance(em, EmbeddingServingModel) and em.embedded >= 4


def test_encoders_refuse_chat_and_llms_keep_cosine_rerank(served):
    server = served[0]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/v1/chat/completions",
              {"model": "rr", "messages": [{"role": "user",
                                            "content": "hi"}]})
    assert e.value.code == 400
    out = _post(server, "/v1/rerank", {"model": "llm", "query": "cat",
                                       "documents": ["a cat", "a car"]})
    assert len(out["results"]) == 2


def test_manager_holds_every_kind_in_one_lifecycle(tmp_path, wordpiece):
    """Kind switch (an idle name reloads as the other kind), single-active
    eviction across kinds, ``shutdown_model`` and preload of an encoder."""
    ce = write_bert_checkpoint(tmp_path / "ce", CKPT_CFG,
                               _jax_params(CKPT_CFG, 9), wordpiece)
    models = tmp_path / "models"
    models.mkdir()
    for name, doc in (("rr", {"backend": "reranker", "model": str(ce)}),
                      ("emb", {"backend": "bert-embeddings",
                               "model": str(ce)}),
                      ("m", {"backend": "mamba",
                             "model": "debug:mamba-tiny"})):
        (models / f"{name}.yaml").write_text(yaml.safe_dump(
            {"name": name, **doc}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    app = AppConfig(model_path=str(models), device="cpu",
                    single_active_backend=True, preload_models=["rr"])
    mgr = ModelManager(app, loader)
    try:
        mgr.preload()
        assert isinstance(mgr.get_reranker("rr"), RerankServingModel)
        assert mgr.loaded_names() == ["rr"]
        mgr.get_embedder("emb")           # single-active: rr is evicted
        assert mgr.loaded_names() == ["emb"]
        sm = mgr.get("m")
        assert type(sm).__name__ == "MambaServingModel"
        assert mgr.loaded_names() == ["m"]
        enc = mgr.get_embedder("emb")
        assert mgr.get_reranker("emb") is not enc    # kind switch reloads
        assert isinstance(mgr.get_reranker("emb"), RerankServingModel)
        assert mgr.shutdown_model("emb") and mgr.loaded_names() == []
        assert not mgr.shutdown_model("emb")
        assert enc.encoder is None and not enc.alive()
        with pytest.raises(RuntimeError, match="evicted"):
            enc.embed(["x"])
    finally:
        mgr.shutdown()


def test_checkpoint_sniff_is_cached(tmp_path, monkeypatch, wordpiece):
    """``is_reranker`` for a config with no backend: a hit sticks; a miss
    expires after 30 s, so a checkpoint installed later is found."""
    clock = [1000.0]
    monkeypatch.setattr(port_manager.time, "monotonic", lambda: clock[0])
    mgr = ModelManager(AppConfig(model_path=str(tmp_path), device="cpu"),
                       ConfigLoader(tmp_path))
    cfg = ModelConfig(name="x", model="later")
    assert not mgr.is_reranker(cfg)
    write_bert_checkpoint(tmp_path / "later", CKPT_CFG,
                          _jax_params(CKPT_CFG, 1), wordpiece)
    clock[0] += 29.0
    assert not mgr.is_reranker(cfg)          # the miss is still cached
    clock[0] += 2.0
    assert mgr.is_reranker(cfg)
    (tmp_path / "later" / "config.json").unlink()
    clock[0] += 100.0
    assert mgr.is_reranker(cfg)              # a hit sticks
    assert mgr.is_reranker(ModelConfig(name="y", backend="reranker"))
    assert not mgr.is_reranker(ModelConfig(name="z", model="later",
                                           backend="mamba"))
    assert mgr.is_embedder(ModelConfig(name="e",
                                       backend="sentencetransformers"))
