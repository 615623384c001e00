"""Jina-compatible rerank endpoint: POST /v1/rerank.

Port of ``localai_tpu/api/jina.py``: a cross-encoder (``backend:
reranker``, or a bert-class checkpoint with no backend) scores every
(query, document) pair jointly in one batched forward
(``models/reranker.py``); any other model mean-pools the query and each
document through the LLM engine (``runner.embed``) and scores by the
cosine of their vectors. SLO admission control refuses it with 429 under
overload, as it does generation (``api.inference.shed_check``).
"""

from __future__ import annotations

import numpy as np

from localai_tpu_torch.api import inference as inf
from localai_tpu_torch.api.openai import (
    APIError,
    _load_failed,
    _model_name,
    _runner,
    _serving,
)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-12)


def rerank(manager, body: dict) -> dict:
    """{model, query, documents, top_n} → documents ordered by relevance."""
    query = body.get("query") or ""
    documents = [str(d) for d in body.get("documents") or []]
    if not query or not documents:
        raise APIError(400, "need query and documents")
    try:
        top_n = int(body.get("top_n") or len(documents))
    except (TypeError, ValueError):
        raise APIError(400, "top_n must be an integer") from None
    if top_n < 1:
        raise APIError(400, "top_n must be >= 1")
    name = _model_name(manager, body)
    # SLO admission control: rerank rides the same engine capacity
    inf.shed_check(name)
    if manager.is_reranker(manager.loader.get(name)):
        # joint (query ⊕ document) scoring
        try:
            rm = manager.get_reranker(name)
        except FileNotFoundError as e:
            raise _load_failed(e) from None
        raw, total_tokens = rm.score(query, documents)
        return _rerank_response(name, documents, [float(s) for s in raw],
                                total_tokens, top_n)
    sm, model = _serving(manager, {"model": name}, "rerank")
    runner = _runner(sm, "rerank")
    q_toks = sm.tokenizer.encode(query, add_bos=True)
    q_vec = _unit(np.asarray(runner.embed(q_toks)))
    scores, total_tokens = [], len(q_toks)
    for doc in documents:
        d_toks = sm.tokenizer.encode(doc, add_bos=True)
        total_tokens += len(d_toks)
        scores.append(float(q_vec @ _unit(np.asarray(runner.embed(d_toks)))))
    return _rerank_response(model, documents, scores, total_tokens, top_n)


def _rerank_response(model: str, documents: list[str], scores: list[float],
                     total_tokens: int, top_n: int) -> dict:
    order = sorted(range(len(documents)), key=lambda i: -scores[i])[:top_n]
    return {"model": model,
            "usage": {"total_tokens": total_tokens,
                      "prompt_tokens": total_tokens},
            "results": [{"index": i, "document": {"text": documents[i]},
                         "relevance_score": scores[i]} for i in order]}
