"""Jina-compatible rerank endpoint: POST /v1/rerank.

Port of the LLM-embedding branch of ``localai_tpu/api/jina.py``: the query
and each document are mean-pooled through the LLM engine
(``runner.embed``) and scored by the cosine of their vectors. Models with
a cross-encoder or sentence-encoder backend (``models/reranker.py`` in the
JAX package, not ported) are refused.
"""

from __future__ import annotations

import numpy as np

from localai_tpu_torch.api.openai import APIError, _model_name, _serving
from localai_tpu_torch.config.model_config import CROSS_ENCODER_BACKENDS


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
    backend = manager.loader.get(name).backend
    if backend in CROSS_ENCODER_BACKENDS:
        raise APIError(400, f"model {name!r} uses the {backend!r} backend: "
                            "cross-encoder reranking is not ported yet")
    sm, model = _serving(manager, {"model": name}, "rerank")
    q_toks = sm.tokenizer.encode(query, add_bos=True)
    q_vec = _unit(np.asarray(sm.runner.embed(q_toks)))
    scores, total_tokens = [], len(q_toks)
    for doc in documents:
        d_toks = sm.tokenizer.encode(doc, add_bos=True)
        total_tokens += len(d_toks)
        scores.append(float(q_vec @ _unit(np.asarray(sm.runner.embed(d_toks)))))
    order = sorted(range(len(documents)), key=lambda i: -scores[i])[:top_n]
    return {"model": model,
            "usage": {"total_tokens": total_tokens,
                      "prompt_tokens": total_tokens},
            "results": [{"index": i, "document": {"text": documents[i]},
                         "relevance_score": scores[i]} for i in order]}
