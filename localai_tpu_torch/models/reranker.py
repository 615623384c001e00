"""Cross-encoder reranker and sentence encoder: the BERT trunk in PyTorch.

Port of ``localai_tpu/models/reranker.py``: a post-LN bidirectional BERT
encoder (exact GELU, population variance in the layer norm, an additive
key mask of -1e30 so a row of pad keys stays finite) under two heads —
the cross-encoder's CLS → pooler (tanh) → classifier, which scores a
``[CLS] query [SEP] document [SEP]`` pair in one forward, and the
sentence encoder's masked mean pool followed by L2 normalisation (the
sentence-transformers default). Every pair or text of a request runs in
one batched forward, padded to the smallest length bucket that holds
them all. The JAX package also pads the batch to a power of two to bound
its compiles; eager torch compiles nothing, and each row's result is
independent of the others, so the port runs the true batch.

Parameters are plain tensors in a nested dict (``param_shapes``), drawn
from a ``torch.Generator`` for the debug presets (``init_params``),
carried across from the JAX package's tree
(``utils.device.params_from_numpy``) or
read from an HF BERT checkpoint (``_map_hf_bert``: an optional
``bert.`` root, the pooler and the classifier when present) with the
port's safetensors reader. Weights are float32, the dtype of the JAX
package's presets and of published BERT checkpoints (a half-precision
file is widened). Special ids come from the checkpoint's tokenizer
(``[CLS]``, ``[SEP]``, ``[PAD]``); a load fails when one lies outside
the vocabulary, for the sentence encoder too (on the card an
out-of-range lookup would be a device-side fault).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from localai_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 6
    num_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"
    cls_id: int = 101
    sep_id: int = 102
    pad_id: int = 0

    def to_hf(self, **extra) -> dict:
        """The ``config.json`` fields :meth:`from_hf` reads."""
        return {"model_type": "bert", "vocab_size": self.vocab_size,
                "hidden_size": self.hidden_size,
                "intermediate_size": self.intermediate_size,
                "num_hidden_layers": self.num_layers,
                "num_attention_heads": self.num_heads,
                "max_position_embeddings": self.max_position_embeddings,
                "type_vocab_size": self.type_vocab_size,
                "layer_norm_eps": self.layer_norm_eps,
                "pad_token_id": self.pad_id, **extra}

    @classmethod
    def from_hf(cls, hf: dict, **overrides) -> "BertConfig":
        kwargs = dict(
            vocab_size=hf.get("vocab_size", 30522),
            hidden_size=hf.get("hidden_size", 384),
            intermediate_size=hf.get("intermediate_size", 1536),
            num_layers=hf.get("num_hidden_layers", 6),
            num_heads=hf.get("num_attention_heads", 12),
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            type_vocab_size=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            pad_id=hf.get("pad_token_id", 0),
        )
        kwargs.update(overrides)
        return cls(**kwargs)


DEBUG_RERANKERS = {
    "reranker-tiny": BertConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=256,
        # byte tokenizer: reuse BOS/EOS as CLS/SEP, byte 0 as PAD
        cls_id=256, sep_id=257, pad_id=0,
    ),
}
DEBUG_EMBEDDERS = {
    # the same trunk serves sentence embeddings (mean pool, no head)
    "bert-tiny": DEBUG_RERANKERS["reranker-tiny"],
}


def param_shapes(cfg: BertConfig) -> Params:
    D, I = cfg.hidden_size, cfg.intermediate_size

    def dense(din, dout):
        return {"w": (din, dout), "b": (dout,)}

    def ln():
        return {"g": (D,), "b": (D,)}

    layer = {"q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
             "attn_out": dense(D, D), "attn_ln": ln(),
             "ffn_in": dense(D, I), "ffn_out": dense(I, D), "ffn_ln": ln()}
    return {
        "word_emb": (cfg.vocab_size, D),
        "pos_emb": (cfg.max_position_embeddings, D),
        "type_emb": (cfg.type_vocab_size, D),
        "emb_ln": ln(),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
        "pooler": dense(D, D),
        "classifier": dense(D, 1),
    }


def init_params(cfg: BertConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Params:
    """Random weights as the JAX package lays them out: matrices and
    embeddings N(0, 0.02) in ``cfg.dtype``; biases 0, layer-norm gains 1.
    Drawn on ``generator``'s device."""
    device = torch.device(device if device is not None else generator.device)
    dt = getattr(torch, cfg.dtype)

    def mk(name: str, shape: tuple):
        if len(shape) == 1:
            return torch.full(shape, 1.0 if name == "g" else 0.0, dtype=dt,
                              device=device)
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dt)

    def walk(tree, name=""):
        if isinstance(tree, tuple):
            return mk(name, tree)
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        return {k: walk(v, k) for k, v in tree.items()}

    return walk(param_shapes(cfg))


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)   # population variance
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def encode_hidden(params: Params, cfg: BertConfig, ids: torch.Tensor,
                  segments: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """[B, L] ids/segments/mask → [B, L, D] final hidden states (post-LN
    BERT, bidirectional attention; padded keys get -1e30 added)."""
    B, L = ids.shape
    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    pos = torch.arange(L, device=ids.device)
    x = (params["word_emb"][ids] + params["pos_emb"][pos][None]
         + params["type_emb"][segments])
    x = _ln(x, params["emb_ln"], cfg.layer_norm_eps)
    kmask = torch.zeros(mask.shape, dtype=x.dtype, device=x.device)
    kmask = kmask.masked_fill(~mask, -1e30)[:, None, None, :]
    scale = math.sqrt(Dh)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(B, L, H, Dh).transpose(1, 2)

    for lp in params["layers"]:
        q, k, v = (heads(_dense(x, lp[n])) for n in ("q", "k", "v"))
        scores = (q @ k.transpose(-1, -2)) / scale
        attn = torch.softmax(scores + kmask, dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(B, L, -1)
        x = _ln(x + _dense(ctx, lp["attn_out"]), lp["attn_ln"],
                cfg.layer_norm_eps)
        h = F.gelu(_dense(x, lp["ffn_in"]), approximate="none")
        x = _ln(x + _dense(h, lp["ffn_out"]), lp["ffn_ln"],
                cfg.layer_norm_eps)
    return x


def forward(params: Params, cfg: BertConfig, ids, segments, mask
            ) -> torch.Tensor:
    """[B, L] → [B] relevance logits (cross-encoder scoring head)."""
    x = encode_hidden(params, cfg, ids, segments, mask)
    pooled = torch.tanh(_dense(x[:, 0], params["pooler"]))
    return _dense(pooled, params["classifier"])[:, 0]


def embed_forward(params: Params, cfg: BertConfig, ids, segments, mask
                  ) -> torch.Tensor:
    """[B, L] → [B, D] L2-normalised masked mean-pooled embeddings."""
    x = encode_hidden(params, cfg, ids, segments, mask)
    m = mask[:, :, None].to(x.dtype)
    summed = (x * m).sum(1)
    counts = torch.clamp(m.sum(1), min=1.0)
    mean = summed / counts
    return mean / torch.clamp(torch.linalg.vector_norm(
        mean, dim=-1, keepdim=True), min=1e-12)


def _pick_bucket(buckets: tuple[int, ...], lengths: list[int]) -> int:
    """Smallest bucket holding every packed row (falls back to the max)."""
    for b in buckets:
        if all(n <= b for n in lengths):
            return b
    return buckets[-1]


class _Encoder:
    """Shared by both heads: the config, parameters on one device, the
    tokenizer and the length buckets (those up to the position table)."""

    def __init__(self, cfg: BertConfig, params: Params, tokenizer: Any,
                 buckets: tuple[int, ...] = (64, 128, 256, 512)):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params["word_emb"].device
        self.buckets = tuple(
            b for b in sorted(buckets) if b <= cfg.max_position_embeddings
        ) or (cfg.max_position_embeddings,)

    def _run(self, fn, ids: np.ndarray, seg: np.ndarray,
             mask: np.ndarray) -> np.ndarray:
        dev = self.device
        with torch.no_grad():
            out = fn(self.params, self.cfg,
                     torch.from_numpy(ids).to(dev),
                     torch.from_numpy(seg).to(dev),
                     torch.from_numpy(mask).to(dev))
            return out.float().cpu().numpy()


class CrossEncoder(_Encoder):
    """Batched (query, doc) scorer over length buckets: pairs pack as
    ``[CLS] query [SEP] doc [SEP]`` with segment ids 0/1, padded to the
    smallest bucket that fits, and score in one forward."""

    def _pair(self, q: list[int], d: list[int], L: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        c = self.cfg
        # truncate the document first (the query is the anchor), keeping
        # at most half the budget for the query when both do not fit
        budget = L - 3
        q = q[: max(1, budget // 2)] if len(q) + len(d) > budget else q
        d = d[: budget - len(q)]
        ids = [c.cls_id] + q + [c.sep_id] + d + [c.sep_id]
        seg = [0] * (len(q) + 2) + [1] * (len(d) + 1)
        pad = L - len(ids)
        return (np.asarray(ids + [c.pad_id] * pad, np.int64),
                np.asarray(seg + [0] * pad, np.int64),
                np.asarray([True] * len(ids) + [False] * pad, np.bool_))

    def score(self, query: str, documents: list[str]) -> np.ndarray:
        """[n_docs] relevance scores."""
        return self.score_with_usage(query, documents)[0]

    def score_with_usage(self, query: str, documents: list[str]
                         ) -> tuple[np.ndarray, int]:
        """(scores float32, total input tokens of the query and every
        document, before truncation)."""
        enc = self.tokenizer.encode
        q = enc(query)
        docs = [enc(d) for d in documents]
        total_tokens = len(q) + sum(len(d) for d in docs)
        L = _pick_bucket(self.buckets, [len(q) + len(d) + 3 for d in docs])
        rows = [self._pair(q, d, L) for d in docs]
        scores = self._run(forward, *(np.stack([r[k] for r in rows])
                                      for k in range(3)))
        return scores.astype(np.float32), total_tokens


class SentenceEncoder(_Encoder):
    """Batched text → embedding over the BERT trunk: texts pack as
    ``[CLS] text [SEP]`` (truncated to the largest bucket), one forward."""

    def embed(self, texts: list[str]) -> np.ndarray:
        """[N, D] normalised embeddings."""
        return self.embed_with_usage(texts)[0]

    def embed_with_usage(self, texts: list[str]) -> tuple[np.ndarray, int]:
        """([N, D] float32, total input tokens before truncation)."""
        c = self.cfg
        toks = [self.tokenizer.encode(t) for t in texts]
        total_tokens = sum(len(t) for t in toks)
        L = _pick_bucket(self.buckets, [len(t) + 2 for t in toks])
        ids = np.full((len(toks), L), c.pad_id, np.int64)
        mask = np.zeros((len(toks), L), np.bool_)
        for i, t in enumerate(toks):
            row = [c.cls_id] + t[: L - 2] + [c.sep_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = True
        vecs = self._run(embed_forward, ids, np.zeros_like(ids), mask)
        return vecs.astype(np.float32), total_tokens


# ---------------------------------------------------------------------------
# loading


def _map_hf_bert(cfg: BertConfig, tensors: dict,
                 device: torch.device) -> Params:
    """HF BERT layout (``[out, in]`` Linear weights) → the port's tree
    (``[in, out]``), float32 on ``device``. Cross-encoders root the trunk
    at ``bert.``; sentence-transformer exports have no root, no pooler and
    no classifier."""
    from localai_tpu_torch.models.loader import read_tensor

    root = ("bert." if "bert.embeddings.word_embeddings.weight" in tensors
            else "")

    def t(name: str, transpose: bool = False) -> torch.Tensor:
        if name not in tensors:
            raise KeyError(f"tensor {name} missing from the checkpoint")
        x = read_tensor(tensors[name]).float()
        x = x.T.contiguous() if transpose else x
        return x.to(device)

    def dense(prefix: str) -> Params:
        return {"w": t(f"{prefix}.weight", True), "b": t(f"{prefix}.bias")}

    def ln(prefix: str) -> Params:
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"{root}encoder.layer.{i}"
        layers.append({
            "q": dense(f"{p}.attention.self.query"),
            "k": dense(f"{p}.attention.self.key"),
            "v": dense(f"{p}.attention.self.value"),
            "attn_out": dense(f"{p}.attention.output.dense"),
            "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
            "ffn_in": dense(f"{p}.intermediate.dense"),
            "ffn_out": dense(f"{p}.output.dense"),
            "ffn_ln": ln(f"{p}.output.LayerNorm"),
        })
    out = {
        "word_emb": t(f"{root}embeddings.word_embeddings.weight"),
        "pos_emb": t(f"{root}embeddings.position_embeddings.weight"),
        "type_emb": t(f"{root}embeddings.token_type_embeddings.weight"),
        "emb_ln": ln(f"{root}embeddings.LayerNorm"),
        "layers": layers,
    }
    if f"{root}pooler.dense.weight" in tensors:
        out["pooler"] = dense(f"{root}pooler.dense")
    if "classifier.weight" in tensors:
        out["classifier"] = dense("classifier")
    return out


def hf_tensors(params: Params, root: str = "bert.", head: bool = True
               ) -> dict[str, torch.Tensor]:
    """The port's tree → HF BERT tensor names (``[out, in]`` Linear
    weights), the inverse of :func:`_map_hf_bert`: the trunk under
    ``root``, and with ``head`` the pooler and the classifier."""
    out: dict[str, torch.Tensor] = {}

    def dense(prefix: str, p: Params) -> None:
        out[f"{prefix}.weight"] = p["w"].T.contiguous()
        out[f"{prefix}.bias"] = p["b"]

    def ln(prefix: str, p: Params) -> None:
        out[f"{prefix}.weight"] = p["g"]
        out[f"{prefix}.bias"] = p["b"]

    e = f"{root}embeddings"
    out[f"{e}.word_embeddings.weight"] = params["word_emb"]
    out[f"{e}.position_embeddings.weight"] = params["pos_emb"]
    out[f"{e}.token_type_embeddings.weight"] = params["type_emb"]
    ln(f"{e}.LayerNorm", params["emb_ln"])
    for i, lp in enumerate(params["layers"]):
        p = f"{root}encoder.layer.{i}"
        for k, n in (("q", "query"), ("k", "key"), ("v", "value")):
            dense(f"{p}.attention.self.{n}", lp[k])
        dense(f"{p}.attention.output.dense", lp["attn_out"])
        ln(f"{p}.attention.output.LayerNorm", lp["attn_ln"])
        dense(f"{p}.intermediate.dense", lp["ffn_in"])
        dense(f"{p}.output.dense", lp["ffn_out"])
        ln(f"{p}.output.LayerNorm", lp["ffn_ln"])
    if head:
        dense(f"{root}pooler.dense", params["pooler"])
        dense("classifier", params["classifier"])
    return out


class _BertTokenizerAdapter:
    """A checkpoint's tokenizer for pair packing: encode without specials
    (the packer adds CLS/SEP), and the special ids by token."""

    def __init__(self, model_dir: Path):
        from localai_tpu_torch.utils.tokenizer import load_tokenizer

        self._tok = load_tokenizer(model_dir)
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_bos=False)

    def special_id(self, token: str) -> Optional[int]:
        """Vocabulary id of a special token like ``[CLS]``, if the
        tokenizer knows it (a byte tokenizer does not)."""
        lookup = getattr(self._tok, "token_to_id", None)
        return lookup(token) if lookup is not None else None


class _ByteTokenizerAdapter:
    """The debug presets' tokenizer: UTF-8 bytes, no specials."""

    vocab_size = 258

    @staticmethod
    def encode(text: str) -> list[int]:
        return list(text.encode("utf-8"))


def _load_checkpoint(cand: Path, device: torch.device
                     ) -> tuple[BertConfig, Params, _BertTokenizerAdapter]:
    from localai_tpu_torch.models.loader import _open_safetensors

    hf = json.loads((cand / "config.json").read_text())
    tok = _BertTokenizerAdapter(cand)
    overrides = {}
    for field_name, token, default in (
            ("cls_id", "[CLS]", 101), ("sep_id", "[SEP]", 102),
            ("pad_id", "[PAD]", hf.get("pad_token_id", 0))):
        tid = tok.special_id(token)
        overrides[field_name] = tid if tid is not None else default
    cfg = BertConfig.from_hf(hf, **overrides)
    if max(cfg.cls_id, cfg.sep_id, cfg.pad_id) >= cfg.vocab_size:
        raise ValueError(
            f"{cand}: special ids (cls={cfg.cls_id}, sep={cfg.sep_id}, "
            f"pad={cfg.pad_id}) exceed vocab_size={cfg.vocab_size}")
    return cfg, _map_hf_bert(cfg, _open_safetensors(cand), device), tok


def _resolve(ref: str, model_path: str | Path, seed: int, device,
             presets: dict, what: str, cls):
    dev = resolve_device(device)
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        if name not in presets:
            raise ValueError(f"unknown debug {what} {name!r}; "
                             f"have {sorted(presets)}")
        cfg = presets[name]
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_params(cfg, gen, dev), _ByteTokenizerAdapter())
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            return cls(*_load_checkpoint(cand, dev))
    raise FileNotFoundError(f"{what} ref {ref!r} not found")


def resolve_reranker(ref: str, model_path: str | Path = "models",
                     seed: int = 0, device: str | torch.device | None = "cuda"
                     ) -> CrossEncoder:
    """``debug:reranker-tiny`` (random weights from ``seed``, byte
    tokenizer), or a directory with an HF BERT cross-encoder checkpoint
    (``config.json``, safetensors, ``tokenizer.json``)."""
    return _resolve(ref, model_path, seed, device, DEBUG_RERANKERS,
                    "reranker", CrossEncoder)


def resolve_sentence_encoder(ref: str, model_path: str | Path = "models",
                             seed: int = 0,
                             device: str | torch.device | None = "cuda"
                             ) -> SentenceEncoder:
    """``debug:bert-tiny``, or a sentence-transformers BERT checkpoint
    directory."""
    return _resolve(ref, model_path, seed, device, DEBUG_EMBEDDERS,
                    "embedding model", SentenceEncoder)


def is_reranker_checkpoint(ref: str, model_path: str | Path) -> bool:
    """True when the ref resolves to a bert-class encoder checkpoint (the
    JAX package's sniff of ``config.json``'s ``model_type``)."""
    if ref.startswith("debug:"):
        return ref.split(":", 1)[1] in DEBUG_RERANKERS
    for cand in (Path(ref), Path(model_path) / ref):
        cj = cand / "config.json"
        if cj.exists():
            try:
                hf = json.loads(cj.read_text())
            except ValueError:
                return False
            return hf.get("model_type") in ("bert", "roberta", "xlm-roberta")
    return False
