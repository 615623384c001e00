"""Ring attention: sequence-parallel prefill of one long prompt.

Port of ``localai_tpu/parallel/ring.py``. The prompt is cut into one
contiguous chunk a rank of the ``seq`` axis; each rank runs the trunk
over its chunk, and each layer's attention folds this rank's K/V chunk
first, then ``n_chunks - 1`` hops of the K/V chunk one rank along the
ring (rank i sends to i + 1 and receives from i - 1), merging every chunk
into the query rows by the online softmax in float32. The JAX package's
``lax.ppermute`` hop is one :func:`parallel.overlap.exchange` of K and
V stacked, over the ``seq`` group's process group (through pinned host
memory on a gloo group). No rank ever holds another's queries or the
whole score matrix.

The chunk attention is plain PyTorch, as it is XLA in the reference (its
einsums): no kernel runs inside the ring.

:func:`sp_prefill_forward` composes with tensor parallelism: weights
stay ``model``-sharded (each rank's head group and ffn slice, the
row-parallel ``reduce`` over the ``model`` group and the vocab-parallel
embedding), so a ring hop carries ``Hkv / model`` heads.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from localai_tpu_torch.models import llama as mdl
from localai_tpu_torch.models import quant
from localai_tpu_torch.parallel import overlap as ovl

_NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length: int, n_chunks: int, group: Any,
                   sliding_window: Optional[int] = None,
                   hops: Optional[ovl.Timed] = None) -> torch.Tensor:
    """Causal GQA ring attention over this rank's chunk: q [Tc, Hq, hd],
    k/v [Tc, Hkv, hd] (this rank's K/V chunk), ``length`` the real global
    length, ``group`` the ``seq`` axis's process group of ``n_chunks``
    ranks. The q chunk's offset is ``i * Tc`` for this rank's index i in
    ``group``, never an argument, so chunk layout and mask cannot
    disagree. ``hops`` counts and times the hops. Returns [Tc, Hq, hd] in
    q's dtype."""
    import torch.distributed as dist

    Tc, Hq, hd = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    dev = q.device
    i = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    qg = q.reshape(Tc, Hkv, g, hd).float() * hd ** -0.5
    qpos = i * Tc + torch.arange(Tc, device=dev)
    nxt, prv = ranks[(i + 1) % n_chunks], ranks[(i - 1) % n_chunks]

    m = torch.full((Hkv, g, Tc, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((Hkv, g, Tc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((Hkv, g, Tc, hd), dtype=torch.float32, device=dev)
    hops = hops if hops is not None else ovl.Timed()
    kv = torch.stack((k, v))                       # [2, Tc, Hkv, hd]
    for s in range(n_chunks):
        if s:
            # one hop along the ring: send what is in hand to the next
            # rank, take the previous rank's
            kv = hops.run(lambda kv=kv: ovl.exchange(
                torch.empty_like(kv), kv, nxt, prv, group), kv)
        k_c, v_c = kv[0], kv[1]
        j = (i - s) % n_chunks            # owner of the chunk in hand
        kpos = j * Tc + torch.arange(Tc, device=dev)
        scores = torch.einsum("tkgh,lkh->kgtl", qg, k_c.float())
        keep = (kpos[None, :] <= qpos[:, None]) & (kpos < length)[None, :]
        if sliding_window is not None:
            keep &= kpos[None, :] > qpos[:, None] - sliding_window
        scores = scores.masked_fill(~keep[None, None], _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("kgtl,lkh->kgth", p, v_c.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)                # [Hkv, g, Tc, hd]
    return out.permute(2, 0, 1, 3).reshape(Tc, Hq, hd).to(q.dtype)


@torch.no_grad()
def sp_prefill_forward(cfg: Any, params: dict, tokens: torch.Tensor,
                       length: int, mesh: Any,
                       rope: tuple[torch.Tensor, torch.Tensor],
                       reduce: Any = None,
                       hops: Optional[ovl.Timed] = None
                       ) -> tuple[torch.Tensor, tuple]:
    """Sequence-parallel prefill of one prompt ``tokens`` [T] (T divisible
    by the ``seq`` axis), composed with ``model`` (``reduce``: the
    row-parallel reduction over the ``model`` group; a vocab-sharded
    embedding is gathered over it). Runs the trunk over this rank's chunk
    of T / seq tokens through ``models.llama._layer`` with the ring
    attend; returns (the final-normed hidden rows [1, Tc, D] of this
    chunk, (k, v) each [L, Tc, Hkv_local, hd] of this chunk, roped, in
    the compute dtype). Raises where the JAX package raises: a length
    the ``seq`` axis does not divide, heads or ffn the ``model`` axis
    does not divide, an expert-parallel MoE. ``hops`` (an
    ``overlap.Timed``) counts and times the ring's hops."""
    T = int(tokens.shape[0])
    n, tp = mesh.axis_size("seq"), mesh.axis_size("model")
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by seq={n}")
    if tp > 1 and (cfg.num_heads % tp or cfg.num_kv_heads % tp
                   or cfg.intermediate_size % tp):
        raise ValueError(
            f"heads ({cfg.num_heads} q / {cfg.num_kv_heads} kv) or "
            f"intermediate_size ({cfg.intermediate_size}) not divisible "
            f"by tensor_parallel {tp}")
    if cfg.num_experts and mesh.axis_size("expert") > 1:
        raise ValueError(
            "expert-parallel MoE prefill runs on the GSPMD path, not the "
            "ring (the runner gates sequence parallelism off for this "
            "mesh)")
    Tc = T // n
    i = mesh.axis_rank("seq")
    group = mesh.groups["seq"]
    dtype = mdl.torch_dtype(cfg.dtype)
    dev = tokens.device
    positions = i * Tc + torch.arange(Tc, device=dev)
    cos_t, sin_t = rope
    pos = positions.clamp(max=cos_t.shape[0] - 1)
    cos = cos_t[pos][None, :, None, :]
    sin = sin_t[pos][None, :, None, :]
    ids = tokens[i * Tc:(i + 1) * Tc][None]
    table = params["embed"]
    if tp > 1 and table.shape[0] != cfg.vocab_size:
        x = ovl.embed_local(table, ids, dtype, mesh)
    else:
        x = quant.embed_rows(table, ids, dtype)
    ks, vs = [], []

    def attend(q, k_new, v_new):
        ks.append(k_new[0])
        vs.append(v_new[0])
        return ring_attention(q[0], k_new[0], v_new[0], length, n, group,
                              cfg.sliding_window, hops)[None]

    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = {name: w[li] for name, w in layers.items()}
        x = mdl._layer(cfg, x, lp, cos, sin, attend, reduce)
    x = mdl.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, (torch.stack(ks), torch.stack(vs))
