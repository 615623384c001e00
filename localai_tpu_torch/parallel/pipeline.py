"""Pipeline (layer-sharded) parallelism over the ``pipe`` axis.

Port of ``localai_tpu/parallel/pipeline.py`` (llama.cpp's layer split,
its default multi-GPU layout: ``--split-mode layer``): each stage, one
process a rank, holds a contiguous block of ``L / P`` layers and the
cache of those layers only; embed, final norm and ``lm_head`` are
replicated. The point is capacity: a model whose layers do not fit one
card serves from P cards at about ``1 / P`` of them each. It is not
throughput: a decode step reads the same bytes, one stage after another.

:func:`pp_forward` is the stage chain: stage 0 embeds (or takes
``embeds``), runs its layers and sends ``[B, T, D]`` to stage 1; each
later stage receives, runs its layers and sends on; the last stage
broadcasts the final hidden over the ``pipe`` group, and every stage
applies the final norm, so every rank computes the same logits and
samples the same tokens with the same generators (no token broadcast, as
under ``model``). The JAX package's ``shard_map`` runs P ticks in which
every stage applies its block to whatever it holds and throws the
off-turn (garbage) passes away; a point-to-point chain computes only the
real pass, which gives the same values. The hand-offs go through
``parallel.overlap``'s ``send``/``recv``/``broadcast`` (pinned host
memory for a CUDA tensor on a gloo group), counted and timed by two of
the runner's ``overlap.Timed``: ``sent``, this stage's own sends (to the
next stage, and the final hidden's broadcast from the last stage), which
is the transfer, the receiving stage being blocked in its receive by
then (it has nothing to run before the hidden arrives); and ``waited``,
this stage's receives, which hold the other stages' compute too.

A stage's attention is whatever the runner injects (``attn``): on the
card the contiguous kernels K2 and K3 over the stage's own layers. The
JAX runner forces its XLA attend under ``pipe`` because a Pallas call is
not placed inside its stage chain; the runner reports that decision
(``attn_impl``) and runs its kernels here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from localai_tpu_torch.models import llama as mdl
from localai_tpu_torch.models import quant
from localai_tpu_torch.parallel import overlap as ovl


def _pipe_spec(ndim: int) -> tuple:
    """Leading axis on ``pipe``: the one spec of every layer-stacked
    weight and of the cache's layer axis."""
    return ("pipe",) + (None,) * (ndim - 1)


def stage_layers(cfg: Any, mesh: Any) -> range:
    """The layers a rank keeps: its stage's contiguous block on a
    ``pipe`` mesh, else all of them (``mesh`` may be None). A layer count
    the ``pipe`` axis does not divide raises. The loaders, the seeded
    draw, the runner and ``parallel.sharding`` all ask here."""
    n = 1 if mesh is None else mesh.shape.get("pipe", 1)
    if n == 1:
        return range(cfg.num_layers)
    if cfg.num_layers % n:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"pipe={n}")
    per = cfg.num_layers // n
    p = mesh.axis_rank("pipe")
    return range(p * per, (p + 1) * per)


def pp_param_specs(cfg: Any, mesh: Any) -> dict:
    """Specs of the pipeline layout: stacked layer weights cut their L
    axis over ``pipe``; embed, final norm and lm_head replicated. A layer
    count ``pipe`` does not divide raises (no replicate fallback).
    ``parallel.sharding`` slices by them on a ``pipe`` mesh (its
    ``shard_params`` is the JAX package's ``shard_params_pp`` there)."""
    from localai_tpu_torch.models.llama import param_shapes

    stage_layers(cfg, mesh)
    shapes = param_shapes(cfg)
    specs: dict = {
        "embed": (),
        "final_norm": (),
        "layers": {k: _pipe_spec(len(s))
                   for k, s in shapes["layers"].items()},
    }
    if "lm_head" in shapes:
        specs["lm_head"] = ()
    return specs


@torch.no_grad()
def pp_forward(cfg: Any, params: dict, tokens: torch.Tensor,
               positions: torch.Tensor, kv_write: Any, kv_stack: Any,
               mask: Optional[torch.Tensor],
               rope: tuple[torch.Tensor, torch.Tensor], mesh: Any,
               attn: Any = None, embeds: Optional[torch.Tensor] = None,
               sent: Optional[ovl.Timed] = None,
               waited: Optional[ovl.Timed] = None
               ) -> tuple[torch.Tensor, Any]:
    """``models.llama.forward`` as one stage of the ``pipe`` chain:
    ``params["layers"]`` and ``kv_stack`` hold this stage's block only.
    Same contract as ``forward``: returns (the final-normed hidden
    [B, T, D], the same on every stage; ``kv_stack``, updated in place)."""
    n = mesh.axis_size("pipe")
    p = mesh.axis_rank("pipe")
    group, ranks = mesh.groups["pipe"], mesh.axis_ranks("pipe")
    sent = sent if sent is not None else ovl.Timed()
    waited = waited if waited is not None else ovl.Timed()
    dtype = mdl.torch_dtype(cfg.dtype)
    cos_t, sin_t = rope
    pos = positions.clamp(max=cos_t.shape[0] - 1)
    cos = cos_t[pos][:, :, None, :]
    sin = sin_t[pos][:, :, None, :]
    B, T = tokens.shape[:2]
    if p == 0:
        x = (quant.embed_rows(params["embed"], tokens, dtype)
             if embeds is None else embeds.to(dtype))
    else:
        x = torch.empty((B, T, cfg.hidden_size), dtype=dtype,
                        device=tokens.device)
        waited.run(lambda: ovl.recv(x, ranks[p - 1], group), x)
    if attn is None:
        def attn(q, keys, values, m):
            return mdl._grouped_attn(cfg, q, keys, values, m)

    layers = params["layers"]
    for i in range(next(iter(layers.values())).shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        layer_kv = (None if kv_stack is None
                    else tuple(t[i] for t in kv_stack))

        def attend(q, k_new, v_new, layer_kv=layer_kv):
            _, keys, values = kv_write(layer_kv, k_new, v_new)
            return attn(q, keys, values, mask)

        x = mdl._layer(cfg, x, lp, cos, sin, attend)
    if p < n - 1:
        sent.run(lambda: ovl.send(x, ranks[p + 1], group), x)
    x = x.contiguous()
    (sent if p == n - 1 else waited).run(
        lambda: ovl.broadcast(x, ranks[n - 1], group), x)
    return mdl.rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_stack
