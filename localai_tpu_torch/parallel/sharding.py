"""Sharding rules: which slice of which tensor each rank keeps.

Port of ``localai_tpu/parallel/sharding.py`` (Megatron-style tensor
parallelism on the ``model`` axis). A spec is the JAX package's
``PartitionSpec`` written as a tuple — one entry a dimension, an axis name
or None — and means "this rank keeps slice ``rank`` of the dimensions
named ``model``":

  wq/wk/wv  [L, D, H*hd]   → (None, None, 'model')   column-parallel
  wo        [L, H*hd, D]   → (None, 'model', None)   row-parallel
  w_gate/up [L, D, F]      → (None, None, 'model')
  w_down    [L, F, D]      → (None, 'model', None)
  embed     [V, D]         → ('model', None)         vocab-sharded
  lm_head   [D, V]         → (None, 'model')         vocab-sharded logits
  norms                    → replicated
  paged pool [L, N, Hkv, bt, hd] → (None, None, 'model', None, None)

An axis that does not divide a dimension replicates it, with the JAX
package's warning (:func:`_sanitize`). Under ``pipe`` the specs are
``parallel.pipeline.pp_param_specs`` (each layer stack's L axis on
``pipe``, the rest replicated): a stage keeps its contiguous block of
layers, and the loaders and the seeded draw read only that block
(``pipeline.stage_layers``). Under ``seq`` every rank keeps the whole
tree (``seq`` shards activations, not weights). :func:`shard_params`
slices a loaded tree; :func:`make_shard_fn` and :func:`layer_shard_fn` are the
load-time forms (each tensor is sliced as it is read or drawn, so the
full checkpoint never lands on one card). Quantized weights keep the
scales of their output channels (:func:`expand_quantized_spec`).

The replicate fallback for the KV heads (tp does not divide them): the
JAX package keeps the whole cache on every device and lets GSPMD
broadcast the reads. Here each rank keeps only the kv head its q heads
read (this needs tp to be a multiple of the kv-head count), so the K/V
projection columns and the pool a rank holds are those of one kv head;
the values of that head equal the JAX package's replicated cache's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

import torch

from localai_tpu_torch.models.quant import QuantizedTensor, quantized_spec

log = logging.getLogger(__name__)

Spec = tuple


def _tp(mesh: Any) -> int:
    return int(mesh.shape["model"])


def _sanitize(spec: Spec, shape: tuple[int, ...], mesh: Any) -> Spec:
    """Drop mesh axes whose size does not divide the tensor dim (replicate
    that dim instead)."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None:
            out.append(None)
            continue
        size = mesh.shape[axis]
        if shape[i] % size != 0:
            log.warning(
                "dim %d of shape %s not divisible by mesh axis %r (%d); "
                "replicating", i, shape, axis, size)
            out.append(None)
        else:
            out.append(axis)
    return tuple(out)


def param_specs(cfg: Any, mesh: Any, shapes: Optional[dict] = None) -> dict:
    """Spec tree matching ``models.llama.param_shapes`` (divisibility-
    sanitized against the mesh)."""
    from localai_tpu_torch.models.llama import param_shapes

    tp = _tp(mesh)
    if cfg.num_heads % tp != 0:
        raise ValueError(
            f"num_heads {cfg.num_heads} not divisible by tensor_parallel {tp}")
    specs: dict[str, Any] = {
        "embed": ("model", None),
        "final_norm": (),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, None, "model"),
            "wk": (None, None, "model"),
            "wv": (None, None, "model"),
            "wo": (None, "model", None),
            "mlp_norm": (None, None),
            "w_gate": (None, None, "model"),
            "w_up": (None, None, "model"),
            "w_down": (None, "model", None),
        },
    }
    if cfg.attention_bias:
        specs["layers"]["bq"] = (None, "model")
        specs["layers"]["bk"] = (None, "model")
        specs["layers"]["bv"] = (None, "model")
    if cfg.num_experts:
        specs["layers"]["moe_gate"] = (None, None, None)
        specs["layers"]["w_gate"] = (None, "expert", None, "model")
        specs["layers"]["w_up"] = (None, "expert", None, "model")
        specs["layers"]["w_down"] = (None, "expert", "model", None)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "model")
    shapes = shapes or param_shapes(cfg)

    def walk(sp, sh):
        if isinstance(sp, dict):
            return {k: walk(sp[k], sh[k]) for k in sp}
        return _sanitize(sp, sh, mesh)

    return walk(specs, shapes)


def _kv_heads_sharded(cfg: Any, tp: int) -> bool:
    return cfg.num_kv_heads % tp == 0 and tp <= cfg.num_kv_heads


def kv_spec(cfg: Any, mesh: Any) -> Spec:
    """Contiguous cache [L, S, Hkv, C, hd]: layers on 'pipe' (a stage's
    cache holds its block of layers), slots on 'data', kv heads on
    'model' (replicated when tp does not divide them)."""
    tp = _tp(mesh)
    heads = "model" if _kv_heads_sharded(cfg, tp) else None
    if heads is None and tp > 1:
        log.warning(
            "kv heads (%d) not divisible by tensor_parallel (%d); "
            "replicating KV cache", cfg.num_kv_heads, tp)
    layers = ("pipe" if mesh.shape.get("pipe", 1) > 1
              and cfg.num_layers % mesh.shape["pipe"] == 0 else None)
    return (layers, "data", heads, None, None)


def paged_kv_spec(cfg: Any, mesh: Any) -> Spec:
    """Paged block pool [L, num_blocks, Hkv, block_tokens, hd]: kv heads on
    'model', everything else replicated (block ids are global)."""
    tp = _tp(mesh)
    heads = "model" if _kv_heads_sharded(cfg, tp) else None
    if heads is None and tp > 1:
        log.warning(
            "kv heads (%d) not divisible by tensor_parallel (%d); "
            "replicating the paged KV pool", cfg.num_kv_heads, tp)
    return (None, None, heads, None, None)


def block_table_spec() -> Spec:
    """Block tables [S, MB]: slots on 'data', columns replicated."""
    return ("data", None)


def state_specs(mesh: Any) -> dict:
    """Specs of the decode state's fields: every rank holds all of it
    (``data`` is 1 on a served mesh); counts and bias rows stay whole
    because every rank samples from the gathered logits."""
    return {"tokens": ("data",), "positions": ("data",),
            "active": ("data",), "keys": ("data",),
            "counts": ("data", "model"), "bias": ("data", "model"),
            "params": ("data",)}


def slots_per_data_shard(num_slots: int, mesh: Any) -> int:
    dp = mesh.shape["data"]
    if num_slots % dp != 0:
        raise ValueError(f"num_slots {num_slots} not divisible by data={dp}")
    return num_slots // dp


def expand_quantized_spec(spec: Spec, arr: Any, mesh: Any) -> Any:
    """Spec of one leaf: a plain tensor keeps ``spec``; a
    ``QuantizedTensor`` gets (q spec, scale spec), the scale's sanitized
    against its own shape so it follows the weight's output channels."""
    if isinstance(arr, QuantizedTensor):
        s_spec = _sanitize(quantized_spec(spec, arr.axis,
                                          grouped=arr.mode == "w4"),
                           tuple(arr.scale.shape), mesh)
        return (tuple(spec), s_spec)
    return tuple(spec)


# ---------------------------------------------------------------------------
# slicing


def local_heads(cfg: Any, tp: int) -> tuple[int, int]:
    """(q heads, kv heads) one rank computes (``ops.local_heads``): Hq/tp,
    and Hkv/tp or, on the replicate fallback, the one kv head its q heads
    read. Raises when tp neither divides the kv heads nor is a multiple
    of them."""
    from localai_tpu_torch.ops import local_heads as heads

    return heads(cfg.num_heads, cfg.num_kv_heads, tp)


def local_config(cfg: Any, tp: int) -> Any:
    """``cfg`` at one rank's head counts (head_dim pinned), for the cache
    and the kernels' gates."""
    hq, hkv = local_heads(cfg, tp)
    return dataclasses.replace(cfg, num_heads=hq, num_kv_heads=hkv,
                               head_dim=cfg.hd)


def _dim_slice(t: torch.Tensor, dim: int, rank: int, tp: int):
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n)


def slice_tensor(spec: Spec, t: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This rank's slice of every dim ``spec`` puts on 'model' or 'pipe'
    (a view)."""
    for d, axis in enumerate(spec):
        if axis in ("model", "pipe") and mesh.shape[axis] > 1:
            t = _dim_slice(t, d, mesh.axis_rank(axis), mesh.shape[axis])
        elif axis not in (None, "model", "pipe") \
                and mesh.shape.get(axis, 1) > 1:
            raise ValueError(f"axis {axis!r} is not sliced by the port")
    return t


def _kv_head_columns(cfg: Any, t: torch.Tensor, mesh: Any,
                     dim: int) -> torch.Tensor:
    """The replicate fallback's K/V projection columns: the kv head the
    rank's q heads read (``dim`` holds Hkv * hd columns)."""
    hq, _ = local_heads(cfg, _tp(mesh))
    g = cfg.num_heads // cfg.num_kv_heads
    head = (mesh.axis_rank("model") * hq) // g
    return t.narrow(dim, head * cfg.hd, cfg.hd)


def slice_leaf(name: str, spec: Spec, x: Any, cfg: Any, mesh: Any) -> Any:
    """One rank's slice of leaf ``name`` (a tensor or ``QuantizedTensor``;
    ``spec`` the leaf's spec as given to this tensor's dims), copied to
    its own storage. K/V projections on the replicate fallback take
    their kv head's columns."""
    tp = _tp(mesh)
    kv = name in ("wk", "wv", "bk", "bv")
    fallback = kv and tp > 1 and not _kv_heads_sharded(cfg, tp)
    if isinstance(x, QuantizedTensor):
        q_spec, s_spec = expand_quantized_spec(spec, x, mesh)
        if fallback:
            q = _kv_head_columns(cfg, x.q, mesh, x.q.dim() - 1)
            s = _kv_head_columns(cfg, x.scale, mesh, x.scale.dim() - 1)
        else:
            if x.mode == "w4" and "model" in q_spec[x.axis:x.axis + 1]:
                _check_w4_rows(x, tp)
            q = slice_tensor(q_spec, x.q, mesh)
            s = slice_tensor(s_spec, x.scale, mesh)
        return QuantizedTensor(q.contiguous(), s.contiguous(), x.axis,
                               x.mode, x.group)
    if fallback:
        return _kv_head_columns(cfg, x, mesh, x.dim() - 1).contiguous()
    return slice_tensor(spec, x, mesh).contiguous()


def _check_w4_rows(x: QuantizedTensor, tp: int) -> None:
    """A row-parallel int4 weight: each rank's K rows must hold whole
    scale groups and whole packed bytes."""
    K = x.shape[x.axis]
    local = K // tp
    if K % tp or local % 2 or (x.group and local % x.group):
        raise ValueError(
            f"int4 weight of shape {x.shape}: the local contraction of "
            f"{local} rows at tensor_parallel {tp} does not hold whole "
            f"groups of {x.group}")


def _leaves(tree: dict, specs: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, specs[k], prefix + (k,))
        else:
            yield prefix + (k,), v, specs[k]


def _specs(cfg: Any, mesh: Any) -> dict:
    """The spec tree of ``mesh``'s layout: the pipeline's under ``pipe``,
    else the tensor-parallel one."""
    if mesh.shape.get("pipe", 1) > 1:
        from localai_tpu_torch.parallel.pipeline import pp_param_specs

        return pp_param_specs(cfg, mesh)
    return param_specs(cfg, mesh)


def shard_params(params: dict, cfg: Any, mesh: Any) -> dict:
    """One rank's slices of an already loaded parameter tree."""
    specs = _specs(cfg, mesh)
    out: dict = {}
    for path, leaf, spec in _leaves(params, specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = slice_leaf(path[-1], spec, leaf, cfg, mesh)
    return out


def make_shard_fn(cfg: Any, mesh: Any, dtype: Optional[torch.dtype] = None):
    """``fn(path, tensor)`` → this rank's slice of the full leaf at
    ``path`` (keys into the parameter tree), in ``dtype`` when given, in
    its own storage: the load-time form of :func:`shard_params`."""
    specs = _specs(cfg, mesh)

    def fn(path: tuple, x: Any) -> Any:
        node: Any = specs
        for k in path:
            node = node[k]
        out = slice_leaf(path[-1], node, x, cfg, mesh)
        if dtype is not None and isinstance(out, torch.Tensor):
            out = out.to(dtype)
        return out

    return fn


def cuts(mesh: Any) -> bool:
    """Whether a rank of ``mesh`` keeps less than the whole tree: a
    ``model`` slice or a ``pipe`` stage (``seq`` ranks keep it all)."""
    return mesh is not None and (mesh.tp > 1
                                 or mesh.shape.get("pipe", 1) > 1)


def layer_shard_fn(cfg: Any, mesh: Any):
    """``fn(name, tensor)`` → what this rank keeps of one layer of the
    stacked layer weight ``name`` (its spec without the leading L axis):
    loaders and the seeded draw cut each layer as it comes (a pipeline
    stage's layer is kept whole; which layers a stage reads at all is
    ``pipeline.stage_layers``)."""
    specs = _specs(cfg, mesh)["layers"]

    def fn(name: str, x: Any) -> Any:
        return slice_leaf(name, specs[name][1:], x, cfg, mesh)

    return fn


def is_local(params: dict, cfg: Any, mesh: Any) -> bool:
    """Whether ``params`` already hold one rank's slices (a stage's block
    of layers; the q projection with the rank's columns)."""
    wq = params["layers"]["wq"]
    if mesh.shape.get("pipe", 1) > 1:
        from localai_tpu_torch.parallel.pipeline import stage_layers

        return wq.shape[0] == len(stage_layers(cfg, mesh))
    hq, _ = local_heads(cfg, _tp(mesh))
    return wq.shape[-1] == hq * cfg.hd
