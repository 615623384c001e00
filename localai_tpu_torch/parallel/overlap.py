"""The row-parallel reduction and the vocab-parallel embedding of the
tensor-parallel trunk.

Port of ``localai_tpu/parallel/overlap.py``. Every meshed program of the
port runs the trunk as each rank's slice (``models.llama.forward`` with a
``reduce`` hook): Megatron column/row-parallel products over the rank's
head and ffn shard, attention over its kv-head shard of the cache, and two
reductions a layer, after attention-out and after mlp-down.

The reduction is one ``all_reduce`` (the JAX package's ``psum``) on every
mesh. The JAX package's ``overlap`` mode splits the product into chunks of
``psum_scatter`` + ``all_gather`` so that XLA's scheduler can run a
chunk's transfer beside the next chunk's matmul. An eager program issues
the row-parallel product whole before its reduction, and a communicator
runs its collectives one after another, so the same split here would only
add collectives (an intended divergence; ROADMAP item 19 part 2 keeps the
chunked form for a design that overlaps real compute). :func:`resolve_mode`
still gives the JAX package's decision, gates and reasons, which the
runner reports beside the ``psum`` it runs. ``LOCALAI_MESH_OVERLAP=0``
(the JAX package's GSPMD programs) runs the same trunk: GSPMD's
reductions are all-reduces too.

The JAX package's ``paged_decode_trunk`` (its manual-TP ``shard_map``
body) has no function of its own here: each rank's process already holds
only its slices, so ``engine.runner.ModelRunner._forward`` (the forward
with ``reduce`` and the vocab-parallel embedding) is that trunk, for
decode and for every other program of the runner.

Collectives on CUDA tensors go over the group's backend (``mesh``): NCCL,
or gloo when ranks share a card. gloo runs ``all_reduce``, ``broadcast``
and ``all_gather`` on CUDA tensors but sends and receives host tensors
only, so the point-to-point hops of ``parallel.ring`` and
``parallel.pipeline`` (:func:`exchange`, :func:`send`, :func:`recv`)
stage a CUDA tensor through pinned host memory on a gloo group and hand
the device tensor itself to NCCL: a rule of the group's backend, never a
fallback after an error.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch

from localai_tpu_torch.models import quant


def resolve_mode(cfg: Any, mesh: Any, requested: str = "auto"
                 ) -> tuple[str, str]:
    """The JAX package's reduction decision: ("overlap" | "psum" | "",
    reason), with its gates and reasons ("" is its GSPMD decode; the
    reason explains any gate that fired). The port reports it and reduces
    with ``psum`` whatever it says."""
    req = (requested or "auto").strip().lower()
    if req in ("0", "off", "none"):
        return "", ""
    if req not in ("auto", "1", "overlap", "psum"):
        return "", f"unknown LOCALAI_MESH_OVERLAP value {requested!r}"
    want = "psum" if req == "psum" else "overlap"
    if mesh is None:
        return "", ""
    tp = mesh.shape.get("model", 1)
    if tp <= 1:
        return "", ""
    busy = [ax for ax in ("data", "seq", "expert", "pipe")
            if mesh.shape.get(ax, 1) > 1]
    if busy:
        return "", (f"mesh also shards {busy}; manual-TP overlap needs "
                    "'model' as the only busy axis")
    if cfg.num_experts:
        return "", "MoE decode stays on the GSPMD path"
    if (cfg.num_heads % tp or cfg.num_kv_heads % tp
            or cfg.intermediate_size % tp or cfg.hidden_size % tp):
        return "", (
            f"heads ({cfg.num_heads} q / {cfg.num_kv_heads} kv), ffn "
            f"({cfg.intermediate_size}) or hidden ({cfg.hidden_size}) "
            f"not divisible by tensor_parallel {tp}")
    return want, ""


def _dist():
    import torch.distributed as dist

    return dist


def all_gather_rows(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Every rank's ``x`` [n, ...] stacked in rank order into ``out``
    [tp*n, ...]."""
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


class Timed:
    """Calls (``calls``) and time (``seconds``) of one kind of transfer:
    on CUDA tensors the span between two events on the rank's stream
    around each (from the moment the stream's earlier work is done to the
    moment the result is back in it, waits for the other ranks
    included), on the CPU the host's clock around the blocking call."""

    def __init__(self):
        self.calls = 0
        self._seconds = 0.0
        self._events: list = []

    def run(self, fn, x: torch.Tensor) -> Any:
        """``fn()``, timed on ``x``'s device."""
        self.calls += 1
        if not x.is_cuda:
            t0 = time.perf_counter()
            out = fn()
            self._seconds += time.perf_counter() - t0
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(x.device)
        start.record(stream)
        out = fn()
        end.record(stream)
        self._events.append((start, end))
        if len(self._events) >= 512:
            self._settle(block=False)
        return out

    def _settle(self, block: bool) -> None:
        """Fold the finished event pairs into ``seconds`` (all of them,
        waiting for the last, when ``block``)."""
        pending = []
        for start, end in self._events:
            if block:
                end.synchronize()
            elif pending or not end.query():
                pending.append((start, end))
                continue
            self._seconds += start.elapsed_time(end) / 1e3
        self._events = pending

    @property
    def seconds(self) -> float:
        self._settle(block=True)
        return self._seconds


class Reduce(Timed):
    """The row-parallel reduction of one mesh (callable on a partial
    product [..., D]): one ``all_reduce`` over the ``model`` group, its
    calls and time counted as :class:`Timed` counts them."""

    mode = "psum"

    def __init__(self, mesh: Any):
        super().__init__()
        self.mesh = mesh

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        self.run(lambda: _dist().all_reduce(x, group=self.mesh.group), x)
        return x


def make_reduce(mesh: Any) -> Optional[Reduce]:
    """The row-parallel reduction for the TP trunk; None on a mesh of
    one."""
    if mesh is None or mesh.tp <= 1:
        return None
    return Reduce(mesh)


def embed_local(table: Any, ids: torch.Tensor, dtype: torch.dtype,
                mesh: Any) -> torch.Tensor:
    """Token gather under a vocab-sharded embedding: this rank's rows, zero
    for ids outside them, summed over the group (each id's row comes from
    one rank and zeros from the rest: the unsharded gather's bytes)."""
    v_local = table.shape[0]
    offset = mesh.axis_rank("model") * v_local
    local = (ids.long() - offset).clamp(0, v_local - 1)
    rows = quant.embed_rows(table, local, dtype)
    in_range = ((ids >= offset) & (ids < offset + v_local))[..., None]
    rows = torch.where(in_range, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
    rows = rows.contiguous()
    _dist().all_reduce(rows, group=mesh.group)
    return rows


def gather_vocab(logits: torch.Tensor, mesh: Any) -> torch.Tensor:
    """Vocab-sharded logits [..., V/tp] → [..., V] on every rank (one
    all-gather; rank r holds ids [r*V/tp, (r+1)*V/tp))."""
    lead, vl = logits.shape[:-1], logits.shape[-1]
    local = logits.reshape(-1, vl).t().contiguous()          # [V/tp, N]
    out = torch.empty((vl * mesh.tp, local.shape[1]), dtype=local.dtype,
                      device=local.device)
    all_gather_rows(out, local, mesh.group)
    return out.t().reshape(*lead, vl * mesh.tp)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a point-to-point op of ``t`` on ``group`` goes through host
    memory (a CUDA tensor on a gloo group)."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def exchange(out: torch.Tensor, x: torch.Tensor, dst: int, src: int,
             group) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive ``out`` (its shape and
    dtype) from ``src`` in one batch: a ring hop (every rank sends and
    receives at once, which two blocking calls would deadlock). Returns
    ``out``."""
    dist = _dist()
    stage = _staged(x, group)
    sbuf = _host(x) if stage else x.contiguous()
    rbuf = (torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            if stage else out)
    ops = [dist.P2POp(dist.isend, sbuf, dst, group),
           dist.P2POp(dist.irecv, rbuf, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        out.copy_(rbuf)
    return out


def send(x: torch.Tensor, dst: int, group) -> None:
    """Blocking send of ``x`` to global rank ``dst`` (a stage hand-off)."""
    _dist().send(_host(x) if _staged(x, group) else x.contiguous(), dst,
                 group=group)


def recv(out: torch.Tensor, src: int, group) -> torch.Tensor:
    """Blocking receive into ``out`` from global rank ``src``."""
    if _staged(out, group):
        buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _dist().recv(buf, src, group=group)
        out.copy_(buf)
    else:
        _dist().recv(out, src, group=group)
    return out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group`` (in place)."""
    _dist().broadcast(x, src, group=group)
    return x
