"""ModelRunner: the prefill/decode executor for one loaded LLM.

Port of ``localai_tpu/engine/runner.py``, in both KV layouts: the paged
block pool (the serving default) and the contiguous slot cache
(``paged=False``, the JAX package's layout for multi-host mirrors and
self-extend), on one device or as one rank of a mesh (``mesh=``;
``parallel.multihost`` replays the leader's calls on the other ranks):
the ``model`` axis (this rank's weight slices, a cache of its kv heads,
and every program through the trunk with the row-parallel reduction of
``parallel.overlap``); the ``seq`` axis (every rank holds the whole
model and runs every program alike, but a fresh prompt of at least
``sp_threshold`` tokens is prefilled by ring attention over the ranks,
``parallel.ring``, whose K/V chunks are all-gathered into each rank's
cache); ``seq`` with ``model``; and the ``pipe`` axis (this stage's block
of layers and their cache, every program through ``parallel.pipeline``'s
stage chain, contiguous layout only). PyTorch runs eagerly, so the jitted
programs of the JAX package become plain methods:

  * ONE decode step serves all slots every iteration (continuous batching
    is slot masking over static [S] shapes); ``step_n`` runs n steps as a
    Python loop where the JAX package scans them in one program, and
    ``step_frozen_n`` does the same with some slots taking part in the
    first step only (constrained slots, whose bias row the host refreshes
    between tokens).
  * KV cache, decode state and block tables are updated in place where the
    JAX package donates buffers to get the same effect.
  * Decode attention goes through ``ops.paged_decode_attention`` (paged)
    or ``ops.decode_attention`` (contiguous), fresh contiguous prefill and
    every embeddings forward through ``ops.prefill_attention``: the CUDA
    kernels on the card, their plain PyTorch versions for CPU tensors.
    Scaled int8/int4 caches hand the decode kernels their scales.
  * Quantized weights (``models.quant``) go through the w8/w4 matmul
    kernels wherever the shape is eligible (``ops.qmatmul``).
  * Chunked paged prefill, contiguous suffix prefill (prefix reuse) and
    the speculative verify forward (``verify_async``) run plain grouped
    attention over the kept prefix + chunk or window, as the JAX package
    does in XLA; the verify's projections and lm_head take the w8/w4
    kernels at M = slots x (gamma + 1) rows.
  * Results come back asynchronously: a non-blocking copy into pinned host
    memory followed by a CUDA event (:class:`AsyncTokens`).
  * ``embed`` touches neither the KV cache nor the decode state, so the
    HTTP threads call it while the engine thread decodes.
  * A multimodal prompt (``mm_embeds`` / ``mm_positions`` on ``admit`` or
    ``begin_admit``: image rows from the vision tower, scattered over the
    placeholder positions) is prefilled in one dispatch on either layout
    — through the prefill kernel on a contiguous runner, one unchunked
    paged dispatch otherwise — and never shares or reuses a prefix.
  * Self-extend (``ga_n`` > 1, contiguous only): the cache holds unroped
    K and every attention site (decode, fresh and resume prefill,
    ``embed``) runs ``engine.selfextend``'s plain attention with the real
    RoPE table; the kernels, which assume roped K, are not called.
  * KV export and import for the disk prompt cache (``engine.
    promptcache``): ``snapshot_prefix`` copies a slot's first rows on the
    engine's stream, ``pack_prefix`` brings them to the host after that
    copy (a CUDA event orders it; another thread may call it), and
    ``load_prefix`` writes exported rows into a slot, contiguous or paged,
    so the next admission resumes past them. The format is the JAX
    package's: a directory written by either package is read by the other.
  * The host spill tier (``LOCALAI_KV_TIER_MB``, read at every paged init
    and ``reinit``): ``pack_block`` copies an evicted pool block to pinned
    host memory asynchronously on the engine's stream, with a CUDA event
    after it; ``load_block`` writes a spilled block back in place before
    the next dispatch (``fleet.kveconomy.tiering``).
  * Observability (``obs``): every program entry point is wrapped by
    ``obs.compile.watch`` under the JAX package's program names (the first
    call of a shape counts as its compile and lands in the cost catalog
    with the port's reckoned FLOPs and bytes); the synchronous entry
    points (``step``, ``step_n``, ``step_frozen_n``) leave their wall
    split into issue and blocking read in ``last_launch_ms`` /
    ``last_sync_ms`` for the dispatch anatomy; every blocking device read
    here is guarded by the stall watchdog's ``device`` channel.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import weakref
from typing import Any, Optional

import numpy as np
import torch

from localai_tpu_torch import ops
from localai_tpu_torch.engine import kvcache as kvc
from localai_tpu_torch.engine import paged as pgd
from localai_tpu_torch.engine import sampling as smp
from localai_tpu_torch.engine import selfextend as se
from localai_tpu_torch.models import llama as mdl
from localai_tpu_torch.models import quant
from localai_tpu_torch.models.llama import LlamaConfig
from localai_tpu_torch.obs import compile as obs_compile
from localai_tpu_torch.obs import watchdog as obs_watchdog
from localai_tpu_torch.ops import tuning
from localai_tpu_torch.parallel import sharding as shd
from localai_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# sampled-row sentinel for the per-row NaN/inf logits guard: a slot whose
# (biased) logits row went non-finite reports this instead of a token id;
# the scheduler fails that request only
NAN_TOKEN = -2

# speculative-window sentinel in emitted [T, S] rows: no token for this
# (step, slot), because the slot's window ended at an earlier rejection or
# the slot is inactive; the scheduler skips it
SKIP = -1


@dataclasses.dataclass
class DecodeState:
    """All per-slot mutable serving state, device-resident."""

    tokens: torch.Tensor     # [S] i32 — next token to feed per slot
    positions: torch.Tensor  # [S] i32 — next KV write position per slot
    active: torch.Tensor     # [S] bool
    counts: torch.Tensor     # [S, V] i32 — token occurrence counts
    bias: torch.Tensor       # [S, V] f32 — additive logit bias
    params: smp.SamplingParams

    @staticmethod
    def init(num_slots: int, vocab_size: int,
             device: torch.device) -> "DecodeState":
        return DecodeState(
            tokens=torch.zeros(num_slots, dtype=torch.int32, device=device),
            positions=torch.zeros(num_slots, dtype=torch.int32,
                                  device=device),
            active=torch.zeros(num_slots, dtype=torch.bool, device=device),
            counts=torch.zeros((num_slots, vocab_size), dtype=torch.int32,
                               device=device),
            bias=torch.zeros((num_slots, vocab_size), dtype=torch.float32,
                             device=device),
            params=smp.SamplingParams.init(num_slots, device),
        )


class AsyncTokens:
    """Sampled tokens whose device→host copy is already in flight: a
    non-blocking copy into pinned memory plus a CUDA event. ``np.asarray``
    waits for the event only. On the CPU the tokens are simply there."""

    def __init__(self, tokens: torch.Tensor):
        self._event = None
        if tokens.is_cuda:
            self._host = torch.empty(tokens.shape, dtype=tokens.dtype,
                                     pin_memory=True)
            self._host.copy_(tokens, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tokens.clone()

    def ready(self) -> bool:
        """Whether the host copy is complete (reading will not block)."""
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a.astype(dtype) if dtype is not None else a


def attention_path(*, device: torch.device, ga_n: int, pp: bool,
                   num_heads: int, num_kv_heads: int, head_dim: int,
                   dtype: torch.dtype, kv_dtype: Any,
                   max_ctx: int) -> tuple[str, str]:
    """(attn_impl, reason) of a runner: self-extend's plain attend, else
    ``ops.select_attn_impl``, whose gate refuses at load a shape K2/K3
    cannot take. A pipeline stage passes that gate too (it runs K2/K3 on
    its own layers) and reports the JAX package's decision, "xla": its
    Pallas calls are not placed inside its shard_map stage chain."""
    if ga_n > 1:
        return "plain", (
            "self-extend: the cache holds unroped K, so every attention "
            "site runs engine.selfextend's plain attention")
    impl, why = ops.select_attn_impl(
        device=device, num_heads=num_heads, num_kv_heads=num_kv_heads,
        head_dim=head_dim, dtype=dtype, kv_dtype=kv_dtype, max_ctx=max_ctx)
    if pp:
        return "xla", (
            "pipeline parallelism: the JAX package runs its XLA attend in "
            "the stage chain; each stage here runs the contiguous kernels "
            "on its own layers")
    return impl, why


class ModelRunner:
    """Owns params + KV cache + decode state for one model; exposes
    admit/step/release/embed to the scheduler and the API."""

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Any,
        *,
        num_slots: int = 8,
        max_ctx: Optional[int] = None,
        prefill_buckets: Optional[list[int]] = None,
        kv_dtype: str = "bfloat16",
        rope_freq_base: Optional[float] = None,
        rope_freq_scale: Optional[float] = None,
        seed: int = 0,
        paged: bool = True,
        kv_block_tokens: Optional[int] = None,
        kv_num_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        ga_n: int = 1,
        ga_w: int = 512,
        attn_impl: str = "auto",
        device: str | torch.device | None = "cuda",
        mesh: Any = None,
        sp_threshold: int = 1024,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._init_mesh(mesh, cfg, ga_n, paged)
        # prompts of at least this many tokens take the ring prefill on a
        # 'seq' mesh (engine.sp_prefill_threshold)
        self.sp_threshold = int(sp_threshold)
        if (self.mesh is not None
                and not shd.is_local(params, cfg, self.mesh)):
            params = shd.shard_params(params, cfg, self.mesh)
        self.params = params
        # stall watchdog guarding this runner's blocking device reads (the
        # scheduler rebinds it to its own instance)
        self.watchdog = obs_watchdog.WATCHDOG
        # dispatch-anatomy scratch (obs.anatomy): the synchronous entry
        # points split their wall into the eager call's return (the host
        # issuing the kernels) and the blocking read, for the caller to
        # harvest; overwritten every call
        self.last_launch_ms = 0.0
        self.last_sync_ms = 0.0
        self.num_slots = num_slots
        self.max_ctx = max_ctx or cfg.max_position_embeddings
        buckets = sorted(prefill_buckets or [128, 512, 2048, 8192])
        self.buckets = [b for b in buckets if b < self.max_ctx]
        self.buckets.append(self.max_ctx)  # any admissible prompt has a bucket
        self.rope = mdl.rope_table(cfg, self.max_ctx, freq_base=rope_freq_base,
                                   freq_scale=rope_freq_scale,
                                   device=self.device)
        # self-extend (engine.selfextend): serves past the trained context
        # with an unroped cache; forward() sees the identity table and the
        # self-extend attend applies the real one (_se_rope) per score set
        if ga_n > 1 and ga_w % ga_n:
            raise ValueError(f"ga_w ({ga_w}) must be a multiple of "
                             f"ga_n ({ga_n})")
        self.ga_n, self.ga_w = ga_n, ga_w
        if ga_n > 1:
            if paged:
                raise ValueError("paged KV cache is incompatible with "
                                 "self-extend (its cache rows are unroped "
                                 "and regrouped per slot row)")
            self._se_rope = self.rope
            self.rope = se.identity_rope(self.rope)
        self.paged = bool(paged)
        self.kv_dtype = kv_dtype
        dtype = mdl.torch_dtype(cfg.dtype)
        kv_t = (kv_dtype if kv_dtype in ("int8", "int4")
                else mdl.torch_dtype(kv_dtype))
        # prefill/embeddings attention (K3) on every runner, contiguous
        # decode attention (K2) on a contiguous one; each raises on the
        # card for a shape its kernel was not compiled for (and for int4
        # storage without the paged pool, which init_cache refuses too);
        # self-extend takes neither: K2/K3 assume pre-roped K (the JAX
        # package forces its XLA attention there)
        # the JAX package's attention setting is read and checked as that
        # package reads it (an unknown value raises here), and moves
        # nothing: one attention path per device. Self-extend overrides it
        # there too (its XLA attend), so it is not read then
        if ga_n <= 1:
            named = {ops.resolve_attn_impl(attn_impl)}
            if paged:
                named.add(ops.resolve_attn_impl(attn_impl, paged=True))
            if "xla" in named:
                log.info(
                    "attn_impl 'xla' names the JAX package's XLA attention "
                    "on a TPU; the port keeps one attention path per device "
                    "(the CUDA kernels on the card, their plain versions on "
                    "the CPU), so %s runs that path", self.device)
        self.attn_impl, why = attention_path(
            device=self.device, ga_n=ga_n, pp=self.pp_enabled,
            num_heads=self.local_cfg.num_heads,
            num_kv_heads=self.local_cfg.num_kv_heads, head_dim=cfg.hd,
            dtype=dtype, kv_dtype=None if self.paged else kv_t,
            max_ctx=self.max_ctx)
        if why:
            log.info("attention: %s (%s)", self.attn_impl, why)
        self.paged_attn_impl = ""
        self.paged_num_buffers = 2
        if self.paged:
            # per-shape tuned defaults (ops.tuning, written by
            # tools.autotune), one lookup a construction, keyed as the JAX
            # package keys it: the explicit kwarg and LOCALAI_KV_BLOCK_TOKENS
            # win, then the table, then the built-in default
            tuned = tuning.lookup(cfg.hd, cfg.num_kv_heads, kv_dtype,
                                  self.tp)
            try:
                env_bt = int(
                    os.environ.get("LOCALAI_KV_BLOCK_TOKENS", "") or 0)
            except ValueError:
                env_bt = 0
            tuned_bt = tuned.block_tokens if tuned else 0
            if tuned_bt and not (kv_block_tokens or env_bt) \
                    and self.device.type == "cuda":
                # a table written for another card or dtype may name a
                # block K1 cannot take: it degrades to the default
                why = ops.paged_gate(
                    num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.hd, block_tokens=max(8, tuned_bt),
                    kv_dtype=kv_t, dtype=dtype, tp=self.tp)
                if why:
                    log.warning(
                        "tuning entry %s (block_tokens %d) dropped: %s; "
                        "using the default", tuning.shape_key(
                            cfg.hd, cfg.num_kv_heads, kv_dtype, self.tp),
                        tuned_bt, why)
                    tuned_bt = 0
            self.block_tokens = max(8, int(kv_block_tokens or env_bt
                                           or tuned_bt
                                           or pgd.block_tokens_default()))
            # the TPU kernel's DMA depth, read and kept as the JAX package
            # keeps it; K1's cp.async ring has two stages whatever it says
            try:
                env_buf = int(
                    os.environ.get("LOCALAI_PAGED_NUM_BUFFERS", "") or 0)
            except ValueError:
                env_buf = 0
            self.paged_num_buffers = max(2, int(
                env_buf or (tuned.num_buffers if tuned else 0) or 2))
            if self.paged_num_buffers != 2:
                log.info("num_buffers %d names the TPU kernel's DMA depth; "
                         "the paged decode kernel's copy ring has two "
                         "stages, so it has no effect",
                         self.paged_num_buffers)
            if tuned is not None and tuned.impl == "xla":
                log.info("tuned impl 'xla' names the JAX package's "
                         "gather+XLA path; the port keeps one attention "
                         "path per device")
            self.max_blocks = -(-self.max_ctx // self.block_tokens)
            self.ctx_pad = self.max_blocks * self.block_tokens
            # the pool, as the JAX package sizes it: kv_num_blocks or
            # LOCALAI_KV_BLOCKS (an absolute count), else the contiguous
            # layout's footprint (every slot can still reach max_ctx)
            # scaled by LOCALAI_KV_OVERCOMMIT, plus the trash block; a
            # smaller pool holds admissions until blocks free
            try:
                self.kv_overcommit = max(0.01, float(
                    os.environ.get("LOCALAI_KV_OVERCOMMIT", "1.0") or 1.0))
            except ValueError:
                self.kv_overcommit = 1.0
            default_blocks = max(self.max_blocks, int(
                num_slots * self.max_blocks * self.kv_overcommit)) + 1
            self.num_blocks = int(kv_num_blocks
                                  or os.environ.get("LOCALAI_KV_BLOCKS", "")
                                  or default_blocks)
            chunk_env = os.environ.get("LOCALAI_PREFILL_CHUNK_TOKENS", "512")
            self.prefill_chunk = max(self.block_tokens,
                                     int(prefill_chunk or chunk_env or 512))
            # int8/int4 pools run with a bf16/f32 compute dtype; a float
            # pool must be in the compute dtype (select_paged_attn_impl
            # raises on the card for every other pairing)
            self.paged_attn_impl, why = ops.select_paged_attn_impl(
                device=self.device, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                block_tokens=self.block_tokens, kv_dtype=kv_t, dtype=dtype,
                tp=self.tp)
            if why:
                log.info("paged attention: %s (%s)", self.paged_attn_impl,
                         why)
        # contiguous prefix reuse pays off only past a minimum shared prefix
        self.prefix_reuse_min = 16
        self._seed = seed
        self.last_prefill_path = ""
        self.last_prefix_reused = 0
        self.total_prefix_reused = 0
        # decode steps issued (each launches the attention once per layer)
        self.decode_steps = 0
        # speculative verify windows run (plain attention: no decode
        # kernel launch, so they are counted apart from decode_steps)
        self.verify_windows = 0
        # step_frozen_n dispatches (their steps count in decode_steps)
        self.frozen_dispatches = 0
        # fresh contiguous prefills (each launches the prefill kernel once
        # per layer, none under self-extend; embeddings launch it too,
        # outside this count)
        self.fresh_prefills = 0
        # chunked paged prefill dispatches (each runs the trunk once)
        self.prefill_chunks = 0
        # ring prefills on a 'seq' mesh (plain attention inside the ring:
        # no kernel launch)
        self.sp_prefills = 0
        self._init_device_state()
        self._watch_programs()

    def _init_mesh(self, mesh: Any, cfg: LlamaConfig, ga_n: int,
                   paged: bool) -> None:
        """A rank of a mesh (``mesh``, ``parallel.mesh.Mesh`` of more than
        one rank), with the JAX runner's gates: ``model`` (its head counts,
        ``local_cfg``, and the row-parallel reduction of its trunk, one
        ``all_reduce``, which every program of the runner runs;
        ``overlap_mode`` / ``overlap_why`` report what the JAX package
        would run for ``LOCALAI_MESH_OVERLAP``), ``seq`` (``sp_enabled``:
        the ring prefill, off under self-extend or an expert-parallel
        MoE), ``pipe`` (``pp_enabled``: this stage's block of layers,
        alone on the mesh, contiguous, no self-extend)."""
        self.mesh = mesh if mesh is not None and mesh.plan.size() > 1 \
            else None
        self.tp = self.mesh.tp if self.mesh is not None else 1
        self.overlap_mode, self.overlap_why, self.reduce = "", "", None
        self.local_cfg = cfg
        self.sp_enabled = self.pp_enabled = False
        # the mesh's transfers, each an overlap.Timed: the stage
        # hand-offs under pipe (handoff_sent: this stage's sends, the
        # transfer; handoff_waited: its receives, the other stages'
        # compute inside), the ring's K/V hops and the K/V all-gather
        # under seq
        self.transfers: dict[str, Any] = {}
        if self.mesh is None:
            return
        from localai_tpu_torch.parallel import mesh as pmesh
        from localai_tpu_torch.parallel import overlap as ovl

        shape = self.mesh.shape
        pmesh.refuse_part2(self.mesh.plan, "ModelRunner")
        pmesh.check_pipe(self.mesh.plan)
        if ga_n > 1 and (self.tp > 1 or shape["pipe"] > 1):
            raise ValueError(
                "self-extend (grp_attn_n > 1) is not served on a "
                + ("tensor-parallel mesh" if self.tp > 1 else
                   "pipeline-parallel mesh"))
        self.local_cfg = shd.local_config(cfg, self.tp)
        if shape["pipe"] > 1:
            from localai_tpu_torch.parallel import pipeline as pp

            if paged:
                raise ValueError("paged KV cache is incompatible with "
                                 "['pipeline parallelism']")
            block = pp.stage_layers(cfg, self.mesh)
            self.pp_enabled = True
            self.local_cfg = dataclasses.replace(self.local_cfg,
                                                 num_layers=len(block))
            self.transfers = {"handoff_sent": ovl.Timed(),
                              "handoff_waited": ovl.Timed()}
            log.info("pipeline parallelism: stage %d of %d, layers %d-%d",
                     self.mesh.axis_rank("pipe"), shape["pipe"],
                     block.start, block.stop - 1)
        self.sp_enabled = (
            shape["seq"] > 1
            and (self.tp == 1 or (cfg.num_heads % self.tp == 0
                                  and cfg.num_kv_heads % self.tp == 0
                                  and cfg.intermediate_size % self.tp == 0))
            and (cfg.num_experts == 0 or shape["expert"] == 1)
            and ga_n == 1)
        if self.sp_enabled:
            self.transfers = {"ring_hop": ovl.Timed(),
                              "kv_gather": ovl.Timed()}
        self.overlap_mode, self.overlap_why = ovl.resolve_mode(
            cfg, self.mesh, os.environ.get("LOCALAI_MESH_OVERLAP", "auto"))
        self.reduce = ovl.make_reduce(self.mesh)
        log.info("mesh %s: rank %d of %d, %d q / %d kv heads and %d layers "
                 "a rank, psum reductions (the JAX package: %s%s)%s",
                 pmesh.spec_of(self.mesh.plan), self.mesh.rank,
                 self.mesh.world, self.local_cfg.num_heads,
                 self.local_cfg.num_kv_heads, self.local_cfg.num_layers,
                 self.overlap_mode or "GSPMD",
                 f", {self.overlap_why}" if self.overlap_why else "",
                 ", ring prefill" if self.sp_enabled else "")

    def _embed(self, tokens: torch.Tensor) -> Optional[torch.Tensor]:
        """Token embeddings of a rank whose table is vocab-sharded (masked
        local rows summed over the group); None where ``forward``'s own
        gather applies."""
        table = self.params["embed"]
        if self.mesh is None or table.shape[0] == self.cfg.vocab_size:
            return None
        from localai_tpu_torch.parallel import overlap as ovl

        return ovl.embed_local(table, tokens, mdl.torch_dtype(
            self.cfg.dtype), self.mesh)

    def _forward(self, tokens, positions, write, kv_stack, mask, attn=None,
                 embeds=None):
        """``models.llama.forward`` over this runner's weights and RoPE
        table, as a tensor-parallel rank's trunk on a mesh, or this stage's
        part of the pipeline chain (``parallel.pipeline.pp_forward``)."""
        if self.pp_enabled:
            from localai_tpu_torch.parallel import pipeline as pp

            return pp.pp_forward(self.cfg, self.params, tokens, positions,
                                 write, kv_stack, mask, self.rope,
                                 self.mesh, attn=attn, embeds=embeds,
                                 sent=self.transfers["handoff_sent"],
                                 waited=self.transfers["handoff_waited"])
        if embeds is None:
            embeds = self._embed(tokens)
        return mdl.forward(self.cfg, self.params, tokens, positions, write,
                           kv_stack, mask, self.rope, attn=attn,
                           embeds=embeds, reduce=self.reduce)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits [..., V]: a vocab-sharded rank's local columns gathered
        over the group (every rank then samples from the same rows)."""
        logits = mdl.logits_from_hidden(self.cfg, self.params, hidden)
        if self.mesh is not None and logits.shape[-1] != self.cfg.vocab_size:
            from localai_tpu_torch.parallel import overlap as ovl

            logits = ovl.gather_vocab(logits, self.mesh)
        return logits

    def _watch_programs(self) -> None:
        """Wrap each program entry point with ``obs.compile.watch`` under
        the JAX package's program names, each with its cost reckoning. The
        wrappers look the method up at call time through a weak reference
        (no cycle through the runner; a method patched on the instance
        still runs)."""
        ref = weakref.ref(self)

        def prog(method: str, program: str, cost):
            def call(*a, **k):
                return getattr(ref(), method)(*a, **k)

            def reckon(*a, **k):
                r = ref()
                return None if r is None else cost(r, *a, **k)

            return obs_compile.watch(call, program, cost=reckon)

        S = self.num_slots
        ctx = self.ctx_pad if self.paged else self.max_ctx

        def decode(r, *_a, n=1):   # decode, decode_n, decode_frozen_n
            return r._cost(S, n, ctx, S * ctx, S)

        def verify(r, proposals):
            T = S * (proposals.shape[1] + 1)
            return r._cost(T, 1, ctx, S * ctx, T)

        def fresh(r, tokens, *_a, **_k):
            T = tokens.shape[1]
            return r._cost(T, 1, T, 0, T)

        def resume(r, tokens, *_a, **_k):
            T = tokens.shape[1]
            return r._cost(T, 1, self.max_ctx, self.max_ctx, T)

        def chunk(r, tokens, *_a, **_k):
            T = tokens.shape[1]
            return r._cost(T, 1, ctx, ctx, T)

        def embed(r, tokens, *_a, **_k):
            T = tokens.shape[1]
            return r._cost(T, 1, T, 0, 0)

        self._decode_prog = prog("_decode_fn", "decode", decode)
        self._decode_n_prog = prog("_decode_n_fn", "decode_n", decode)
        self._decode_frozen_n_prog = prog("_decode_frozen_n_fn",
                                          "decode_frozen_n", decode)
        self._verify_prog = prog(
            "_verify_paged_fn" if self.paged else "_verify_fn", "verify",
            verify)
        self._prefill_prog = prog("_prefill_fn", "prefill", fresh)
        self._prefill_mm_prog = prog("_prefill_mm_fn", "prefill_mm", fresh)
        self._prefill_resume_prog = prog("_prefill_resume_fn",
                                         "prefill_resume", resume)
        self._prefill_paged_prog = prog("_prefill_paged_fn",
                                        "prefill_chunk", chunk)
        self._prefill_paged_mm_prog = prog("_prefill_paged_mm_fn",
                                           "prefill_mm", chunk)
        # the ring prefill (the JAX package's "prefill_sp" on both layouts)
        self._prefill_sp_prog = prog("_prefill_sp_fn", "prefill_sp", fresh)
        self._prefill_paged_sp_prog = prog("_prefill_paged_sp_fn",
                                           "prefill_sp", fresh)
        self._embed_prog = prog("_embed_fn", "embed", embed)

    def _cost(self, tokens_per_step: int, steps: int, attended: int,
              kv_rows: int, new_rows: int) -> dict:
        """The program cost catalog's reckoning (``obs.compile``) for this
        runner's weights and KV row size: ``tokens_per_step`` tokens a
        step, each attending ``attended`` rows; ``kv_rows`` cached rows
        read and ``new_rows`` written a step."""
        kv = self.kv
        rows = (self.num_blocks * self.block_tokens if self.paged
                else self.num_slots * self.max_ctx)
        total = sum(t.numel() * t.element_size()
                    for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)
                    if t is not None)
        return obs_compile.reckon_cost(
            self.local_cfg, self.params, tokens_per_step=tokens_per_step,
            steps=steps, attended_rows=attended, kv_rows=kv_rows,
            kv_row_bytes=total // max(1, rows), new_rows=new_rows)

    def _init_device_state(self) -> None:
        cfg, dev = self.cfg, self.device
        if self.paged:
            self.allocator = pgd.BlockAllocator(
                self.num_blocks, self.block_tokens, self.max_blocks)
            # disk prompt-cache rows loaded into a slot's fresh blocks (the
            # only slot-resident reuse that survives release)
            self._loaded_rows: dict[int, int] = {}
            self.block_tables = torch.zeros(
                (self.num_slots, self.max_blocks), dtype=torch.int32,
                device=dev)
            self.kv = kvc.init_paged_cache(self.local_cfg, self.num_blocks,
                                           self.block_tokens, self.kv_dtype,
                                           device=dev)
            # the host spill tier under the prefix pool
            # (LOCALAI_KV_TIER_MB, off by default), read at every init and
            # reinit: a rebuilt pool starts cold, and stale spills of the
            # old pool must not shadow it
            from localai_tpu_torch.fleet.kveconomy.tiering import (
                tier_from_env,
            )

            tier = tier_from_env()
            if tier is not None:
                self.allocator.attach_tier(tier, pack=self.pack_block,
                                           load=self.load_block)
        else:
            self.allocator = self.block_tables = None
            self.kv = kvc.init_cache(self.local_cfg, self.num_slots,
                                     self.max_ctx,
                                     self.kv_dtype, device=dev)
        self.state = DecodeState.init(self.num_slots, cfg.vocab_size, dev)
        # per-slot generators: a slot's stream advances only when it samples
        self._gens = [torch.Generator(device=dev).manual_seed(
            self._seed * 1_000_003 + s) for s in range(self.num_slots)]
        self._greedy = [False] * self.num_slots
        self._free_slots = list(range(self.num_slots))
        # host mirror of which slots are serving: admit/release are the only
        # transitions, so liveness queries never touch the device
        self._active_slots: set[int] = set()

    def reinit(self) -> None:
        """Self-healing engine rebuild (``faults.supervisor``): drop the
        possibly-corrupt serving state and allocate a fresh KV pool,
        decode state, block tables, allocator, per-slot generators and
        slot lists in the original layout. The old tensors are rebound,
        never zeroed or reused: an abandoned engine thread that wakes from
        a wedged round-trip may still hold them, and whatever it writes
        there the rebuilt engine never reads (they are freed when it
        drops them). Callers own slot bookkeeping — every previously
        admitted request must already be failed. A sticky CUDA error is
        not mended here: the next launch raises again."""
        self._init_device_state()
        self.last_prefill_path = ""
        self.last_prefix_reused = 0

    # -- device programs -------------------------------------------------

    def _sample_generators(self, slots) -> list[Optional[torch.Generator]]:
        return [self._gens[s] if (s in slots and not self._greedy[s])
                else None for s in range(self.num_slots)]

    @torch.no_grad()
    def _decode_fn(self, sampling: Optional[set[int]] = None
                   ) -> torch.Tensor:
        """One batched single-token decode over the KV cache of either
        layout; advances the state in place and returns the sampled tokens
        [S] int32. ``sampling`` is the host set of slots that are active
        in this step (default: every live slot): only their generators
        advance."""
        cfg, st = self.cfg, self.state
        pos, window = st.positions, cfg.sliding_window
        if self.paged:
            tables = self.block_tables
            write = kvc.paged_decode_write(tables, pos)

            def kernel(q, keys, values, k_scale, v_scale):
                return ops.paged_decode_attention(
                    q, keys, values, tables, pos, k_scale, v_scale,
                    sliding_window=window)
        else:
            write = kvc.decode_write(pos)

            def kernel(q, keys, values, k_scale, v_scale):
                return ops.decode_attention(q, keys, values, pos, k_scale,
                                            v_scale, sliding_window=window)

        if self.ga_n > 1:
            # every slot's whole row, dequantized in the compute dtype as
            # the JAX package's decode write exposes it, under the decode
            # mask (the verify mask of a one-token window)
            attend = self._se_attn(pos[:, None], torch.arange(
                self.max_ctx, device=self.device))
            mask = kvc.verify_mask(cfg, pos, 1, self.max_ctx)

            def attn(q, keys, values, _mask):
                return attend(q, kvc.dequantized(keys, q.dtype),
                              kvc.dequantized(values, q.dtype), mask)
        else:
            def attn(q, keys, values, _mask):  # q [S,1,Hq,hd]; keys = cache
                if isinstance(keys, tuple):  # (cache, scales): scaled
                    (keys, k_scale), (values, v_scale) = keys, values
                else:
                    k_scale = v_scale = None
                return kernel(q[:, 0].contiguous(), keys, values, k_scale,
                              v_scale)[:, None]

        hidden, _ = self._forward(st.tokens[:, None], pos[:, None], write,
                                  self.kv.stacked(), None, attn=attn)
        self.decode_steps += 1
        return self._decode_tail(
            hidden, self._active_slots if sampling is None else sampling)

    def _decode_n_fn(self, n: int) -> torch.Tensor:
        """n decode steps (a Python loop where the JAX package scans them
        in one program); returns tokens [n, S]. Paged block tables are
        loop-invariant: every admitted slot's table already covers its
        full reservation."""
        out = torch.empty((n, self.num_slots), dtype=torch.int32,
                          device=self.device)
        for i in range(n):
            out[i] = self._decode_fn()
        return out

    def _decode_frozen_n_fn(self, freeze: torch.Tensor, frozen: set[int],
                            n: int) -> torch.Tensor:
        """n decode steps where the slots in ``freeze`` ([S] bool; the
        host set ``frozen``) advance only on the FIRST step — the per-slot
        constraint gating path: a grammar-constrained slot needs its bias
        row refreshed by the host between tokens (one token a dispatch),
        while the unconstrained slots ride the same dispatch for n tokens.
        Steps 1..n-1 run with ``active & ~freeze``: a frozen slot's
        counts, position, token and generator stay as step 0 left them,
        and it writes the K/V of its pending token at its unadvanced
        position, the row and token the next dispatch writes again.
        ``active`` is restored afterwards. Returns tokens [n, S]; rows
        1..n-1 are meaningful for non-frozen slots only."""
        st = self.state
        out = torch.empty((n, self.num_slots), dtype=torch.int32,
                          device=self.device)
        out[0] = self._decode_fn()
        if n > 1:
            full_active = st.active.clone()
            st.active.copy_(full_active & ~freeze)
            live = self._active_slots - frozen
            try:
                for i in range(1, n):
                    out[i] = self._decode_fn(live)
            finally:
                st.active.copy_(full_active)
        self.frozen_dispatches += 1
        return out

    def _decode_tail(self, hidden: torch.Tensor,
                     sampling: set[int]) -> torch.Tensor:
        """Sampling + per-slot state advance after a decode forward;
        ``sampling``: the slots whose generators may advance."""
        st = self.state
        pos = st.positions
        logits = self._logits(hidden[:, 0])
        tokens = smp.sample(logits, st.params, st.counts,
                            self._sample_generators(sampling), st.bias)
        tokens = torch.where(st.active, tokens, st.tokens)
        # per-row NaN/inf guard on the effective (biased) logits: one bad
        # row fails only its own slot; the verdict rides the token row
        row_ok = torch.isfinite(logits.float() + st.bias).all(dim=-1)
        tokens = torch.where(st.active & ~row_ok,
                             torch.full_like(tokens, NAN_TOKEN), tokens)
        # clamp the sentinel out of the scatter index
        smp.update_counts(st.counts, tokens.clamp(min=0), st.active)
        st.positions.copy_(torch.where(
            st.active, (pos + 1).clamp(max=self.max_ctx - 1), pos))
        st.tokens.copy_(tokens)
        return tokens

    # -- speculative verify (localai_tpu_torch.spec drives these) --------

    def _accept_scan(self, logits: torch.Tensor,
                     proposals: torch.Tensor) -> torch.Tensor:
        """Accept/sample scan over a speculative window: the full sampler
        chain per position with the counts updated in order, so emitted
        tokens follow the non-speculative sampling distribution (a draft
        token is accepted iff it equals the token the target sampled
        there; on a mismatch the target's sample is the correction and
        the window ends). A Python loop over the T positions; a slot's
        generator is passed only while that slot still emits, so it
        advances once per EMITTED token and a seeded stream with
        speculation equals the one without.

        logits [S, T, V], proposals [S, T-1]. Advances the decode state
        in place: positions roll forward by exactly the emitted count
        (capped at max_ctx - 1), so a rejected tail is rolled back for
        every slot independently. Returns emitted [T, S] int32 with SKIP
        past each slot's window; a non-finite effective logits row emits
        NAN_TOKEN and ends that slot's window."""
        st = self.state
        S, T = logits.shape[0], logits.shape[1]
        G = T - 1
        still = st.active.clone()
        n_emit = torch.zeros(S, dtype=torch.int32, device=self.device)
        final_tok = st.tokens.clone()
        emitted = torch.empty((T, S), dtype=torch.int32, device=self.device)
        sampled = [s for s in self._active_slots if not self._greedy[s]]
        emitting = set(sampled)
        for t in range(T):
            if sampled and t:
                # which sampled slots still emit: a host read, paid only
                # while a sampled (non-greedy) slot is live
                live = still.tolist()
                emitting = {s for s in emitting if live[s]}
            logits_t = logits[:, t]
            tok = smp.sample(logits_t, st.params, st.counts,
                             self._sample_generators(emitting), st.bias)
            row_ok = torch.isfinite(logits_t.float() + st.bias).all(dim=-1)
            tok = torch.where(row_ok, tok, torch.full_like(tok, NAN_TOKEN))
            # clamp the sentinel out of the scatter index
            smp.update_counts(st.counts, tok.clamp(min=0), still)
            final_tok = torch.where(still, tok, final_tok)
            n_emit += still.to(torch.int32)
            emitted[t] = torch.where(still, tok, torch.full_like(tok, SKIP))
            if t < G:
                still = still & (tok == proposals[:, t])
        st.positions.copy_((st.positions + n_emit).clamp(max=self.max_ctx - 1))
        st.tokens.copy_(final_tok)
        return emitted

    @torch.no_grad()
    def _verify_window(self, proposals: torch.Tensor, write,
                       ctx: int) -> torch.Tensor:
        """A T = gamma+1 wide batched forward (decode generalized to T
        tokens: each slot's next token, then its proposals, at its
        frontier and on) through the KV write policy ``write`` and a
        causal mask over ``ctx`` rows, then the accept scan. proposals
        [S, gamma] int32; returns emitted [T, S]."""
        cfg, st = self.cfg, self.state
        T = proposals.shape[1] + 1
        p0 = st.positions
        positions = p0[:, None] + torch.arange(
            T, dtype=torch.int32, device=self.device)[None, :]
        tokens = torch.cat([st.tokens[:, None], proposals], dim=1)
        mask = kvc.verify_mask(cfg, p0, T, ctx)
        hidden, _ = self._forward(tokens, positions, write,
                                  self.kv.stacked(), mask)
        logits = self._logits(hidden)
        self.verify_windows += 1
        return self._accept_scan(logits, proposals)

    def _verify_fn(self, proposals: torch.Tensor) -> torch.Tensor:
        """One speculative verify dispatch over the contiguous cache: the
        window is written at each slot's frontier and attends over the
        slot's row."""
        return self._verify_window(
            proposals, kvc.verify_write(self.state.positions), self.max_ctx)

    def _verify_paged_fn(self, proposals: torch.Tensor) -> torch.Tensor:
        """Paged twin of _verify_fn: window rows scatter through the block
        tables into each slot's reserved speculation rows and attend over
        the gathered prefix + window; the accept scan rolls every slot's
        frontier back independently (a position rollback, never a table
        change, so co-batched slots are untouched)."""
        return self._verify_window(
            proposals, kvc.paged_verify_write(
                self.block_tables, self.state.positions, self.max_ctx),
            self.ctx_pad)

    def _se_attn(self, qpos: torch.Tensor, kpos: torch.Tensor):
        """The self-extend attend over the real RoPE table (ga_n > 1): the
        single construction point of the four attention sites."""
        return se.build_attend(self.cfg, self._se_rope, self.ga_n,
                               self.ga_w, qpos, kpos)

    def _prefill_attn(self, length: int, bucket: int):
        """Attention override for a fresh ``bucket``-row chunk (contiguous
        prefill, embeddings): ``ops.prefill_attention`` over the
        head-major chunk, masked to the real ``length``; under self-extend
        its attend under the same causal mask."""
        if self.ga_n > 1:
            pos = torch.arange(bucket, device=self.device)
            attend = self._se_attn(pos[None], pos)
            mask = kvc.prefill_mask(self.cfg, bucket, length, self.device)
            return lambda q, keys, values, _mask: attend(q, keys, values,
                                                         mask)
        window = self.cfg.sliding_window

        def attn(q, keys, values, _mask):  # q [1,T,Hq,hd], keys [1,Hkv,T,hd]
            return ops.prefill_attention(
                q[0].contiguous(), keys[0].contiguous(),
                values[0].contiguous(), length,
                sliding_window=window)[None]

        return attn

    def _prefill_tail(self, hidden: torch.Tensor, length: int, slot: int,
                      prompt: list[int], position: int) -> torch.Tensor:
        """Sample the first token from the last real row and arm the slot:
        counts from the whole prompt, next write position ``position``."""
        return self._arm_slot(hidden[0, length - 1][None], slot, prompt,
                              position)

    def _arm_slot(self, last_h: torch.Tensor, slot: int, prompt: list[int],
                  position: int) -> torch.Tensor:
        """:meth:`_prefill_tail` from the last real row ``last_h`` [1, D]."""
        cfg, st = self.cfg, self.state
        logits = self._logits(last_h)  # [1, V]
        ids = [t for t in prompt if 0 <= t < cfg.vocab_size]
        smp.count_prompt_tokens(
            st.counts, slot,
            torch.tensor(ids, dtype=torch.int64, device=self.device),
            len(ids))
        rows = slice(slot, slot + 1)
        gen = None if self._greedy[slot] else self._gens[slot]
        tok = smp.sample(logits, st.params.rows(rows), st.counts[rows],
                         [gen], st.bias[rows])
        st.tokens[slot] = tok[0]
        st.positions[slot] = position
        st.active[slot] = True
        return tok[0]

    @torch.no_grad()
    def _prefill_fn(self, tokens: torch.Tensor, length: int, slot: int,
                    prompt: list[int],
                    embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fresh contiguous prefill: the bucketed prompt [1, T] (or its
        ``embeds`` [1, T, D]) is written into the slot's cache rows
        [0, T) and attends over itself through the prefill kernel;
        samples the first token."""
        bucket = tokens.shape[1]
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device)[None, :]
        hidden, _ = self._forward(tokens, positions, kvc.prefill_write(slot),
                                  self.kv.stacked(), None,
                                  attn=self._prefill_attn(length, bucket),
                                  embeds=embeds)
        self.fresh_prefills += 1
        return self._prefill_tail(hidden, length, slot, prompt, length)

    def _mm_embeds(self, tokens: torch.Tensor, mm_embeds: np.ndarray,
                   mm_positions: np.ndarray) -> torch.Tensor:
        """Token embeddings [1, T, D] with the image-embedding rows
        scattered over their placeholder positions (< the prompt length).
        Ids past the vocabulary gather its last row, as the JAX package's
        clamped gather does (their rows are replaced anyway)."""
        dtype = mdl.torch_dtype(self.cfg.dtype)
        ids = tokens.clamp(0, self.cfg.vocab_size - 1)
        x = self._embed(ids)
        if x is None:
            x = quant.embed_rows(self.params["embed"], ids, dtype)
        pos = torch.from_numpy(np.asarray(mm_positions, np.int64)).to(
            self.device)
        rows = torch.from_numpy(np.asarray(mm_embeds, np.float32)).to(
            self.device)
        x[0, pos] = rows.to(dtype)
        return x

    @torch.no_grad()
    def _prefill_mm_fn(self, tokens: torch.Tensor, length: int, slot: int,
                       prompt: list[int], mm_embeds: np.ndarray,
                       mm_positions: np.ndarray) -> torch.Tensor:
        """Multimodal contiguous prefill: the token embeddings with the
        image rows scattered in, through the fresh prefill (K3) in one
        dispatch."""
        return self._prefill_fn(
            tokens, length, slot, prompt,
            embeds=self._mm_embeds(tokens, mm_embeds, mm_positions))

    @torch.no_grad()
    def _prefill_resume_fn(self, tokens: torch.Tensor, length: int,
                           offset: int, slot: int,
                           prompt: list[int]) -> torch.Tensor:
        """Suffix prefill: the slot keeps ``offset`` rows of reused prefix;
        only the tail chunk is computed, attending over prefix + chunk
        with plain grouped attention (the prefill kernel models a fresh
        chunk only, as in the JAX package)."""
        cfg = self.cfg
        bucket = tokens.shape[1]
        positions = offset + torch.arange(bucket, dtype=torch.int32,
                                          device=self.device)[None, :]
        mask = kvc.resume_mask(cfg, bucket, offset, self.max_ctx,
                               device=self.device)
        attn = (self._se_attn(positions, torch.arange(
            self.max_ctx, device=self.device)) if self.ga_n > 1 else None)
        hidden, _ = self._forward(tokens, positions,
                                  kvc.resume_write(slot, offset),
                                  self.kv.stacked(), mask, attn=attn)
        return self._prefill_tail(hidden, length, slot, prompt,
                                  offset + length)

    @torch.no_grad()
    def _prefill_paged_fn(self, tokens: torch.Tensor, length: int,
                          offset: int, table_row: torch.Tensor, slot: int,
                          prompt: Optional[list[int]],
                          embeds: Optional[torch.Tensor] = None,
                          ) -> Optional[torch.Tensor]:
        """One chunked-prefill dispatch: write ``length`` real tokens of
        the chunk at positions [offset, offset+length) through the slot's
        table row, attending resume-style over the gathered prefix +
        chunk. The final chunk (``prompt`` given) samples the first token
        and arms the slot; earlier chunks leave the decode state alone."""
        cfg = self.cfg
        bucket = tokens.shape[1]
        positions = offset + torch.arange(bucket, dtype=torch.int32,
                                          device=self.device)[None, :]
        mask = kvc.resume_mask(cfg, bucket, offset, self.ctx_pad,
                               device=self.device)
        write = kvc.paged_prefill_write(table_row, offset, length)
        hidden, _ = self._forward(tokens, positions, write,
                                  self.kv.stacked(), mask, embeds=embeds)
        self.prefill_chunks += 1
        if prompt is None:
            return None
        return self._prefill_tail(hidden, length, slot, prompt,
                                  offset + length)

    @torch.no_grad()
    def _prefill_paged_mm_fn(self, tokens: torch.Tensor, length: int,
                             table_row: torch.Tensor, slot: int,
                             prompt: list[int], mm_embeds: np.ndarray,
                             mm_positions: np.ndarray) -> torch.Tensor:
        """Multimodal paged prefill: one dispatch, never chunked (the
        scattered image rows ride one program, as in ``_prefill_mm_fn``),
        offset 0, always samples."""
        return self._prefill_paged_fn(
            tokens, length, 0, table_row, slot, prompt,
            embeds=self._mm_embeds(tokens, mm_embeds, mm_positions))

    def _sp_trunk(self, tokens: torch.Tensor, length: int,
                  every_row: bool = False):
        """The ring prefill of a bucketed prompt [1, T] (``parallel.
        ring``): this rank's chunk through the trunk, then every chunk's
        K/V all-gathered over the ``seq`` group and the last real row
        broadcast from the rank that holds it, so every ``seq`` rank
        writes the whole prompt and samples alike. Returns (the last real
        row [1, D], (k, v) each [L, T, Hkv, hd]); ``every_row``: (every
        row [T, D], gathered, and no K/V)."""
        from localai_tpu_torch.parallel import overlap as ovl
        from localai_tpu_torch.parallel import ring

        mesh = self.mesh
        hidden, (ks, vs) = ring.sp_prefill_forward(
            self.cfg, self.params, tokens[0], length, mesh, self.rope,
            self.reduce, hops=self.transfers["ring_hop"])
        n, group = mesh.axis_size("seq"), mesh.groups["seq"]
        L, Tc = ks.shape[0], ks.shape[1]

        def gather(t):   # [L, Tc, ...] of each rank -> [L, n*Tc, ...]
            out = torch.empty((n * t.shape[0], *t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            ovl.all_gather_rows(out, t.contiguous(), group)
            return out.view(n, *t.shape).transpose(0, 1).reshape(
                t.shape[0], n * Tc, *t.shape[2:])

        if every_row:
            return gather(hidden)[0], None
        owner = (length - 1) // Tc
        last = (hidden[0, length - 1 - owner * Tc].clone()
                if mesh.axis_rank("seq") == owner
                else torch.empty_like(hidden[0, 0]))
        ovl.broadcast(last, mesh.axis_ranks("seq")[owner], group)
        kv = torch.cat((ks, vs))   # K and V in one all-gather
        kv = self.transfers["kv_gather"].run(lambda: gather(kv), kv)
        return last[None], (kv[:L], kv[L:])

    @torch.no_grad()
    def _prefill_sp_fn(self, tokens: torch.Tensor, length: int, slot: int,
                       prompt: list[int]) -> torch.Tensor:
        """Sequence-parallel contiguous prefill: the ring prefill's K/V
        written into the slot's cache rows [0, T); samples the first
        token."""
        last, (ks, vs) = self._sp_trunk(tokens, length)
        self.sp_prefills += 1
        write = kvc.prefill_write(slot)
        for i, layer_kv in enumerate(zip(*self.kv.stacked())):
            write(layer_kv, ks[i][None], vs[i][None])
        return self._arm_slot(last, slot, prompt, length)

    @torch.no_grad()
    def _prefill_paged_sp_fn(self, tokens: torch.Tensor, length: int,
                             table_row: torch.Tensor, slot: int,
                             prompt: list[int]) -> torch.Tensor:
        """Sequence-parallel paged prefill: the ring prefill's K/V
        scattered through the slot's table row (padding rows to the trash
        block) in one dispatch, the admission's only; samples the first
        token and arms the slot."""
        last, (ks, vs) = self._sp_trunk(tokens, length)
        self.sp_prefills += 1
        for i, layer_kv in enumerate(zip(*self.kv.stacked())):
            kvc.paged_scatter(layer_kv, table_row, 0, length, ks[i][None],
                              vs[i][None])
        return self._arm_slot(last, slot, prompt, length)

    def _use_sp(self, n: int, bucket: int, lcp: int, mm: bool) -> bool:
        """Whether a prompt of ``n`` tokens in ``bucket`` takes the ring
        prefill: a fresh (no reused prefix), text-only prompt of at least
        ``sp_threshold`` tokens whose bucket the ``seq`` axis divides."""
        return (self.sp_enabled and not lcp and not mm
                and n >= self.sp_threshold
                and bucket % self.mesh.axis_size("seq") == 0)

    # -- host API --------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds max prefill bucket {self.buckets[-1]}")

    def acquire_slot(self, slot: Optional[int] = None) -> Optional[int]:
        """Claim a free slot — FIFO, or ``slot`` when it is free (the
        scheduler targets the slot with the longest reusable prefix) — or
        None when all are busy."""
        if not self._free_slots:
            return None
        if slot is not None and slot in self._free_slots:
            self._free_slots.remove(slot)
            return slot
        return self._free_slots.pop(0)

    def free_slots(self) -> list[int]:
        return list(self._free_slots)

    def admit(self, slot: int, prompt: list[int], *,
              resident: Optional[list[int]] = None,
              valid_n: Optional[int] = None,
              reserve_tokens: Optional[int] = None, spec_tokens: int = 0,
              mm_embeds: Optional[np.ndarray] = None,
              mm_positions: Optional[np.ndarray] = None,
              **sampling) -> int:
        """Prefill a prompt into a slot; returns the first sampled token.

        Paged: all chunks of a ``begin_admit`` (``reserve_tokens`` rows
        reserved, plus ``spec_tokens`` rows of speculation lookahead;
        ``resident`` reuses rows ``load_prefix`` just loaded).
        Contiguous: one dispatch (``spec_tokens`` is ignored); when
        ``resident`` (the slot's
        previous prompt + generation) shares a long-enough prefix with the
        prompt, the prefix KV is kept and only the tail is prefilled.
        ``valid_n`` is the slot's KV frontier from a batched
        ``slot_positions()`` read (None reads it here). ``mm_embeds``
        [n_mm, D] float32 rows replace the token embeddings at
        ``mm_positions`` [n_mm] (image placeholders): such a prompt is
        prefilled in one dispatch and never reuses a prefix."""
        if self.paged:
            adm = self.begin_admit(slot, prompt,
                                   reserve_tokens=reserve_tokens,
                                   spec_tokens=spec_tokens,
                                   resident=resident, valid_n=valid_n,
                                   mm_embeds=mm_embeds,
                                   mm_positions=mm_positions, **sampling)
            if adm is None:
                raise RuntimeError(
                    f"KV block pool exhausted: cannot reserve {len(prompt)} "
                    "prompt tokens (direct admit has no queue)")
            while True:
                tok = adm.step_chunk()
                if tok is not None:
                    return tok
        if not prompt:
            prompt = [0]
        n = len(prompt)
        if n > self.max_ctx - 1:
            raise ValueError(
                f"prompt ({n} tokens) exceeds context {self.max_ctx}")
        mm = mm_embeds is not None and len(mm_embeds) > 0
        lcp = (self.reusable_prefix(slot, resident, prompt, valid_n)
               if resident and mm_embeds is None else 0)
        self.last_prefix_reused = lcp
        self.total_prefix_reused += lcp
        tail = prompt[lcp:]
        bucket = (self._resume_bucket(len(tail), lcp) if lcp
                  else self.bucket_for(n))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(tail)] = tail
        tokens = torch.from_numpy(padded).to(self.device)
        self._prepare_slot(slot, **sampling)
        if self._use_sp(n, bucket, lcp, mm):
            self.last_prefill_path = "sp"
            tok = self._prefill_sp_prog(tokens, n, slot, prompt)
        elif lcp:
            self.last_prefill_path = "resume"
            tok = self._prefill_resume_prog(tokens, len(tail), lcp, slot,
                                            prompt)
        elif mm:
            self.last_prefill_path = "mm"
            tok = self._prefill_mm_prog(tokens, n, slot, prompt, mm_embeds,
                                        mm_positions)
        else:
            self.last_prefill_path = "full"
            tok = self._prefill_prog(tokens, n, slot, prompt)
        self._active_slots.add(slot)
        with self.watchdog.guard("device"):
            return int(tok)  # the prefill/decode handoff sync

    def _prepare_slot(self, slot: int, *, temperature=None, top_k=None,
                      top_p=None, min_p=None, repeat_penalty=None,
                      presence_penalty=None, frequency_penalty=None,
                      seed=None, bias_row=None) -> None:
        """Per-slot sampling params + generator seed + logit-bias row."""
        self.state.params.set_slot(
            slot, temperature=temperature, top_k=top_k, top_p=top_p,
            min_p=min_p, repeat_penalty=repeat_penalty,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty)
        self._greedy[slot] = temperature is not None and temperature <= 0.0
        if seed is not None:
            self._gens[slot].manual_seed(int(seed))
        self.set_bias(slot, bias_row)

    def begin_admit(self, slot: int, prompt: list[int], *,
                    reserve_tokens: Optional[int] = None,
                    spec_tokens: int = 0,
                    resident: Optional[list[int]] = None,
                    valid_n: Optional[int] = None,
                    mm_embeds: Optional[np.ndarray] = None,
                    mm_positions: Optional[np.ndarray] = None,
                    **sampling) -> Optional["PagedAdmission"]:
        """Start a chunked paged admission: reserve blocks (sharing pooled
        prefix blocks where the prompt allows), arm the slot's sampling
        state, and return a PagedAdmission whose ``step_chunk()`` the
        caller drives. ``spec_tokens`` reserves speculation rows past the
        decode worst case (a verify window writes up to gamma rows beyond
        the frontier), recorded apart by the allocator. A slot holding
        rows ``load_prefix`` just loaded for ``resident`` keeps them and
        grows its table (the first chunk starts past them); otherwise
        they are released. A multimodal prompt (``mm_embeds``) shares no
        pooled prefix: its rows depend on the image, not on the token ids.
        Returns None when the pool cannot cover the reservation (the
        scheduler keeps the request queued)."""
        if not self.paged:
            raise RuntimeError("begin_admit needs the paged KV layout")
        if not prompt:
            prompt = [0]
        n = len(prompt)
        if n > self.max_ctx - 1:
            raise ValueError(
                f"prompt ({n} tokens) exceeds context {self.max_ctx}")
        reserve = min(self.max_ctx, max(n + 1, reserve_tokens
                                        or self.max_ctx))
        # the lookahead never needs rows past max_ctx (the verify write
        # sends those to the trash block)
        spec_tokens = max(0, min(int(spec_tokens), self.max_ctx - reserve))
        need = self.allocator.blocks_for(reserve + spec_tokens)
        if need > self.allocator.num_blocks - 1:
            # can never fit, even in an empty pool: holding it would block
            # admission forever
            raise ValueError(
                f"reservation of {reserve + spec_tokens} tokens ({need} "
                f"blocks) exceeds the block pool "
                f"({self.allocator.num_blocks - 1} blocks)")
        mm = mm_embeds is not None and len(mm_embeds) > 0
        lcp = 0
        if resident and not mm and self._loaded_rows.get(slot):
            # rows just loaded from the disk prompt cache: the only
            # slot-resident reuse of the paged layout (pool sharing covers
            # the rest)
            lcp = self.reusable_prefix(slot, resident, prompt, valid_n)
        if lcp:
            if not self.allocator.extend(slot, reserve,
                                         spec_tokens=spec_tokens):
                self.allocator.release(slot)
                self._loaded_rows.pop(slot, None)
                return None
            self.last_prefill_path = "paged_resume"
        else:
            if slot in self.allocator.tables:  # stale loaded rows
                self.allocator.release(slot)
            self._loaded_rows.pop(slot, None)
            lcp = self.allocator.allocate(slot, reserve,
                                          prompt=None if mm else prompt,
                                          spec_tokens=spec_tokens)
            if lcp is None:
                return None
            self.last_prefill_path = ("paged_mm" if mm else
                                      "paged_shared" if lcp else "paged")
        self.last_prefix_reused = lcp
        self.total_prefix_reused += lcp
        # a long fresh prompt on a 'seq' mesh: the ring prefill, one
        # dispatch writing straight into the reserved blocks (shared or
        # loaded prefix rows keep the chunked path)
        sp = self._use_sp(n, self.bucket_for(n), lcp, mm)
        if sp:
            self.last_prefill_path = "paged_sp"
        self._prepare_slot(slot, **sampling)
        return PagedAdmission(self, slot, list(prompt), lcp,
                              mm_embeds=mm_embeds if mm else None,
                              mm_positions=mm_positions, sp=sp)

    def _finish_paged_admit(self, slot: int, prompt: list[int],
                            mm: bool = False) -> None:
        """Final-chunk bookkeeping: expose the block table to the decode
        step, publish the prompt's full blocks to the prefix pool (their
        contents are dispatched by now; token-keyed sharing means nothing
        for a multimodal prompt), mark the slot live."""
        self.block_tables[slot] = torch.from_numpy(
            self.allocator.table_row(slot)).to(self.device)
        if not mm:
            self.allocator.register_prefix(slot, prompt)
        self._loaded_rows.pop(slot, None)
        self._active_slots.add(slot)

    def reusable_prefix(self, slot: int, resident: Optional[list[int]],
                        prompt: list[int],
                        valid_n: Optional[int] = None) -> int:
        """Tokens of ``resident`` (the slot's previous prompt + generation,
        or a disk prompt-cache hit's tokens) that an admission would reuse
        for ``prompt``, every feasibility gate applied: KV validity
        (``valid_n`` rows, default the slot's position on a contiguous
        runner — the last sampled token's KV is never written — and the
        rows ``load_prefix`` loaded on a paged one, whose other rows are
        freed at release), last-token recompute, the minimum worthwhile
        length, and on a contiguous runner the tail bucket fitting inside
        the context (a paged chunk's overshoot goes to the trash block).
        The scheduler ranks free slots and disk hits with this same
        function."""
        if not resident or not prompt:
            return 0
        if valid_n is None:
            valid_n = (self._loaded_rows.get(slot, 0) if self.paged
                       else self.slot_position(slot))
        lcp = 0
        for a, b in zip(resident[:valid_n], prompt):
            if a != b:
                break
            lcp += 1
        # always recompute at least the last token (its logits seed sampling)
        lcp = min(lcp, len(prompt) - 1)
        if lcp < self.prefix_reuse_min:
            return 0
        if self.paged:
            return lcp
        if self._resume_bucket(len(prompt) - lcp, lcp) is None:
            return 0
        return lcp

    def resident_rows(self, slot: int, default: int) -> int:
        """KV rows of ``slot`` that prefix reuse may count on: on a
        contiguous runner the frontier the caller read (``default``); on a
        paged one only rows just loaded from the disk prompt cache."""
        if not self.paged:
            return default
        return min(default, self._loaded_rows.get(slot, 0))

    def _resume_bucket(self, tail_len: int, offset: int) -> Optional[int]:
        """Smallest prefill bucket holding the tail that also fits in the
        cache past the kept prefix."""
        for b in self.buckets:
            if tail_len <= b and offset + b <= self.max_ctx:
                return b
        return None

    def _read(self, t0: float, tokens: AsyncTokens) -> np.ndarray:
        """The synchronous entry points' blocking read, guarded, with
        their wall split for the anatomy (issue since ``t0``, then the
        read)."""
        t1 = time.perf_counter()
        with self.watchdog.guard("device"):
            out = np.asarray(tokens)
        self.last_launch_ms = (t1 - t0) * 1e3
        self.last_sync_ms = (time.perf_counter() - t1) * 1e3
        return out

    def step(self) -> np.ndarray:
        """One decode iteration over all slots; returns sampled tokens [S].
        Synchronous: the blocking read is the API (constrained slots need
        the token before the next dispatch)."""
        t0 = time.perf_counter()
        return self._read(t0, self.step_async())

    def step_async(self) -> AsyncTokens:
        """Like step() but returns without waiting for the device."""
        return AsyncTokens(self._decode_prog())

    def step_n(self, n: int) -> np.ndarray:
        """n decode iterations; returns tokens [n, S]."""
        t0 = time.perf_counter()
        return self._read(t0, self.step_n_async(n))

    def step_n_async(self, n: int) -> AsyncTokens:
        """n decode iterations (a Python loop of single steps); the [n, S]
        result comes back asynchronously."""
        return AsyncTokens(self._decode_n_prog(n=n))

    def step_frozen_n(self, freeze: np.ndarray, n: int) -> np.ndarray:
        """n decode iterations where ``freeze``-masked slots ([S] bool)
        advance only on the first; returns tokens [n, S] (rows 1+ stale
        for frozen slots). Synchronous by contract: the frozen slots'
        constraints need the sampled token on the host before the next
        dispatch. Both KV layouts."""
        t0 = time.perf_counter()
        freeze = np.asarray(freeze, bool)
        frozen = {int(s) for s in np.nonzero(freeze)[0]}
        mask = torch.from_numpy(freeze).to(self.device)
        return self._read(t0, AsyncTokens(
            self._decode_frozen_n_prog(mask, frozen, n=n)))

    def verify_async(self, proposals) -> AsyncTokens:
        """One speculative verify dispatch over all slots: score the
        [S, gamma] draft ``proposals`` (host array or device tensor) with
        a single gamma+1 wide forward, accept/sample, and return the
        [gamma+1, S] emitted rows (SKIP = nothing for that step and slot)
        asynchronously. Both KV layouts."""
        proposals = torch.as_tensor(proposals, dtype=torch.int32,
                                    device=self.device)
        return AsyncTokens(self._verify_prog(proposals))

    def set_bias(self, slot: int, bias_row: Optional[np.ndarray]) -> None:
        """Replace one slot's [V] additive logit-bias row (None clears)."""
        if bias_row is None:
            self.state.bias[slot] = 0.0
        else:
            self.state.bias[slot] = torch.from_numpy(
                np.asarray(bias_row, np.float32)).to(self.device)

    def embed(self, prompt: list[int]) -> np.ndarray:
        """[D] float32 embedding of a token sequence: the final hidden
        state mean-pooled in f32 over the real rows, bucketed like prefill.
        It reads only the weights and the RoPE table — no KV cache, no
        decode state — so it runs on the caller's thread while the engine
        thread decodes."""
        if not prompt:
            prompt = [0]
        n = len(prompt)
        if n > self.max_ctx:
            raise ValueError(f"input ({n} tokens) exceeds context "
                             f"{self.max_ctx}")
        bucket = self.bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prompt
        return self._embed_prog(torch.from_numpy(padded), n)

    def prompt_logits(self, prompt: list[int]) -> np.ndarray:
        """Logits [n, V] float32 of every row of a fresh forward over
        ``prompt`` (the prefill a fresh admission runs, with no cache
        written and no slot touched: the ring prefill where one would take
        it): a meshed engine's check against one device."""
        n = len(prompt)
        bucket = self.bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prompt
        with torch.no_grad():
            tokens = torch.from_numpy(padded).to(self.device)
            if self._use_sp(n, bucket, 0, False):
                # the ring prefill, as a fresh admission of it runs
                rows, _ = self._sp_trunk(tokens, n, every_row=True)
                return self._logits(rows[:n]).float().cpu().numpy()
            positions = torch.arange(bucket, dtype=torch.int32,
                                     device=self.device)[None, :]
            hidden, _ = self._forward(tokens, positions, kvc.chunk_write,
                                      None, None,
                                      attn=self._prefill_attn(n, bucket))
            logits = self._logits(hidden[0, :n])
        return logits.float().cpu().numpy()

    def _embed_fn(self, padded: torch.Tensor, n: int) -> np.ndarray:
        """The embeddings forward of a bucketed [1, T] prompt with ``n``
        real rows (host tensor in, host vector out)."""
        bucket = padded.shape[1]
        with torch.no_grad():  # per thread: this is not the engine's thread
            tokens = padded.to(self.device)
            positions = torch.arange(bucket, dtype=torch.int32,
                                     device=self.device)[None, :]
            hidden, _ = self._forward(tokens, positions, kvc.chunk_write,
                                      None, None,
                                      attn=self._prefill_attn(n, bucket))
            # pool in f32: a bf16 sum over thousands of rows loses the
            # precision the embeddings exist to provide
            pooled = hidden[0, :n].float().sum(dim=0) / n
        return pooled.cpu().numpy()

    def release(self, slot: int) -> None:
        """Deactivate the slot. Paged: free its blocks (prompt blocks in
        the prefix pool stay as reclaimable cache) and point its device
        table row at the trash block, so the decode step's static-shape
        writes can't touch reallocated blocks. Contiguous: the slot keeps
        its KV rows and its position for prefix reuse (decode keeps writing
        at that frozen position, the row past the valid prefix)."""
        self.state.active[slot] = False
        if self.paged:
            self.allocator.release(slot)
            self._loaded_rows.pop(slot, None)
            self.block_tables[slot] = 0
            self.state.positions[slot] = 0
        self._active_slots.discard(slot)
        if slot not in self._free_slots:
            self._free_slots.append(slot)

    @property
    def any_active(self) -> bool:
        return bool(self._active_slots)

    def slot_positions(self) -> np.ndarray:
        """Every slot's KV frontier in ONE [S] transfer."""
        with self.watchdog.guard("device"):
            return self.state.positions.cpu().numpy()

    def slot_position(self, slot: int) -> int:
        return int(self.slot_positions()[slot])

    # -- the host spill tier (fleet.kveconomy.tiering) -------------------

    def _pool_tensors(self) -> dict:
        kv = self.kv
        out = {"k": kv.k, "v": kv.v}
        if kv.k_scale is not None:
            out["k_scale"], out["v_scale"] = kv.k_scale, kv.v_scale
        return out

    def pack_block(self, bid: int):
        """One pool block's raw rows in host memory: the spill payload of
        the allocator's host tier. Rows keep the pool dtype byte for byte
        (bf16 stays bf16, int4 nibble-packed, scales f32), so a spill and
        its reload are an identity. On the card each tensor's block goes
        to pinned memory by one asynchronous copy on the current stream,
        ordered before whatever later overwrites the block, and the
        payload carries the event recorded after the copies
        (``BlockPayload.wait`` before a host read); the engine thread does
        not wait."""
        from localai_tpu_torch.fleet.kveconomy.tiering import BlockPayload

        if not self.paged:
            return None
        out = BlockPayload()
        cuda = self.device.type == "cuda"
        for name, t in self._pool_tensors().items():
            src = t[:, bid]
            if cuda:
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True)
                host.copy_(src, non_blocking=True)
            else:
                host = src.clone()
            out[name] = host
        if cuda:
            out.event = torch.cuda.Event()
            out.event.record()
        return out

    def load_block(self, bid: int, payload: dict) -> None:
        """Write a spilled block's rows back into pool block ``bid`` in
        place (a tier reload; the inverse of :meth:`pack_block`), on the
        current stream, before the next dispatch reads the pool."""
        for name, t in self._pool_tensors().items():
            src = payload[name]
            if (tuple(src.shape) != tuple(t.shape[:1] + t.shape[2:])
                    or src.dtype != t.dtype):
                raise ValueError(f"spilled {name} rows ({src.dtype}, "
                                 f"{tuple(src.shape)}) do not fit the pool")
            t[:, bid].copy_(src, non_blocking=True)

    # -- prompt-cache persistence (engine.promptcache) -------------------

    def snapshot_prefix(self, slot: int, n: Optional[int] = None) -> dict:
        """A copy of one slot's first ``n`` KV rows (default: its
        position) on the device, taken on the engine's stream: the cache
        is updated in place by the next dispatch, so a view would change
        under a reader on another thread. On the card a CUDA event is
        recorded after the copies; :meth:`pack_prefix` waits for it alone.
        Rows are [L, H, n, hd] (int4: hd/2, nibble-packed), scales
        [L, H, n], whatever the layout: paged and contiguous runners
        share one export format."""
        p = n if n is not None else self.slot_position(slot)
        out: dict = {"kv_dtype": str(self.kv_dtype),
                     # a self-extend cache stores UNroped K: a roped-cache
                     # runner must never load these rows, nor the reverse
                     "kv_rope": "raw" if self.ga_n > 1 else "roped"}
        kv = self.kv
        if self.paged:
            bt = self.block_tokens
            table = self.allocator.tables.get(slot, [])
            nb = min(max(1, -(-p // bt)), len(table))
            p = min(p, nb * bt)
            blocks = torch.tensor(table[:nb] or [0], dtype=torch.long,
                                  device=self.device)

            def rows(t):  # [L, N, H, bt, ...] -> [L, H, p, ...]
                g = t[:, blocks].transpose(1, 2)
                return g.reshape(*g.shape[:2], -1,
                                 *g.shape[4:])[:, :, :p].contiguous()
        else:
            def rows(t):  # [L, S, H, C, ...] -> [L, H, p, ...]
                return t[:, slot, :, :p].clone()

        out["k"], out["v"] = rows(kv.k), rows(kv.v)
        if kv.k_scale is not None:
            out["k_scale"] = rows(kv.k_scale)
            out["v_scale"] = rows(kv.v_scale)
        if self.device.type == "cuda":
            out["event"] = torch.cuda.Event()
            out["event"].record()
        return out

    @staticmethod
    def pack_prefix(snapshot: dict) -> dict:
        """A :meth:`snapshot_prefix` as npz-ready numpy, in the JAX
        package's format: bfloat16 rows as their uint16 bits beside a
        ``<name>_bf16`` marker, scaled caches with their scales. On the
        card the host copy runs on a stream of its own after the
        snapshot's event, so it waits for the snapshot and not for what
        the engine dispatched since."""
        out: dict = {"kv_dtype": np.asarray(snapshot["kv_dtype"]),
                     "kv_rope": np.asarray(snapshot.get("kv_rope", "roped"))}
        names = [n for n in ("k", "v", "k_scale", "v_scale") if n in snapshot]
        event = snapshot.get("event")
        if event is not None:
            stream = torch.cuda.Stream(snapshot["k"].device)
            stream.wait_event(event)
            with torch.cuda.stream(stream):
                host = {n: snapshot[n].cpu() for n in names}
        else:
            host = {n: snapshot[n] for n in names}
        for name, t in host.items():
            if t.dtype == torch.bfloat16:
                out[name] = t.view(torch.int16).numpy().view(np.uint16)
                out[f"{name}_bf16"] = np.asarray(1)
            else:
                out[name] = t.numpy()
        return out

    def export_prefix(self, slot: int, n: Optional[int] = None) -> dict:
        """:meth:`snapshot_prefix` + :meth:`pack_prefix` in one call."""
        return self.pack_prefix(self.snapshot_prefix(slot, n))

    def load_prefix(self, slot: int, arrays: dict, n: int) -> bool:
        """Write exported KV rows ``arrays`` (the :meth:`pack_prefix`
        format) into ``slot`` and set its frontier to ``n``: the next
        admission of a prompt sharing them resumes past them. False on
        any mismatch (KV dtype, RoPE flavour, shape, context, a missing
        scale), and the caller prefills in full."""
        if str(arrays.get("kv_dtype")) != str(self.kv_dtype):
            return False
        want_rope = "raw" if self.ga_n > 1 else "roped"
        if str(arrays.get("kv_rope", "roped")) != want_rope:
            return False
        if n > self.max_ctx - 1:
            return False
        L, H, hd = (self.local_cfg.num_layers, self.local_cfg.num_kv_heads,
                    self.cfg.hd)
        if str(self.kv_dtype) == "int4":
            hd //= 2  # int4 exports stay nibble-packed along head_dim
        names = ("k", "v", "k_scale", "v_scale") if self.kv.k_scale is not \
            None else ("k", "v")
        if any(name not in arrays for name in names):
            return False
        new = {}
        for name in names:
            a = np.asarray(arrays[name])
            want = (L, H, n, hd) if name in ("k", "v") else (L, H, n)
            if a.shape != want:
                return False
            if f"{name}_bf16" in arrays:
                t = torch.from_numpy(np.ascontiguousarray(a).view(
                    np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(a))
            new[name] = t.to(self.device)
        kv = self.kv
        cache = {"k": kv.k, "v": kv.v, "k_scale": kv.k_scale,
                 "v_scale": kv.v_scale}
        if self.paged:
            if slot in self.allocator.tables:
                self.allocator.release(slot)
            self._loaded_rows.pop(slot, None)
            if self.allocator.allocate(slot, n) is None:
                return False
            bt = self.block_tokens
            pos = torch.arange(n, device=self.device)
            table = torch.tensor(self.allocator.tables[slot],
                                 dtype=torch.long, device=self.device)
            blk, off = table[pos // bt], pos % bt
            for name, t in new.items():
                # advanced indices (blk, off) around the head slice put the
                # row axis first: [n, L, H, ...]
                cache[name][:, blk, :, off] = t.movedim(2, 0).to(
                    cache[name].dtype)
            self.block_tables[slot] = torch.from_numpy(
                self.allocator.table_row(slot)).to(self.device)
            self._loaded_rows[slot] = n
        else:
            for name, t in new.items():
                cache[name][:, slot, :, :n] = t.to(cache[name].dtype)
        self.state.positions[slot] = n
        self.state.active[slot] = False
        self._active_slots.discard(slot)
        return True


class PagedAdmission:
    """One in-flight chunked paged admission (ModelRunner.begin_admit).

    The scheduler drives ``step_chunk()`` from its engine loop,
    interleaving chunk dispatches with decode dispatches. Only the FINAL
    chunk samples — it installs the slot's device block-table row,
    publishes prompt blocks to the prefix pool, arms the slot, and returns
    the first token."""

    def __init__(self, runner: ModelRunner, slot: int, prompt: list[int],
                 start: int, mm_embeds: Optional[np.ndarray] = None,
                 mm_positions: Optional[np.ndarray] = None,
                 sp: bool = False):
        self.runner = runner
        self.slot = slot
        self.prompt = prompt
        self.pos = start                     # next position to prefill
        self.mm_embeds = mm_embeds           # multimodal: one dispatch
        self.mm_positions = mm_positions
        self.sp = sp                         # the ring prefill: one dispatch
        self.done = False
        self.prefix_reused = start           # shared/loaded rows (telemetry)
        self.path = runner.last_prefill_path
        # dispatch-anatomy scratch of the last step_chunk(): the issue span
        # vs the final chunk's first-token read (obs.anatomy)
        self.last_launch_ms = 0.0
        self.last_sync_ms = 0.0

    @property
    def chunks_remaining(self) -> int:
        if self.done:
            return 0
        if self.mm_embeds is not None or self.sp:
            return 1
        return max(1, -(-(len(self.prompt) - self.pos)
                        // self.runner.prefill_chunk))

    def step_chunk(self) -> Optional[int]:
        """Dispatch the next prefill chunk; returns the first sampled
        token once the admission is complete, else None."""
        assert not self.done
        r = self.runner
        n = len(self.prompt)
        t0 = time.perf_counter()
        table_row = torch.from_numpy(r.allocator.table_row(self.slot)).to(
            r.device)
        if self.sp:
            padded = np.zeros((1, r.bucket_for(n)), np.int32)
            padded[0, :n] = self.prompt
            tok = r._prefill_paged_sp_prog(
                torch.from_numpy(padded).to(r.device), n, table_row,
                self.slot, self.prompt)
            take, last = n - self.pos, True
        elif self.mm_embeds is not None:
            padded = np.zeros((1, r.bucket_for(n)), np.int32)
            padded[0, :n] = self.prompt
            tok = r._prefill_paged_mm_prog(
                torch.from_numpy(padded).to(r.device), n, table_row,
                self.slot, self.prompt, self.mm_embeds, self.mm_positions)
            take, last = n, True
        else:
            rem = n - self.pos
            take = min(rem, r.prefill_chunk)
            last = take == rem
            padded = np.zeros((1, r.bucket_for(take)), np.int32)
            padded[0, :take] = self.prompt[self.pos:self.pos + take]
            tok = r._prefill_paged_prog(
                torch.from_numpy(padded).to(r.device), take, self.pos,
                table_row, self.slot, self.prompt if last else None)
        self.pos += take
        if not last:
            # issue only: no read on an intermediate chunk
            self.last_launch_ms = (time.perf_counter() - t0) * 1e3
            self.last_sync_ms = 0.0
            return None
        self.done = True
        r._finish_paged_admit(self.slot, self.prompt,
                              mm=self.mm_embeds is not None)
        t1 = time.perf_counter()
        with r.watchdog.guard("device"):
            first = int(tok)  # the prefill/decode handoff sync
        self.last_launch_ms = (t1 - t0) * 1e3
        self.last_sync_ms = (time.perf_counter() - t1) * 1e3
        return first

    def abort(self) -> None:
        """Abandon a part-way admission: frees the blocks and leaves the
        slot inactive."""
        self.done = True
        self.runner.release(self.slot)
