"""ModelRunner: the paged prefill/decode executor for one loaded LLM.

Port of the paged subset of ``localai_tpu/engine/runner.py`` for one
device (no mesh). PyTorch runs eagerly, so the jitted programs of the JAX
package become plain methods:

  * ONE decode step serves all slots every iteration (continuous batching
    is slot masking over static [S] shapes); ``step_n`` runs n steps as a
    Python loop where the JAX package scans them in one program.
  * KV pool, decode state and block tables are updated in place where the
    JAX package donates buffers to get the same effect.
  * Decode attention always goes through ``ops.paged_decode_attention``:
    the CUDA paged kernel on the card, its plain PyTorch version for CPU
    tensors.
  * Chunked prefill gathers the slot's table row and runs plain grouped
    attention over it, as the JAX package does in XLA.
  * Results come back asynchronously: a non-blocking copy into pinned host
    memory followed by a CUDA event (:class:`AsyncTokens`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

import numpy as np
import torch

from localai_tpu_torch import ops
from localai_tpu_torch.engine import kvcache as kvc
from localai_tpu_torch.engine import paged as pgd
from localai_tpu_torch.engine import sampling as smp
from localai_tpu_torch.models import llama as mdl
from localai_tpu_torch.models.llama import LlamaConfig
from localai_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# sampled-row sentinel for the per-row NaN/inf logits guard: a slot whose
# (biased) logits row went non-finite reports this instead of a token id;
# the scheduler fails that request only
NAN_TOKEN = -2


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

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a.astype(dtype) if dtype is not None else a


class ModelRunner:
    """Owns params + paged KV pool + decode state for one model; exposes
    admit/step/release to the scheduler."""

    paged = True

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
        kv_block_tokens: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        device: str | torch.device | None = "cuda",
    ):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.max_ctx = max_ctx or cfg.max_position_embeddings
        buckets = sorted(prefill_buckets or [128, 512, 2048, 8192])
        self.buckets = [b for b in buckets if b < self.max_ctx]
        self.buckets.append(self.max_ctx)  # any admissible prompt has a bucket
        self.rope = mdl.rope_table(cfg, self.max_ctx, freq_base=rope_freq_base,
                                   freq_scale=rope_freq_scale,
                                   device=self.device)
        self.block_tokens = max(8, int(kv_block_tokens
                                       or pgd.block_tokens_default()))
        self.max_blocks = -(-self.max_ctx // self.block_tokens)
        self.ctx_pad = self.max_blocks * self.block_tokens
        # the pool is the contiguous layout's footprint (every slot can
        # still reach max_ctx) plus the trash block
        self.num_blocks = num_slots * self.max_blocks + 1
        self.prefill_chunk = max(self.block_tokens, int(prefill_chunk or 512))
        self.kv_dtype = kv_dtype
        self.paged_attn_impl, why = ops.select_paged_attn_impl(
            device=self.device, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
            block_tokens=self.block_tokens,
            kv_dtype=mdl.torch_dtype(kv_dtype))
        if self.paged_attn_impl == "kernel" and kv_dtype != cfg.dtype:
            raise ValueError(
                f"the paged decode kernel needs the KV pool in the compute "
                f"dtype ({cfg.dtype}), got kv_dtype={kv_dtype}")
        if why:
            log.info("paged attention: %s (%s)", self.paged_attn_impl, why)
        self._seed = seed
        self.last_prefill_path = ""
        self.last_prefix_reused = 0
        # decode steps issued (each launches the attention once per layer)
        self.decode_steps = 0
        self._init_device_state()

    def _init_device_state(self) -> None:
        cfg, dev = self.cfg, self.device
        self.allocator = pgd.BlockAllocator(
            self.num_blocks, self.block_tokens, self.max_blocks)
        self.block_tables = torch.zeros((self.num_slots, self.max_blocks),
                                        dtype=torch.int32, device=dev)
        self.kv = kvc.init_paged_cache(cfg, self.num_blocks,
                                       self.block_tokens, self.kv_dtype,
                                       device=dev)
        self.state = DecodeState.init(self.num_slots, cfg.vocab_size, dev)
        # per-slot generators: a slot's stream advances only when it samples
        self._gens = [torch.Generator(device=dev).manual_seed(
            self._seed * 1_000_003 + s) for s in range(self.num_slots)]
        self._greedy = [False] * self.num_slots
        self._free_slots = list(range(self.num_slots))
        # host mirror of which slots are serving: admit/release are the only
        # transitions, so liveness queries never touch the device
        self._active_slots: set[int] = set()

    # -- device programs -------------------------------------------------

    def _sample_generators(self, slots) -> list[Optional[torch.Generator]]:
        return [self._gens[s] if (s in slots and not self._greedy[s])
                else None for s in range(self.num_slots)]

    @torch.no_grad()
    def _decode_paged_fn(self) -> torch.Tensor:
        """One batched single-token decode over the block pool; advances
        the state in place and returns the sampled tokens [S] int32."""
        cfg, st = self.cfg, self.state
        pos, tables = st.positions, self.block_tables

        def attn(q, keys, values, _mask):  # q [S,1,Hq,hd]; keys = pool
            out = ops.paged_decode_attention(
                q[:, 0].contiguous(), keys, values, tables, pos,
                sliding_window=cfg.sliding_window)
            return out[:, None]

        write = kvc.paged_decode_write(tables, pos)
        hidden, _ = mdl.forward(cfg, self.params, st.tokens[:, None],
                                pos[:, None], write, self.kv.stacked(), None,
                                self.rope, attn=attn)
        self.decode_steps += 1
        return self._decode_tail(hidden)

    def _decode_paged_n_fn(self, n: int) -> torch.Tensor:
        """n paged decode steps (a Python loop where the JAX package scans
        them in one program); returns tokens [n, S]. The block tables are
        loop-invariant: every admitted slot's table already covers its
        full reservation."""
        out = torch.empty((n, self.num_slots), dtype=torch.int32,
                          device=self.device)
        for i in range(n):
            out[i] = self._decode_paged_fn()
        return out

    def _decode_tail(self, hidden: torch.Tensor) -> torch.Tensor:
        """Sampling + per-slot state advance after a decode forward."""
        st = self.state
        pos = st.positions
        logits = mdl.logits_from_hidden(self.cfg, self.params, hidden[:, 0])
        tokens = smp.sample(logits, st.params, st.counts,
                            self._sample_generators(self._active_slots),
                            st.bias)
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

    @torch.no_grad()
    def _prefill_paged_fn(self, tokens: torch.Tensor, length: int,
                          offset: int, table_row: torch.Tensor, slot: int,
                          prompt: Optional[list[int]],
                          ) -> Optional[torch.Tensor]:
        """One chunked-prefill dispatch: write ``length`` real tokens of
        the chunk at positions [offset, offset+length) through the slot's
        table row, attending resume-style over the gathered prefix +
        chunk. The final chunk (``prompt`` given) samples the first token
        and arms the slot; earlier chunks leave the decode state alone."""
        cfg, st = self.cfg, self.state
        bucket = tokens.shape[1]
        positions = offset + torch.arange(bucket, dtype=torch.int32,
                                          device=self.device)[None, :]
        mask = kvc.resume_mask(cfg, bucket, offset, self.ctx_pad,
                               device=self.device)
        write = kvc.paged_prefill_write(table_row, offset, length)
        hidden, _ = mdl.forward(cfg, self.params, tokens, positions, write,
                                self.kv.stacked(), mask, self.rope)
        if prompt is None:
            return None
        last_h = hidden[0, length - 1][None]
        logits = mdl.logits_from_hidden(cfg, self.params, last_h)  # [1, V]
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
        st.positions[slot] = offset + length
        st.active[slot] = True
        return tok[0]

    # -- host API --------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds max prefill bucket {self.buckets[-1]}")

    def acquire_slot(self) -> Optional[int]:
        """Claim a free slot (FIFO), or None when all are busy."""
        if not self._free_slots:
            return None
        return self._free_slots.pop(0)

    def free_slots(self) -> list[int]:
        return list(self._free_slots)

    def admit(self, slot: int, prompt: list[int], **kw) -> int:
        """Prefill a prompt into a slot (all chunks); returns the first
        sampled token."""
        adm = self.begin_admit(slot, prompt, **kw)
        if adm is None:
            raise RuntimeError(
                f"KV block pool exhausted: cannot reserve {len(prompt)} "
                "prompt tokens (direct admit has no queue)")
        while True:
            tok = adm.step_chunk()
            if tok is not None:
                return tok

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
                    **sampling) -> Optional["PagedAdmission"]:
        """Start a chunked paged admission: reserve blocks (sharing pooled
        prefix blocks where the prompt allows), arm the slot's sampling
        state, and return a PagedAdmission whose ``step_chunk()`` the
        caller drives. Returns None when the pool cannot cover the
        reservation (the scheduler keeps the request queued)."""
        if not prompt:
            prompt = [0]
        n = len(prompt)
        if n > self.max_ctx - 1:
            raise ValueError(
                f"prompt ({n} tokens) exceeds context {self.max_ctx}")
        reserve = min(self.max_ctx, max(n + 1, reserve_tokens
                                        or self.max_ctx))
        if self.allocator.blocks_for(reserve) > self.allocator.num_blocks - 1:
            raise ValueError(
                f"reservation of {reserve} tokens "
                f"({self.allocator.blocks_for(reserve)} blocks) exceeds the "
                f"block pool ({self.allocator.num_blocks - 1} blocks)")
        shared = self.allocator.allocate(slot, reserve, prompt=prompt)
        if shared is None:
            return None
        self.last_prefill_path = "paged_shared" if shared else "paged"
        self.last_prefix_reused = shared
        self._prepare_slot(slot, **sampling)
        return PagedAdmission(self, slot, list(prompt), shared)

    def _finish_paged_admit(self, slot: int, prompt: list[int]) -> None:
        """Final-chunk bookkeeping: expose the block table to the decode
        step, publish the prompt's full blocks to the prefix pool (their
        contents are dispatched by now), mark the slot live."""
        self.block_tables[slot] = torch.from_numpy(
            self.allocator.table_row(slot)).to(self.device)
        self.allocator.register_prefix(slot, prompt)
        self._active_slots.add(slot)

    def step(self) -> np.ndarray:
        """One decode iteration over all slots; returns sampled tokens [S]."""
        return np.asarray(self.step_async())

    def step_async(self) -> AsyncTokens:
        """Like step() but returns without waiting for the device."""
        return AsyncTokens(self._decode_paged_fn())

    def step_n(self, n: int) -> np.ndarray:
        """n decode iterations; returns tokens [n, S]."""
        return np.asarray(self.step_n_async(n))

    def step_n_async(self, n: int) -> AsyncTokens:
        """n decode iterations (a Python loop of single steps); the [n, S]
        result comes back asynchronously."""
        return AsyncTokens(self._decode_paged_n_fn(n))

    def set_bias(self, slot: int, bias_row: Optional[np.ndarray]) -> None:
        """Replace one slot's [V] additive logit-bias row (None clears)."""
        if bias_row is None:
            self.state.bias[slot] = 0.0
        else:
            self.state.bias[slot] = torch.from_numpy(
                np.asarray(bias_row, np.float32)).to(self.device)

    def release(self, slot: int) -> None:
        """Free the slot's blocks (prompt blocks in the prefix pool stay as
        reclaimable cache) and point its device table row at the trash
        block, so the decode step's static-shape writes can't touch
        reallocated blocks."""
        self.state.active[slot] = False
        self.allocator.release(slot)
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
        return self.state.positions.cpu().numpy()


class PagedAdmission:
    """One in-flight chunked paged admission (ModelRunner.begin_admit).

    The scheduler drives ``step_chunk()`` from its engine loop,
    interleaving chunk dispatches with decode dispatches. Only the FINAL
    chunk samples — it installs the slot's device block-table row,
    publishes prompt blocks to the prefix pool, arms the slot, and returns
    the first token."""

    def __init__(self, runner: ModelRunner, slot: int, prompt: list[int],
                 start: int):
        self.runner = runner
        self.slot = slot
        self.prompt = prompt
        self.pos = start                     # next position to prefill
        self.done = False

    def step_chunk(self) -> Optional[int]:
        """Dispatch the next prefill chunk; returns the first sampled
        token once the admission is complete, else None."""
        assert not self.done
        r = self.runner
        rem = len(self.prompt) - self.pos
        take = min(rem, r.prefill_chunk)
        last = take == rem
        bucket = r.bucket_for(take)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :take] = self.prompt[self.pos:self.pos + take]
        table_row = torch.from_numpy(r.allocator.table_row(self.slot))
        tok = r._prefill_paged_fn(
            torch.from_numpy(padded).to(r.device), take, self.pos,
            table_row.to(r.device), self.slot,
            self.prompt if last else None)
        self.pos += take
        if not last:
            return None
        self.done = True
        r._finish_paged_admit(self.slot, self.prompt)
        return int(tok)  # the prefill/decode handoff sync

    def abort(self) -> None:
        """Abandon a part-way admission: frees the blocks and leaves the
        slot inactive."""
        self.done = True
        self.runner.release(self.slot)
