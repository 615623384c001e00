"""On-device batched sampling over all slots at once.

Port of ``localai_tpu/engine/sampling.py``: penalties, then one top-256
candidate pool per row, then top-k / top-p / min-p / temperature on the
[S, K] candidate matrix, with the additive bias row applied first.

  * **Greedy** rows take ``torch.argmax`` of the biased, penalized f32
    logits — the first maximal index, as index 0 of ``lax.top_k`` in the
    JAX package, so ties resolve the same way and greedy streams match it
    token for token.
  * **Seeded sampling** draws from one ``torch.Generator`` per slot, and
    only for active sampled rows, so a slot's stream does not depend on
    batch composition and a seed reproduces the port's own stream. It does
    NOT reproduce the JAX package's threefry bits: that divergence is
    intended; the two agree in distribution, not in draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from localai_tpu_torch.utils.device import resolve_device

MAX_TOPK = 256  # candidate cap; llama.cpp default top_k=40


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampling parameters, stored as [S] tensors on the device."""

    temperature: torch.Tensor       # f32; <=0 → greedy
    top_k: torch.Tensor             # i32; 0 → disabled (use MAX_TOPK pool)
    top_p: torch.Tensor             # f32; 1.0 → disabled
    min_p: torch.Tensor             # f32; 0.0 → disabled
    repeat_penalty: torch.Tensor    # f32; 1.0 → disabled
    presence_penalty: torch.Tensor  # f32
    frequency_penalty: torch.Tensor  # f32

    DEFAULTS = {
        "temperature": 1.0,
        "top_k": 40,
        "top_p": 1.0,
        "min_p": 0.0,
        "repeat_penalty": 1.0,
        "presence_penalty": 0.0,
        "frequency_penalty": 0.0,
    }

    @staticmethod
    def init(num_slots: int, device: str | torch.device = "cuda",
             ) -> "SamplingParams":
        device = resolve_device(device)

        def full(name):
            dt = torch.int32 if name == "top_k" else torch.float32
            return torch.full((num_slots,), SamplingParams.DEFAULTS[name],
                              dtype=dt, device=device)

        return SamplingParams(**{f.name: full(f.name)
                                 for f in dataclasses.fields(SamplingParams)})

    def set_slot(self, slot: int, **kw) -> None:
        """In-place single-slot update at admit time. Unspecified (None)
        fields reset to the defaults so a reused slot never inherits the
        previous request's options."""
        for f in dataclasses.fields(self):
            val = kw.get(f.name)
            getattr(self, f.name)[slot] = (self.DEFAULTS[f.name]
                                           if val is None else val)

    def rows(self, idx: slice) -> "SamplingParams":
        """A view of some slots' parameters (e.g. ``slice(s, s + 1)``)."""
        return SamplingParams(**{f.name: getattr(self, f.name)[idx]
                                 for f in dataclasses.fields(self)})


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    params: SamplingParams) -> torch.Tensor:
    """llama.cpp-style repetition penalty + OpenAI frequency/presence
    penalties, vectorized over slots. logits [S, V] f32, counts [S, V]."""
    seen = counts > 0
    rp = params.repeat_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, penalized, logits)
    logits = logits - params.frequency_penalty[:, None] * counts.float()
    logits = logits - params.presence_penalty[:, None] * seen.float()
    return logits


def sample(
    logits: torch.Tensor,            # [S, V] (any float dtype)
    params: SamplingParams,
    counts: torch.Tensor,            # [S, V] int32
    generators: Sequence[Optional[torch.Generator]],
    bias: Optional[torch.Tensor] = None,  # [S, V] f32 additive logit bias
) -> torch.Tensor:
    """Returns tokens [S] int32. ``generators[i]`` is row i's generator,
    or None for a greedy row (temperature <= 0, or an inactive slot whose
    draw would be discarded — its stream must not advance)."""
    logits = logits.float()
    if bias is not None:
        logits = logits + bias
    logits = apply_penalties(logits, counts, params)
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return tokens

    V = logits.shape[-1]
    k = min(MAX_TOPK, V)
    vals, idx = torch.topk(logits, k, dim=-1)     # [S, K] descending
    j = torch.arange(k, device=logits.device)[None, :]
    # per-slot top_k limit within the candidate pool (0 → disabled)
    tk = torch.where(params.top_k[:, None] > 0, params.top_k[:, None], k)
    keep = j < tk
    temp = params.temperature.clamp(min=1e-6)[:, None]
    scaled = torch.where(keep, vals / temp, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    # top-p (nucleus): keep the smallest prefix with cumulative prob >= top_p
    csum = torch.cumsum(probs, dim=-1)
    keep_p = (csum - probs) < params.top_p[:, None]
    # min-p: drop candidates below min_p * p_max
    keep_mp = probs >= params.min_p[:, None] * probs[:, :1]
    scaled = torch.where(keep_p & keep_mp, scaled, float("-inf"))
    final = torch.softmax(scaled, dim=-1)
    for i in rows:
        pick = torch.multinomial(final[i], 1, generator=generators[i])
        tokens[i] = idx[i, pick[0]].to(torch.int32)
    return tokens


def update_counts(counts: torch.Tensor, tokens: torch.Tensor,
                  active: torch.Tensor) -> None:
    """Scatter-add sampled tokens into the occurrence counts, in place
    (inactive slots add 0)."""
    S = counts.shape[0]
    counts.index_put_(
        (torch.arange(S, device=counts.device), tokens.long()),
        active.to(counts.dtype), accumulate=True)


def count_prompt_tokens(counts: torch.Tensor, slot: int,
                        tokens: torch.Tensor, length: int) -> None:
    """Initialize a slot's counts from its prompt, in place (so repetition
    penalties see the prompt, matching llama.cpp's penalty window)."""
    row = torch.zeros(counts.shape[1], dtype=counts.dtype,
                      device=counts.device)
    ids = tokens.reshape(-1)[:length].long()
    row.index_add_(0, ids, torch.ones_like(ids, dtype=counts.dtype))
    counts[slot] = row
