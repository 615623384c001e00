"""RWKV (v4) language models in PyTorch.

Port of ``localai_tpu/models/rwkv.py`` (HF ``RwkvForCausalLM``
checkpoints, model_type "rwkv": RWKV/rwkv-4-*-pile): token-shift mixing
and the WKV recurrence — a linear attention over exponential
accumulators, kept stable by a running maximum — in each block's
attention, a squared-ReLU feed-forward behind a receptance gate, layer
norms before each part (and ``pre_ln`` on block 0). Like Mamba, a stream
carries O(1) recurrent state (:class:`LayerState`) and no KV cache.

Dtypes follow the JAX package's promotions: layer norms and the WKV
decay/bonus are float32, so the hidden stream is float32 from block 0's
``pre_ln`` on, and every projection multiplies float32 activations by its
weight widened to float32, as JAX promotes ``f32 @ bf16``; the WKV state
is float32 and the token-shift mix runs in the promoted dtype of the
activations and the (compute-dtype) mix weights. The prefill runs the
projections over the whole prompt and the WKV recurrence as a Python loop
over its positions; a prompt needs no length bucket (scanning the true
length gives the states of the JAX package's bucketed prefill).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Optional

import torch

from localai_tpu_torch.models.llama import torch_dtype
from localai_tpu_torch.models.loader import read_checkpoint_tensors
from localai_tpu_torch.models.mamba import generate_tokens, promoted_linear
from localai_tpu_torch.utils.device import resolve_device
from localai_tpu_torch.utils.tokenizer import ByteTokenizer, load_tokenizer

log = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    vocab_size: int = 50277
    hidden_size: int = 768
    attention_hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    layer_norm_epsilon: float = 1e-5
    eos_token_id: int = 0

    @classmethod
    def from_hf(cls, hf: dict) -> "RwkvConfig":
        H = hf.get("hidden_size", 768)
        return cls(
            vocab_size=hf.get("vocab_size", 50277),
            hidden_size=H,
            attention_hidden_size=hf.get("attention_hidden_size") or H,
            intermediate_size=hf.get("intermediate_size") or 4 * H,
            num_layers=hf.get("num_hidden_layers", 12),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            eos_token_id=hf.get("eos_token_id", 0) or 0,
        )


DEBUG_CONFIG = RwkvConfig(
    vocab_size=512, hidden_size=64, attention_hidden_size=64,
    intermediate_size=128, num_layers=2, eos_token_id=257)


def keeps_float32(name: str, t: torch.Tensor) -> bool:
    """The tensors kept in float32 whatever the engine's dtype: every
    vector (norms) and the WKV ``time_decay``/``time_first`` (the JAX
    package's ``resolve_rwkv``)."""
    return t.dim() == 1 or name.endswith(("time_decay", "time_first"))


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float
        ) -> torch.Tensor:
    """Layer norm as ``jnp.mean``/``jnp.var`` compute it (in float32,
    rounded to ``x``'s dtype), normalised in ``x``'s dtype, then the
    promoted dtype of the gain and bias (float32 ones make a float32
    result)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mu = mean.to(x.dtype)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True).to(x.dtype)
    y = (x - mu) * torch.rsqrt(var + eps)
    dt = torch.promote_types(y.dtype, g.dtype)
    return y.to(dt) * g.to(dt) + b.to(dt)


@dataclasses.dataclass
class LayerState:
    """Per-layer recurrent state (the 5 tensors of the HF cache)."""

    ffn_shift: torch.Tensor   # [B,H] last hidden fed to the FFN mix
    attn_shift: torch.Tensor  # [B,H] last hidden fed to the attention mix
    num: torch.Tensor         # [B,A] WKV numerator accumulator
    den: torch.Tensor         # [B,A] WKV denominator accumulator
    mx: torch.Tensor          # [B,A] running max (stability)


def _init_state(cfg: RwkvConfig, batch: int, device) -> list[LayerState]:
    H, A = cfg.hidden_size, cfg.attention_hidden_size
    z = torch.zeros((batch, H), dtype=torch.float32, device=device)
    za = torch.zeros((batch, A), dtype=torch.float32, device=device)
    return [LayerState(z, z, za, za, za - 1e38)
            for _ in range(cfg.num_layers)]


def _wkv_step(num, den, mx, k, v, time_decay, time_first):
    """One WKV update (the stabilised form): (out, num, den, max)."""
    max_out = torch.maximum(mx, k + time_first)
    e1 = torch.exp(mx - max_out)
    e2 = torch.exp(k + time_first - max_out)
    out = (e1 * num + e2 * v) / (e1 * den + e2)
    max_state = torch.maximum(mx + time_decay, k)
    e1 = torch.exp(mx + time_decay - max_state)
    e2 = torch.exp(k - max_state)
    return out, e1 * num + e2 * v, e1 * den + e2, max_state


def _mix(x: torch.Tensor, shifted: torch.Tensor, m: torch.Tensor
         ) -> torch.Tensor:
    """``x * m + shifted * (1 - m)`` with the mix weight ``m`` in its own
    dtype (``1 - m`` stays there, as JAX keeps a weak scalar's)."""
    return x * m + shifted * (1 - m)


def _attention(p: Params, i: int, x: torch.Tensor, shifted: torch.Tensor,
               st: LayerState):
    """x, shifted [B,L,H] → (out, num, den, mx)."""
    pre = f"rwkv.blocks.{i}.attention"
    mk = p[f"{pre}.time_mix_key"][0]
    mv = p[f"{pre}.time_mix_value"][0]
    mr = p[f"{pre}.time_mix_receptance"][0]
    key = promoted_linear(_mix(x, shifted, mk), p[f"{pre}.key.weight"])
    value = promoted_linear(_mix(x, shifted, mv), p[f"{pre}.value.weight"])
    recept = torch.sigmoid(promoted_linear(_mix(x, shifted, mr),
                                   p[f"{pre}.receptance.weight"]))
    time_decay = -torch.exp(p[f"{pre}.time_decay"].float())
    time_first = p[f"{pre}.time_first"].float()
    k_f = key.float()
    num, den, mx = st.num, st.den, st.mx
    outs = []
    for t in range(key.shape[1]):
        out, num, den, mx = _wkv_step(num, den, mx, k_f[:, t],
                                      value[:, t], time_decay, time_first)
        outs.append(out)
    rwkv_out = torch.stack(outs, dim=1).to(x.dtype)
    out = promoted_linear(recept * rwkv_out, p[f"{pre}.output.weight"])
    return out, num, den, mx


def _feed_forward(p: Params, i: int, x: torch.Tensor, shifted: torch.Tensor
                  ) -> torch.Tensor:
    pre = f"rwkv.blocks.{i}.feed_forward"
    mk = p[f"{pre}.time_mix_key"][0]
    mr = p[f"{pre}.time_mix_receptance"][0]
    key = promoted_linear(_mix(x, shifted, mk), p[f"{pre}.key.weight"])
    key = torch.square(torch.relu(key))
    value = promoted_linear(key, p[f"{pre}.value.weight"])
    recept = torch.sigmoid(promoted_linear(_mix(x, shifted, mr),
                                   p[f"{pre}.receptance.weight"]))
    return recept * value


def _shift(x: torch.Tensor, first_row: torch.Tensor) -> torch.Tensor:
    """Token shift: row t sees row t-1; the first row sees the carried
    state (zeros on a fresh sequence)."""
    return torch.cat([first_row[:, None], x[:, :-1]], dim=1)


def forward(p: Params, cfg: RwkvConfig, ids: torch.Tensor,
            states: Optional[list[LayerState]] = None, full: bool = True
            ) -> tuple[torch.Tensor, list[LayerState]]:
    """ids [B,L] → (logits, new states); states None = fresh.
    ``full=False`` projects the head at the last position only ([B,V])."""
    B = ids.shape[0]
    if states is None:
        states = _init_state(cfg, B, ids.device)
    h = p["rwkv.embeddings.weight"][ids]
    eps = cfg.layer_norm_epsilon
    new_states = []
    for i in range(cfg.num_layers):
        blk = f"rwkv.blocks.{i}"
        if i == 0:
            h = _ln(h, p[f"{blk}.pre_ln.weight"], p[f"{blk}.pre_ln.bias"],
                    eps)
        st = states[i]
        x1 = _ln(h, p[f"{blk}.ln1.weight"], p[f"{blk}.ln1.bias"], eps)
        attn, num, den, mx = _attention(
            p, i, x1, _shift(x1, st.attn_shift.to(x1.dtype)), st)
        h = h + attn
        x2 = _ln(h, p[f"{blk}.ln2.weight"], p[f"{blk}.ln2.bias"], eps)
        h = h + _feed_forward(p, i, x2,
                              _shift(x2, st.ffn_shift.to(x2.dtype)))
        # copies: a view would keep the layer's [B, L, H] activations
        new_states.append(LayerState(
            ffn_shift=x2[:, -1].to(torch.float32, copy=True),
            attn_shift=x1[:, -1].to(torch.float32, copy=True),
            num=num, den=den, mx=mx))
    if not full:
        h = h[:, -1]
    h = _ln(h, p["rwkv.ln_out.weight"], p["rwkv.ln_out.bias"], eps)
    return promoted_linear(h, p["head.weight"]), new_states


class RwkvLM:
    """One loaded RWKV model: prompt → tokens, O(1) state a stream (the
    generate surface of ``MambaLM``, which the recurrent serving facade
    drives)."""

    def __init__(self, cfg: RwkvConfig, params: Params, tokenizer: Any):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params["rwkv.embeddings.weight"].device

    def generate(self, prompt: list[int], *, max_new_tokens: int = 128,
                 temperature: float = 0.0, seed: int = 0,
                 eos_ids: Optional[set[int]] = None,
                 on_token=None) -> list[int]:
        eos = eos_ids if eos_ids is not None else {self.cfg.eos_token_id}
        p, cfg = self.params, self.cfg

        def step(tok, states):
            logits, states = forward(p, cfg, tok[:, None], states)
            return logits[:, -1], states

        return generate_tokens(
            lambda ids: forward(p, cfg, ids, None, full=False), step,
            prompt, device=self.device, eos=eos,
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, on_token=on_token)


def param_shapes(cfg: RwkvConfig) -> dict[str, tuple]:
    H, A, I = (cfg.hidden_size, cfg.attention_hidden_size,
               cfg.intermediate_size)
    shapes = {"rwkv.embeddings.weight": (cfg.vocab_size, H),
              "rwkv.ln_out.weight": (H,), "rwkv.ln_out.bias": (H,),
              "head.weight": (cfg.vocab_size, H)}
    for i in range(cfg.num_layers):
        blk = f"rwkv.blocks.{i}"
        lns = ("pre_ln", "ln1", "ln2") if i == 0 else ("ln1", "ln2")
        for ln in lns:
            shapes[f"{blk}.{ln}.weight"] = (H,)
            shapes[f"{blk}.{ln}.bias"] = (H,)
        at = f"{blk}.attention"
        shapes[f"{at}.time_decay"] = (A,)
        shapes[f"{at}.time_first"] = (A,)
        for m in ("key", "value", "receptance"):
            shapes[f"{at}.time_mix_{m}"] = (1, 1, H)
            shapes[f"{at}.{m}.weight"] = (A, H)
        shapes[f"{at}.output.weight"] = (H, A)
        ff = f"{blk}.feed_forward"
        shapes[f"{ff}.time_mix_key"] = (1, 1, H)
        shapes[f"{ff}.time_mix_receptance"] = (1, 1, H)
        shapes[f"{ff}.key.weight"] = (I, H)
        shapes[f"{ff}.receptance.weight"] = (H, H)
        shapes[f"{ff}.value.weight"] = (H, I)
    return shapes


def init_params(cfg: RwkvConfig, generator: torch.Generator,
                device: str | torch.device | None = None,
                dtype: str = "float32") -> Params:
    """Random weights in the HF layout, as the JAX package draws them:
    matrices N(0, 0.05), norm gains 1 and biases 0, decay and bonus 0,
    mix weights 0.5. In ``dtype`` but the float32 tensors
    (:func:`keeps_float32`); drawn on ``generator``'s device."""
    device = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(dtype)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(("time_decay", "time_first", ".bias")):
            t = torch.zeros(shape, device=device)
        elif "time_mix" in name:
            t = torch.full(shape, 0.5, device=device)
        elif len(shape) == 1:
            t = torch.ones(shape, device=device)
        else:
            t = torch.randn(shape, generator=generator, device=device) * 0.05
        out[name] = t.to(torch.float32 if keeps_float32(name, t) else dt)
    return out


def resolve_rwkv(ref: str, model_path: str | Path = "models",
                 dtype: str = "float32", seed: int = 0,
                 device: str | torch.device | None = "cuda") -> RwkvLM:
    """``debug:rwkv-tiny`` (random weights from ``seed``, byte tokenizer)
    or an HF ``RwkvForCausalLM`` checkpoint directory, its matrices and
    mix weights in ``dtype`` (vectors, decay and bonus in float32) on
    ``device``."""
    dev = resolve_device(device)
    if ref == "debug:rwkv-tiny":
        gen = torch.Generator(device=dev).manual_seed(seed)
        return RwkvLM(DEBUG_CONFIG, init_params(DEBUG_CONFIG, gen, dev),
                      ByteTokenizer())
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            cfg = RwkvConfig.from_hf(
                json.loads((cand / "config.json").read_text()))
            return RwkvLM(cfg, read_checkpoint_tensors(cand, dtype, dev,
                                                       keeps_float32),
                          load_tokenizer(cand))
    raise FileNotFoundError(f"rwkv ref {ref!r} not found")
