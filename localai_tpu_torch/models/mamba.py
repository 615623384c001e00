"""Mamba (selective state space) language models in PyTorch.

Port of ``localai_tpu/models/mamba.py`` (HF ``MambaForCausalLM``
checkpoints, model_type "mamba": state-spaces/mamba-*-hf): per block an
input projection into x and a gate, a causal depthwise conv over time,
the input-dependent discretisation (dt, B, C) and the selective scan,
then ``y + x·D``, the SiLU gate and the output projection; RMS norms
before each block and at the end, the head tied to the embeddings unless
the checkpoint has its own ``lm_head``.

Dtypes follow the JAX package's promotions: the residual stream and the
scan state are float32, ``dA`` is float32 (an f32 A against the
compute-dtype dt) while ``dBu`` stays in the compute dtype; ``y`` is
float32 from the scan on, so the output projection multiplies float32
activations by the weight widened to float32, as JAX promotes
``f32 @ bf16``. The prefill runs every projection over the whole prompt
and the scan as a Python loop over its positions, one fused
multiply-add a position into a [L, B, D, N] buffer of states; the decode
step rolls the conv buffer and advances the state once. A prompt needs
no length bucket here: scanning the true length gives the states and
logits of the JAX package's bucketed, length-gated prefill.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Optional

import torch
import torch.nn.functional as F

from localai_tpu_torch.models.llama import torch_dtype
from localai_tpu_torch.models.loader import read_checkpoint_tensors
from localai_tpu_torch.utils.device import resolve_device
from localai_tpu_torch.utils.tokenizer import ByteTokenizer, load_tokenizer

log = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    vocab_size: int = 50280
    hidden_size: int = 768
    intermediate_size: int = 1536
    state_size: int = 16
    conv_kernel: int = 4
    num_layers: int = 24
    time_step_rank: int = 48
    layer_norm_epsilon: float = 1e-5
    use_bias: bool = False
    use_conv_bias: bool = True
    eos_token_id: int = 0

    @classmethod
    def from_hf(cls, hf: dict) -> "MambaConfig":
        tsr = hf.get("time_step_rank", "auto")
        if tsr == "auto":
            tsr = -(-hf.get("hidden_size", 768) // 16)  # ceil(H/16)
        return cls(
            vocab_size=hf.get("vocab_size", 50280),
            hidden_size=hf.get("hidden_size", 768),
            intermediate_size=hf.get(
                "intermediate_size", 2 * hf.get("hidden_size", 768)),
            state_size=hf.get("state_size", 16),
            conv_kernel=hf.get("conv_kernel", 4),
            num_layers=hf.get("num_hidden_layers", 24),
            time_step_rank=int(tsr),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            use_bias=hf.get("use_bias", False),
            use_conv_bias=hf.get("use_conv_bias", True),
            eos_token_id=hf.get("eos_token_id", 0) or 0,
        )


DEBUG_CONFIG = MambaConfig(
    vocab_size=512, hidden_size=64, intermediate_size=128, state_size=8,
    conv_kernel=4, num_layers=2, time_step_rank=4, eos_token_id=257)

# State = (conv_state [B, D, k] in the compute dtype, ssm_state [B, D, N]
# float32), one pair a layer
State = tuple[torch.Tensor, torch.Tensor]


def keeps_float32(name: str) -> bool:
    """The tensors a checkpoint keeps in float32 whatever the engine's
    dtype: ``A_log`` and ``D`` (the JAX package's ``resolve_mamba``)."""
    return name.endswith(("A_log", ".D"))


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (w.float() * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def promoted_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in the promoted dtype of the two, as JAX multiplies."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt).T


def _mixer_common(p: Params, i: int, cfg: MambaConfig, u: torch.Tensor):
    pre = f"backbone.layers.{i}.mixer"
    proj = promoted_linear(u, p[f"{pre}.in_proj.weight"])
    if cfg.use_bias:
        proj = proj + p[f"{pre}.in_proj.bias"]
    x, gate = proj.chunk(2, dim=-1)
    return pre, x, gate


def _ssm_params(p: Params, pre: str, cfg: MambaConfig, x: torch.Tensor):
    """x [B,L,D] → (dA [B,L,D,N] f32, dBu [B,L,D,N] compute dtype,
    C [B,L,N])."""
    ssm_in = promoted_linear(x, p[f"{pre}.x_proj.weight"])
    r, n = cfg.time_step_rank, cfg.state_size
    dt, B, C = ssm_in[..., :r], ssm_in[..., r:r + n], ssm_in[..., r + n:]
    dt = (promoted_linear(dt, p[f"{pre}.dt_proj.weight"])
          + p[f"{pre}.dt_proj.bias"])
    dt = F.softplus(dt)
    A = -torch.exp(p[f"{pre}.A_log"].float())                  # [D,N]
    dA = torch.exp(dt[..., None].float() * A)                  # f32
    dBu = dt[..., None] * B[..., None, :] * x[..., None]      # compute dt
    return dA, dBu, C


def _gate_out(p: Params, pre: str, cfg: MambaConfig, y: torch.Tensor,
              x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(y f32 + x·D) · silu(gate) → the output projection, in float32."""
    y = y + x.float() * p[f"{pre}.D"].float()
    y = y * F.silu(gate).float()
    out = promoted_linear(y, p[f"{pre}.out_proj.weight"])
    if cfg.use_bias:
        out = out + p[f"{pre}.out_proj.bias"].float()
    return out


def _block_prefill(p: Params, i: int, cfg: MambaConfig, u: torch.Tensor):
    """One block over the prompt; returns (out f32, conv_state,
    ssm_state)."""
    pre, x, gate = _mixer_common(p, i, cfg, u)
    B_, L, D = x.shape
    k = cfg.conv_kernel
    xt = x.transpose(1, 2)                                     # [B,D,L]
    # causal depthwise conv (the JAX package's conv_general_dilated with
    # (k-1, 0) padding): k shifted multiply-adds over the left-padded
    # input, accumulated in float32 and rounded once, as the convolution
    # accumulates; no library convolution (its workspace can be large)
    w = p[f"{pre}.conv1d.weight"][:, 0, :].float()             # [D,k]
    xp = F.pad(xt, (k - 1, 0)).float()
    conv = sum(w[None, :, j, None] * xp[..., j:j + L] for j in range(k))
    if cfg.use_conv_bias:
        conv = conv + p[f"{pre}.conv1d.bias"].to(x.dtype).float()[:, None]
    x = F.silu(conv.to(x.dtype)).transpose(1, 2)               # [B,L,D]
    # decode conv state = pre-conv inputs at positions [L-k, L)
    conv_state = F.pad(xt, (k, 0))[..., L:L + k].contiguous()
    dA, dBu, C = _ssm_params(p, pre, cfg, x)
    dA = dA.transpose(0, 1).contiguous()                       # [L,B,D,N]
    dBu = dBu.transpose(0, 1).float().contiguous()
    hs = torch.empty_like(dA)
    state = torch.zeros((B_, D, cfg.state_size), dtype=torch.float32,
                        device=x.device)
    for t in range(L):
        state = torch.addcmul(dBu[t], dA[t], state, out=hs[t])
    y = torch.einsum("lbdn,bln->bld", hs, C.float())
    # the carried state is a copy: a view of hs would keep all L states
    return _gate_out(p, pre, cfg, y, x, gate), conv_state, state.clone()


def _block_step(p: Params, i: int, cfg: MambaConfig, u: torch.Tensor,
                conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One block for one token: u [B,H] → (out [B,H] f32, states)."""
    pre, x, gate = _mixer_common(p, i, cfg, u[:, None])
    x, gate = x[:, 0], gate[:, 0]
    conv_state = torch.cat([conv_state[:, :, 1:], x[:, :, None]], dim=2)
    w = p[f"{pre}.conv1d.weight"][:, 0, :].to(x.dtype)        # [D,k]
    xc = (conv_state * w[None]).sum(-1)
    if cfg.use_conv_bias:
        xc = xc + p[f"{pre}.conv1d.bias"].to(x.dtype)
    xc = F.silu(xc)
    dA, dBu, C = _ssm_params(p, pre, cfg, xc[:, None])
    ssm_state = dA[:, 0] * ssm_state + dBu[:, 0].float()
    y = torch.einsum("bdn,bn->bd", ssm_state, C[:, 0].float())
    return _gate_out(p, pre, cfg, y, xc, gate), conv_state, ssm_state


def _lm_head(p: Params) -> torch.Tensor:
    return p.get("lm_head.weight", p["backbone.embeddings.weight"])


def forward_prefill(p: Params, cfg: MambaConfig, ids: torch.Tensor,
                    full: bool = True) -> tuple[torch.Tensor, list[State]]:
    """ids [B,L] → (logits, states). ``full=True`` gives logits at every
    position [B,L,V]; ``full=False`` projects the head at the last
    position only ([B,V], the serving path)."""
    h = p["backbone.embeddings.weight"][ids]
    states = []
    for i in range(cfg.num_layers):
        res = h.float()
        normed = _rms(h, p[f"backbone.layers.{i}.norm.weight"],
                      cfg.layer_norm_epsilon)
        out, cs, ss = _block_prefill(p, i, cfg, normed)
        h = (res + out).to(h.dtype)
        states.append((cs, ss))
    if not full:
        h = h[:, -1]
    h = _rms(h, p["backbone.norm_f.weight"], cfg.layer_norm_epsilon)
    return promoted_linear(h, _lm_head(p)), states


def forward_step(p: Params, cfg: MambaConfig, token: torch.Tensor,
                 states: list[State]) -> tuple[torch.Tensor, list[State]]:
    """token [B] → (logits [B,V], new states)."""
    h = p["backbone.embeddings.weight"][token]
    new_states = []
    for i in range(cfg.num_layers):
        res = h.float()
        normed = _rms(h, p[f"backbone.layers.{i}.norm.weight"],
                      cfg.layer_norm_epsilon)
        out, cs, ss = _block_step(p, i, cfg, normed, *states[i])
        h = (res + out).to(h.dtype)
        new_states.append((cs, ss))
    h = _rms(h, p["backbone.norm_f.weight"], cfg.layer_norm_epsilon)
    return promoted_linear(h, _lm_head(p)), new_states


def sample_next(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """[1,V] logits → [1] token: argmax, or a categorical draw at
    ``temperature`` from ``generator``."""
    if temperature and temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate_tokens(prefill, step, prompt: list[int], *, device,
                    eos: set[int], max_new_tokens: int, temperature: float,
                    seed: int, on_token) -> list[int]:
    """The recurrent models' shared generation loop: prefill the prompt
    (an empty prompt is token 0), then sample, report and step one token
    at a time until EOS or the budget. Seeded draws come from a
    ``torch.Generator`` on the model's device."""
    toks = prompt or [0]
    with torch.no_grad():
        ids = torch.tensor([toks], dtype=torch.long, device=device)
        last, states = prefill(ids)
        gen = None
        if temperature and temperature > 0:
            gen = torch.Generator(device=device).manual_seed(seed)
        out: list[int] = []
        for _ in range(max_new_tokens):
            tok = sample_next(last, temperature, gen)
            t = int(tok[0])
            if t in eos:
                break
            out.append(t)
            if on_token is not None:
                on_token(t)
            last, states = step(tok, states)
        return out


class MambaLM:
    """One loaded mamba model: prompt → tokens, O(1) state a stream."""

    def __init__(self, cfg: MambaConfig, params: Params, tokenizer: Any):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params["backbone.embeddings.weight"].device

    def generate(self, prompt: list[int], *, max_new_tokens: int = 128,
                 temperature: float = 0.0, seed: int = 0,
                 eos_ids: Optional[set[int]] = None,
                 on_token=None) -> list[int]:
        eos = eos_ids if eos_ids is not None else {self.cfg.eos_token_id}
        p, cfg = self.params, self.cfg
        return generate_tokens(
            lambda ids: forward_prefill(p, cfg, ids, full=False),
            lambda tok, st: forward_step(p, cfg, tok, st),
            prompt, device=self.device, eos=eos,
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, on_token=on_token)


def param_shapes(cfg: MambaConfig) -> dict[str, tuple]:
    H, D, N = cfg.hidden_size, cfg.intermediate_size, cfg.state_size
    shapes = {"backbone.embeddings.weight": (cfg.vocab_size, H),
              "backbone.norm_f.weight": (H,)}
    for i in range(cfg.num_layers):
        pre = f"backbone.layers.{i}"
        m = f"{pre}.mixer"
        shapes.update({
            f"{pre}.norm.weight": (H,),
            f"{m}.in_proj.weight": (2 * D, H),
            f"{m}.conv1d.weight": (D, 1, cfg.conv_kernel),
            f"{m}.conv1d.bias": (D,),
            f"{m}.x_proj.weight": (cfg.time_step_rank + 2 * N, D),
            f"{m}.dt_proj.weight": (D, cfg.time_step_rank),
            f"{m}.dt_proj.bias": (D,),
            f"{m}.A_log": (D, N),
            f"{m}.D": (D,),
            f"{m}.out_proj.weight": (H, D),
        })
        if cfg.use_bias:
            shapes[f"{m}.in_proj.bias"] = (2 * D,)
            shapes[f"{m}.out_proj.bias"] = (H,)
    return shapes


def init_params(cfg: MambaConfig, generator: torch.Generator,
                device: str | torch.device | None = None,
                dtype: str = "float32") -> Params:
    """Random weights in the HF layout, as the JAX package draws them:
    matrices N(0, 0.05), norms and D 1, conv and projection biases 0,
    dt_proj's bias -2, A_log = log(1..N) a row. In ``dtype``, ``A_log``
    and ``D`` in float32; drawn on ``generator``'s device."""
    device = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(dtype)
    N = cfg.state_size
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("A_log"):
            t = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=device)).expand(shape)
        elif name.endswith("dt_proj.bias"):
            t = torch.full(shape, -2.0, device=device)
        elif name.endswith((".D", "norm.weight", "norm_f.weight")):
            t = torch.ones(shape, device=device)
        elif name.endswith(".bias"):
            t = torch.zeros(shape, device=device)
        else:
            t = torch.randn(shape, generator=generator, device=device) * 0.05
        out[name] = t.to(torch.float32 if keeps_float32(name) else dt
                         ).contiguous()
    return out


def resolve_mamba(ref: str, model_path: str | Path = "models",
                  dtype: str = "float32", seed: int = 0,
                  device: str | torch.device | None = "cuda") -> MambaLM:
    """``debug:mamba-tiny`` (random weights from ``seed``, byte
    tokenizer) or an HF ``MambaForCausalLM`` checkpoint directory, its
    tensors in ``dtype`` (``A_log`` and ``D`` in float32) on ``device``."""
    dev = resolve_device(device)
    if ref == "debug:mamba-tiny":
        gen = torch.Generator(device=dev).manual_seed(seed)
        return MambaLM(DEBUG_CONFIG, init_params(DEBUG_CONFIG, gen, dev),
                       ByteTokenizer())
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "config.json").exists():
            cfg = MambaConfig.from_hf(
                json.loads((cand / "config.json").read_text()))
            params = read_checkpoint_tensors(
                cand, dtype, dev, lambda name, t: keeps_float32(name))
            return MambaLM(cfg, params, load_tokenizer(cand))
    raise FileNotFoundError(f"mamba ref {ref!r} not found")
