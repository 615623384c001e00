"""Per-model declarative config, as plain dataclasses.

Port of the fields of ``localai_tpu/config/model_config.py`` that this
slice reads (the JAX package validates with pydantic, which the port's
runtime does not depend on). Unknown keys are ignored; keys that would ask
for a feature the port does not have yet — Go/Jinja prompt templates,
quantized weights, speculative decoding — raise a clear error at load
instead of serving something else than was asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


def _pick(cls, data: Optional[dict]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in (data or {}).items() if k in names}


@dataclasses.dataclass
class PredictionParams:
    """Sampling / prediction defaults merged with each request."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    max_tokens: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repeat_penalty: Optional[float] = None
    seed: Optional[int] = None

    def merged_with(self, overrides: dict[str, Any]) -> "PredictionParams":
        """Request-over-config merge: explicitly given request fields win."""
        data = dataclasses.asdict(self)
        data.update({k: v for k, v in overrides.items()
                     if k in data and v is not None})
        return PredictionParams(**data)


@dataclasses.dataclass
class TemplateConfig:
    """Prompt template references. The port renders chat prompts with the
    role-prefix fallback only (templates.chat); any named template is
    refused at load."""

    chat: Optional[str] = None
    chat_message: Optional[str] = None
    completion: Optional[str] = None
    edit: Optional[str] = None
    functions: Optional[str] = None
    use_tokenizer_template: bool = False
    chat_template: Optional[str] = None
    join_chat_messages_by_character: Optional[str] = None

    def named_templates(self) -> list[str]:
        """The template fields that are set (the port has no engine for
        them yet)."""
        out = [f for f in ("chat", "chat_message", "completion", "edit",
                           "functions", "chat_template") if getattr(self, f)]
        if self.use_tokenizer_template:
            out.append("use_tokenizer_template")
        return out


@dataclasses.dataclass
class EngineConfig:
    """Serving-engine knobs the port reads."""

    max_slots: int = 8                 # concurrent decode slots
    dtype: str = "bfloat16"            # compute/weight dtype
    kv_dtype: str = "bfloat16"         # KV pool dtype: bfloat16/float32
    decode_steps_per_dispatch: int = 16
    kv_block_tokens: Optional[int] = None   # default 64
    prefill_chunk: Optional[int] = None     # default 512
    quantization: Optional[str] = None  # refused: not ported yet
    spec: Optional[bool] = None         # refused when true: not ported yet
    draft_model: Optional[str] = None   # refused: not ported yet


@dataclasses.dataclass
class ModelConfig:
    """One model's declarative config (a YAML document in the models dir)."""

    name: str = ""
    model: str = ""                    # weights ref: "debug:*" or a dir
    context_size: Optional[int] = None
    seed: Optional[int] = None         # random-weight presets + sampling
    roles: dict[str, str] = dataclasses.field(default_factory=dict)
    stopwords: list[str] = dataclasses.field(default_factory=list)
    rope_freq_base: Optional[float] = None
    rope_freq_scale: Optional[float] = None
    parameters: PredictionParams = dataclasses.field(
        default_factory=PredictionParams)
    template: TemplateConfig = dataclasses.field(
        default_factory=TemplateConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    @classmethod
    def from_dict(cls, data: dict) -> "ModelConfig":
        data = dict(data or {})
        sub = {
            "parameters": PredictionParams(
                **_pick(PredictionParams, data.pop("parameters", None))),
            "template": TemplateConfig(
                **_pick(TemplateConfig, data.pop("template", None))),
            "engine": EngineConfig(
                **_pick(EngineConfig, data.pop("engine", None))),
        }
        cfg = cls(**_pick(cls, data), **sub)
        cfg.check_supported()
        return cfg

    def check_supported(self) -> None:
        """Raise for config that asks for what the port cannot serve yet."""
        named = self.template.named_templates()
        if named:
            raise ValueError(
                f"model {self.name or self.model!r}: prompt templates "
                f"({', '.join(named)}) are not supported by the PyTorch "
                "port yet; remove them to use the role-prefix chat format")
        if self.engine.quantization:
            raise ValueError(
                f"model {self.name or self.model!r}: quantization "
                f"{self.engine.quantization!r} is not ported yet")
        if self.engine.spec or self.engine.draft_model:
            raise ValueError(
                f"model {self.name or self.model!r}: speculative decoding "
                "is not ported yet (set engine.spec: false)")

    def set_defaults(self, *, context_size: int = 4096) -> None:
        """Fill unset fields (same defaults as the JAX package)."""
        p = self.parameters
        if p.temperature is None:
            p.temperature = 0.9
        if p.top_p is None:
            p.top_p = 0.95
        if p.top_k is None:
            p.top_k = 40
        if p.max_tokens is None:
            p.max_tokens = 2048
        if self.context_size is None:
            self.context_size = context_size
        if not self.name and self.model:
            self.name = self.model
