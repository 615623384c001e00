"""Per-model declarative config, as plain dataclasses.

Port of the fields of ``localai_tpu/config/model_config.py`` that the port
reads (the JAX package validates with pydantic, which the port's runtime
does not depend on). Unknown keys are ignored; keys that would ask for a
feature the port does not have — a raw ``grammar`` string, which the
JAX package declares and reads nowhere — raise a clear error at load
instead of serving something else than was asked for. Prompt templates
(``template:``, :class:`TemplateConfig`: Go or Jinja ``chat_message``,
``chat``, ``completion``, ``edit``, ``functions``, a Jinja
``chat_template`` and ``use_tokenizer_template``, rendered by the port's
own engine in ``templates/``), function calling (a ``function`` section,
:class:`FunctionsConfig`), int8, int8_w8a8 and int4 weights
(``engine.quantization``), self-extend (``engine.grp_attn_n`` > 1 with
``grp_attn_w``), the disk prompt cache (``prompt_cache_path``,
``prompt_cache_all``, ``prompt_cache_ro``), int8/int4 KV storage
(``engine.kv_dtype``;
int4 on the paged layout only), the contiguous KV layout
(``engine.kv_paged: false``), embeddings (``embeddings: true``) and
speculative decoding (``engine.spec``, ``spec_drafter``, ``spec_gamma``,
``n_draft``, ``draft_model``: on by default for paged engines, as in the
JAX package), a vision tower (``mmproj``: a llava checkpoint directory
or ``debug:vit``; ``image_token_id``), the cross-encoder and sentence
encoder (``backend: reranker | bert-embeddings | sentencetransformers``),
the recurrent-state engine (``backend: mamba | rwkv``), the remote-API
client (``backend: huggingface | langchain-huggingface`` with
``api_token`` and ``api_base``), speech-to-text (``backend: whisper``),
VITS voices (``backend: vits``, with a ``tts:`` section,
:class:`TTSConfig`) and image generation (``backend: diffusers``, with a
``diffusers:`` section, :class:`DiffusionConfig`, and ``lora_adapter`` /
``lora_scale``) are served, FLUX-class models included
(``debug:flux-tiny`` or a ``transformer/`` layout,
``image.pipeline.resolve_image_model``). A ``sharding:`` section
(:class:`ShardingConfig`, the JAX package's fields; an unknown key raises)
and the top-level ``tensor_parallel_size`` alias are read as the JAX
package reads them; ``models.manager`` serves the ``model``, ``seq`` and
``pipe`` axes they ask for (``engine.sp_prefill_threshold``: the prompt
length from which a ``seq`` mesh prefills by ring attention) and refuses
the others by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


KV_DTYPES = ("bfloat16", "float32", "int8", "int4")
QUANTIZATIONS = ("int8", "int8_w8a8", "int4")
# every usecase flag, in the JAX package's order (its ``Usecase`` enum)
USECASES = ("chat", "completion", "edit", "embeddings", "image",
            "transcript", "tts", "sound_generation", "rerank", "tokenize",
            "vision")
# the usecases the port serves
SERVED_USECASES = ("chat", "completion", "edit", "embeddings", "image",
                   "transcript", "tts", "sound_generation", "rerank")
# backend names served by the LLM engine (the JAX package's list)
LLM_BACKENDS = ("", "jax", "jax-llm", "transformers", "worker",
                "huggingface", "langchain-huggingface", "mamba", "rwkv")


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
    n: int = 1                         # images a prompt (the image API)

    def merged_with(self, overrides: dict[str, Any]) -> "PredictionParams":
        """Request-over-config merge: explicitly given request fields win."""
        data = dataclasses.asdict(self)
        data.update({k: v for k, v in overrides.items()
                     if k in data and v is not None})
        return PredictionParams(**data)


@dataclasses.dataclass
class TemplateConfig:
    """Prompt template references (the JAX package's TemplateConfig). Each
    of ``chat``, ``chat_message``, ``completion``, ``edit`` and
    ``functions`` names a ``.tmpl``/``.jinja``/``.j2`` file of the models
    dir or is the template's body, in Go template or Jinja syntax
    (``templates.cache``); ``chat_template`` is a Jinja chat template over
    ``messages`` (filled from the checkpoint by ``config.guesser`` for a
    template-less config); ``use_tokenizer_template`` renders the chat
    with it; ``multimodal`` places a message's image and video
    placeholders around its text (``templates.chat.
    multimodal_placeholders``)."""

    chat: Optional[str] = None
    chat_message: Optional[str] = None
    completion: Optional[str] = None
    edit: Optional[str] = None
    functions: Optional[str] = None
    use_tokenizer_template: bool = False
    chat_template: Optional[str] = None
    join_chat_messages_by_character: Optional[str] = None
    multimodal: Optional[str] = None    # [img-N]/[vid-N] placeholders


@dataclasses.dataclass
class FunctionsConfig:
    """Function-calling / tool-use behaviour, with the JAX package's fields
    and defaults (LocalAI's FunctionsConfig). ``grammar`` holds the tool
    grammar's options (parallel_calls, mixed_mode, prefix, schema_type,
    disable, ...), read by ``functions.tools.build_tool_regex``."""

    disable_no_action: bool = False
    no_action_function_name: str = "answer"
    no_action_description_name: str = ""
    function_name_key: str = "name"
    function_arguments_key: str = "arguments"
    response_regex: list[str] = dataclasses.field(default_factory=list)
    json_regex_match: list[str] = dataclasses.field(default_factory=list)
    replace_function_results: list[dict[str, str]] = dataclasses.field(
        default_factory=list)
    replace_llm_results: list[dict[str, str]] = dataclasses.field(
        default_factory=list)
    capture_llm_results: list[str] = dataclasses.field(default_factory=list)
    grammar: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TTSConfig:
    """The ``tts:`` section (the JAX package's TTSConfig): the default
    ``voice`` and a reference recording for cloning (``audio_path``: a wav
    file, or a directory of ``<voice>.wav``, relative to the models dir
    unless absolute). Other keys are kept in ``extra``, as the JAX
    package's model keeps them."""

    voice: Optional[str] = None
    audio_path: Optional[str] = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "TTSConfig":
        data = dict(data or {})
        return cls(voice=data.pop("voice", None),
                   audio_path=data.pop("audio_path", None), extra=data)


@dataclasses.dataclass
class DiffusionConfig:
    """The ``diffusers:`` section (the JAX package's DiffusionConfig):
    the pipeline's default scheduler, guidance, clip skip and steps, and a
    ControlNet loaded beside it (``control_net``, a directory or a name
    under the models dir) with its ``control_scale``. Other keys are kept
    in ``extra``."""

    scheduler_type: Optional[str] = None
    cfg_scale: Optional[float] = None
    clip_skip: Optional[int] = None
    pipeline_type: Optional[str] = None
    enable_parameters: Optional[str] = None
    steps: Optional[int] = None
    control_net: Optional[str] = None
    control_scale: float = 1.0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "DiffusionConfig":
        data = dict(data or {})
        known = _pick(cls, data)
        known.pop("extra", None)
        return cls(**known, extra={k: v for k, v in data.items()
                                   if k not in known})


@dataclasses.dataclass
class EngineConfig:
    """Serving-engine knobs the port reads."""

    max_slots: int = 8                 # concurrent decode slots
    dtype: str = "bfloat16"            # compute/weight dtype
    kv_dtype: str = "bfloat16"         # KV pool: bfloat16/float32/int8/int4
    decode_steps_per_dispatch: int = 16
    kv_block_tokens: Optional[int] = None   # default 64
    prefill_chunk: Optional[int] = None     # default 512
    # KV layout: None or true = the paged block pool, false = the
    # contiguous slot cache (one device: nothing else forces contiguous)
    kv_paged: Optional[bool] = None
    prefill_buckets: Optional[list[int]] = None  # default 128/512/2048/8192
    # self-extend (engine.selfextend): grp_attn_n > 1 serves up to
    # max_position_embeddings * grp_attn_n on the contiguous layout;
    # grp_attn_w (the neighbour window) must be a multiple of it
    grp_attn_n: int = 1
    grp_attn_w: int = 512
    # the JAX package's attention choice (auto | pallas | pallas_interpret
    # | xla; LOCALAI_ATTN_IMPL / LOCALAI_PAGED_ATTN_IMPL when auto): read
    # and checked at load (ops.resolve_attn_impl); the port runs one
    # attention path per device whatever it says
    attn_impl: str = "auto"
    quantization: Optional[str] = None  # weights: int8 | int8_w8a8 | int4
    # speculative decoding (localai_tpu_torch.spec), as the JAX package
    # reads it: spec None = on for paged engines (LOCALAI_SPEC=0 turns it
    # off) and for any engine with a draft_model; spec_drafter auto |
    # ngram | model; spec_gamma = draft tokens a window (default n_draft
    # with a draft model, else LOCALAI_SPEC_GAMMA or 4)
    spec: Optional[bool] = None
    spec_drafter: str = "auto"
    spec_gamma: Optional[int] = None
    n_draft: int = 4
    draft_model: Optional[str] = None  # a same-vocab model ref
    pipeline_depth: int = 2             # in-flight decode dispatches
    stream_latency_ms: float = 100.0    # SSE delivery-lag bound
    # paged pool size in blocks (None = the contiguous footprint, or
    # LOCALAI_KV_BLOCKS); a smaller pool overcommits and holds admissions
    kv_num_blocks: Optional[int] = None
    # prompts at or above this many tokens take the ring-attention
    # prefill when the mesh has a 'seq' axis
    sp_prefill_threshold: int = 1024


@dataclasses.dataclass
class ShardingConfig:
    """How to lay the model over a mesh: the JAX package's five fields and
    defaults (its ``ShardingConfig``, ``extra="forbid"``: an unknown key
    raises at load, naming it). ``tensor_parallel_size`` (``model``),
    ``sequence_parallel_size`` (``seq``) and ``pipeline_parallel_size``
    (``pipe``, alone) are served; ``data_parallel_size`` above 1 and
    ``expert_parallel_size`` above 1 are refused, naming ROADMAP item 19
    part 2 (``models.manager``)."""

    tensor_parallel_size: int = 1     # 'model' mesh axis
    data_parallel_size: int = 0       # 0 = auto: fill remaining devices
    sequence_parallel_size: int = 1   # 'seq' axis
    expert_parallel_size: int = 1     # 'expert' axis
    pipeline_parallel_size: int = 1   # 'pipe' axis

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "ShardingConfig":
        data = dict(data or {})
        names = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(data) - names)
        if extra:
            raise ValueError(f"sharding: unknown field(s) {extra} (have "
                             f"{sorted(names)})")
        return cls(**{k: int(v) for k, v in data.items()})


@dataclasses.dataclass
class ModelConfig:
    """One model's declarative config (a YAML document in the models dir)."""

    name: str = ""
    backend: str = ""                  # "" = the LLM engine
    model: str = ""                    # weights ref: "debug:*" or a dir
    embeddings: bool = False           # serve /v1/embeddings (and rerank)
    known_usecases: Optional[list[str]] = None
    mmproj: Optional[str] = None       # vision tower ref (dir or debug:)
    api_token: str = ""                # remote-API backends (huggingface)
    api_base: str = ""
    # a LoRA merged into an image model's weights at load (a file, or a
    # path under the models dir)
    lora_adapter: str = ""
    lora_scale: float = 1.0
    image_token_id: Optional[int] = None  # placeholder id for image spans
                                          # (default: HF image_token_index
                                          # or 0; embeddings are injected
                                          # over these positions anyway)
    context_size: Optional[int] = None
    seed: Optional[int] = None         # random-weight presets + sampling
    system_prompt: str = ""            # SystemPrompt of the templates
    roles: dict[str, str] = dataclasses.field(default_factory=dict)
    stopwords: list[str] = dataclasses.field(default_factory=list)
    # completion text shaping (api.openai.finetune_result)
    cutstrings: list[str] = dataclasses.field(default_factory=list)
    extract_regex: list[str] = dataclasses.field(default_factory=list)
    trimspace: list[str] = dataclasses.field(default_factory=list)
    trimsuffix: list[str] = dataclasses.field(default_factory=list)
    f16: Optional[bool] = None         # false -> engine.dtype float32
    # the disk prompt KV cache (engine.promptcache): a directory, relative
    # to the models dir unless absolute; _all keeps the generation too,
    # _ro reads and never writes
    prompt_cache_path: Optional[str] = None
    prompt_cache_all: bool = False
    prompt_cache_ro: bool = False
    grammar: str = ""                  # refused: read nowhere by the
                                       # JAX package
    function: FunctionsConfig = dataclasses.field(
        default_factory=FunctionsConfig)
    rope_freq_base: Optional[float] = None
    rope_freq_scale: Optional[float] = None
    parameters: PredictionParams = dataclasses.field(
        default_factory=PredictionParams)
    template: TemplateConfig = dataclasses.field(
        default_factory=TemplateConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    sharding: ShardingConfig = dataclasses.field(
        default_factory=ShardingConfig)
    # the top-level alias of sharding.tensor_parallel_size (the JAX
    # package's compat field)
    tensor_parallel_size: Optional[int] = None
    tts: TTSConfig = dataclasses.field(default_factory=TTSConfig)
    diffusers: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)

    def __post_init__(self) -> None:
        # the JAX package's _apply_compat
        if (self.tensor_parallel_size
                and self.sharding.tensor_parallel_size == 1):
            self.sharding.tensor_parallel_size = self.tensor_parallel_size
        if self.f16 is False:
            self.engine.dtype = "float32"

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
            "function": FunctionsConfig(
                **_pick(FunctionsConfig, data.pop("function", None))),
            "tts": TTSConfig.from_dict(data.pop("tts", None)),
            "diffusers": DiffusionConfig.from_dict(
                data.pop("diffusers", None)),
            "sharding": ShardingConfig.from_dict(data.pop("sharding", None)),
        }
        cfg = cls(**_pick(cls, data), **sub)
        cfg.check_supported()
        return cfg

    def sharding_set(self) -> bool:
        """Whether the config asks for a mesh (``sharding:`` off its
        defaults, or the ``tensor_parallel_size`` alias)."""
        return self.sharding != ShardingConfig()

    def check_supported(self) -> None:
        """Raise for config that asks for what the port cannot serve yet."""
        quant = self.engine.quantization
        if quant and quant not in QUANTIZATIONS:
            raise ValueError(
                f"model {self.name or self.model!r}: quantization {quant!r} "
                f"is not one of {QUANTIZATIONS}")
        if self.engine.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"model {self.name or self.model!r}: kv_dtype "
                f"{self.engine.kv_dtype!r} is not one of {KV_DTYPES}")
        if self.grammar:
            raise ValueError(
                f"model {self.name or self.model!r}: a raw grammar string "
                "(grammar) is not served: the JAX package declares the key "
                "and reads it nowhere, so no constraint could honour it; "
                "use tools or response_format for constrained decoding")
        if self.engine.kv_dtype == "int4" and self.engine.kv_paged is False:
            raise ValueError(
                f"model {self.name or self.model!r}: kv_dtype int4 needs "
                "the paged KV layout (kv_paged: false takes int8)")

    def has_usecase(self, usecase: str) -> bool:
        """Usecase gating: ``known_usecases`` when set, else the guess."""
        if self.known_usecases is not None:
            return usecase in self.known_usecases
        return usecase in self.guess_usecases()

    def guess_usecases(self) -> set[str]:
        """The JAX package's guess, limited to the port's usecases."""
        return self.usecase_heuristic() & set(SERVED_USECASES)

    def usecase_heuristic(self) -> set[str]:
        """The JAX package's guess from the backend name, ``mmproj`` and
        the ``embeddings`` flag (its ``ModelConfig.guess_usecases``)."""
        name = (self.backend or "").lower()
        guessed: set[str] = set()
        if self.embeddings or "embed" in name:
            guessed.add("embeddings")
        if name in LLM_BACKENDS:
            guessed |= {"chat", "completion", "edit", "tokenize"}
            if self.mmproj:
                guessed.add("vision")
        if "diffus" in name or "image" in name:
            guessed.add("image")
        if "whisper" in name:
            guessed.add("transcript")
        if "tts" in name or name == "vits":
            guessed.add("tts")
        if "musicgen" in name or "sound" in name:
            guessed.add("sound_generation")
        if "rerank" in name or self.embeddings:
            # embedding-capable models score query/document pairs
            guessed.add("rerank")
        return guessed

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
