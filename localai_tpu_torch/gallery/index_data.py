"""Shipped model index: a curated multi-family gallery available without
any network-fetched index.

The port's own copy of ``localai_tpu/gallery/index_data.py``: the same
entries (LocalAI's bundled gallery, github.com/mudler/LocalAI/gallery,
in its safetensors-era form), each with its HF safetensors URIs, the
per-family template/stopword config, and the engine family routing
(``backend:``) where the checkpoint isn't an LLM. Zero-egress
environments still list them; the debug presets in ``embedded`` remain
the instant-install path.
"""

from __future__ import annotations

from localai_tpu_torch.gallery.embedded import _SAFETENSOR_SET, _hf_files
from localai_tpu_torch.gallery.models import GalleryModel

_SHARDS = {
    2: [f"model-{i:05d}-of-00002.safetensors" for i in range(1, 3)],
    3: [f"model-{i:05d}-of-00003.safetensors" for i in range(1, 4)],
    4: [f"model-{i:05d}-of-00004.safetensors" for i in range(1, 5)],
    19: [f"model-{i:05d}-of-00019.safetensors" for i in range(1, 20)],
}


def _sharded(n: int) -> list[str]:
    return ["config.json", "tokenizer.json", "tokenizer_config.json",
            "model.safetensors.index.json"] + _SHARDS[n]


def _llm(name: str, repo: str, desc: str, *, ctx: int = 8192,
         files: list[str] | None = None, license: str = "",
         stopwords: list[str] | None = None,
         tags: list[str] | None = None, **cfg_extra) -> GalleryModel:
    cfg = {
        "name": name,
        "model": repo.split("/")[-1],
        "context_size": ctx,
        "template": {"use_tokenizer_template": True},
    }
    if stopwords:
        cfg["stopwords"] = stopwords
    cfg.update(cfg_extra)
    return GalleryModel(
        name=name, description=desc, license=license,
        tags=["text-generation"] + (tags or []),
        files=_hf_files(repo, files or _SAFETENSOR_SET),
        config_file=cfg,
    )


def _family(name: str, repo: str, desc: str, *, backend: str,
            usecases: list[str], files: list[str] | None = None,
            license: str = "", tags: list[str] | None = None,
            **cfg_extra) -> GalleryModel:
    cfg = {
        "name": name,
        "model": repo.split("/")[-1],
        "backend": backend,
        "known_usecases": usecases,
    }
    cfg.update(cfg_extra)
    return GalleryModel(
        name=name, description=desc, license=license, tags=tags or [],
        files=_hf_files(repo, files or _SAFETENSOR_SET),
        config_file=cfg,
    )


_L3_STOP = ["<|eot_id|>"]
_QWEN_STOP = ["<|im_end|>"]
_GEMMA_STOP = ["<end_of_turn>"]

_ENTRIES: list[GalleryModel] = [
    # -- llama family -------------------------------------------------------
    _llm("llama-3.1-8b-instruct", "meta-llama/Llama-3.1-8B-Instruct",
         "Meta Llama 3.1 8B Instruct", ctx=131072, files=_sharded(4),
         license="llama3.1", stopwords=_L3_STOP),
    _llm("llama-3.2-1b-instruct", "meta-llama/Llama-3.2-1B-Instruct",
         "Meta Llama 3.2 1B Instruct", ctx=131072,
         license="llama3.2", stopwords=_L3_STOP),
    _llm("llama-3.2-3b-instruct", "meta-llama/Llama-3.2-3B-Instruct",
         "Meta Llama 3.2 3B Instruct", ctx=131072, files=_sharded(2),
         license="llama3.2", stopwords=_L3_STOP),
    _llm("llama-3-8b-instruct", "meta-llama/Meta-Llama-3-8B-Instruct",
         "Meta Llama 3 8B Instruct", files=_sharded(4),
         license="llama3", stopwords=_L3_STOP),
    _llm("hermes-2-pro-llama-3-8b", "NousResearch/Hermes-2-Pro-Llama-3-8B",
         "Hermes 2 Pro Llama-3 8B — the reference AIO text model",
         license="llama3",
         tags=["function-calling"]),
    _llm("hermes-3-llama-3.1-8b", "NousResearch/Hermes-3-Llama-3.1-8B",
         "Hermes 3 Llama-3.1 8B", ctx=131072, files=_sharded(4),
         license="llama3.1", tags=["function-calling"]),
    _llm("tinyllama-1.1b-chat", "TinyLlama/TinyLlama-1.1B-Chat-v1.0",
         "TinyLlama 1.1B chat", ctx=2048, license="apache-2.0"),
    # -- mistral family -----------------------------------------------------
    _llm("mistral-7b-instruct", "mistralai/Mistral-7B-Instruct-v0.3",
         "Mistral 7B Instruct v0.3", ctx=32768, files=_sharded(3),
         license="apache-2.0"),
    _llm("mistral-nemo-instruct", "mistralai/Mistral-Nemo-Instruct-2407",
         "Mistral Nemo 12B Instruct", ctx=131072, files=_sharded(4),
         license="apache-2.0"),
    _llm("zephyr-7b-beta", "HuggingFaceH4/zephyr-7b-beta",
         "Zephyr 7B beta (Mistral fine-tune)", ctx=32768,
         files=_sharded(4), license="mit"),
    _llm("openhermes-2.5-mistral-7b", "teknium/OpenHermes-2.5-Mistral-7B",
         "OpenHermes 2.5 Mistral 7B", ctx=32768, files=_sharded(2),
         license="apache-2.0"),
    _llm("mixtral-8x7b-instruct", "mistralai/Mixtral-8x7B-Instruct-v0.1",
         "Mixtral 8x7B sparse MoE instruct (8 experts, top-2 routing; "
         "expert-sharded over the 'expert' mesh axis)",
         ctx=32768, files=_sharded(19), license="apache-2.0",
         tags=["moe"],
         sharding={"expert_parallel_size": 8}),
    # -- qwen family --------------------------------------------------------
    _llm("qwen2.5-0.5b-instruct", "Qwen/Qwen2.5-0.5B-Instruct",
         "Qwen 2.5 0.5B Instruct", ctx=32768, license="apache-2.0",
         stopwords=_QWEN_STOP),
    _llm("qwen2.5-1.5b-instruct", "Qwen/Qwen2.5-1.5B-Instruct",
         "Qwen 2.5 1.5B Instruct", ctx=32768, license="apache-2.0",
         stopwords=_QWEN_STOP),
    _llm("qwen2.5-7b-instruct", "Qwen/Qwen2.5-7B-Instruct",
         "Qwen 2.5 7B Instruct", ctx=131072, files=_sharded(4),
         license="apache-2.0", stopwords=_QWEN_STOP),
    _llm("qwen2.5-coder-7b-instruct", "Qwen/Qwen2.5-Coder-7B-Instruct",
         "Qwen 2.5 Coder 7B", ctx=131072, files=_sharded(4),
         license="apache-2.0", stopwords=_QWEN_STOP, tags=["code"]),
    # -- gemma family -------------------------------------------------------
    _llm("gemma-2-2b-it", "google/gemma-2-2b-it",
         "Gemma 2 2B instruction-tuned", ctx=8192, files=_sharded(2),
         license="gemma", stopwords=_GEMMA_STOP),
    _llm("gemma-2-9b-it", "google/gemma-2-9b-it",
         "Gemma 2 9B instruction-tuned", ctx=8192, files=_sharded(4),
         license="gemma", stopwords=_GEMMA_STOP),
    # -- phi family ---------------------------------------------------------
    _llm("phi-3.5-mini-instruct", "microsoft/Phi-3.5-mini-instruct",
         "Phi 3.5 mini 3.8B", ctx=131072, files=_sharded(2),
         license="mit", stopwords=["<|end|>"]),
    _llm("phi-2", "microsoft/phi-2", "Phi-2 2.7B base", ctx=2048,
         files=_sharded(2), license="mit"),
    # -- smol / misc --------------------------------------------------------
    _llm("smollm2-1.7b-instruct", "HuggingFaceTB/SmolLM2-1.7B-Instruct",
         "SmolLM2 1.7B Instruct", ctx=8192, license="apache-2.0",
         stopwords=_QWEN_STOP),
    _llm("stablelm-2-1.6b-chat", "stabilityai/stablelm-2-1_6b-chat",
         "StableLM 2 1.6B chat", ctx=4096, license="stabilityai"),
    # -- vision (llava-class) ----------------------------------------------
    _llm("llava-1.5-7b", "llava-hf/llava-1.5-7b-hf",
         "LLaVA 1.5 7B — vision chat", ctx=4096, files=_sharded(3),
         license="llama2", tags=["multimodal", "vision"],
         known_usecases=["chat", "vision"]),
    _llm("llava-1.6-mistral-7b", "llava-hf/llava-v1.6-mistral-7b-hf",
         "LLaVA 1.6 Mistral 7B — vision chat", ctx=32768,
         files=_sharded(4), license="apache-2.0",
         tags=["multimodal", "vision"],
         known_usecases=["chat", "vision"]),
    # -- embeddings (bert / sentence-transformers) -------------------------
    _family("all-minilm-l6-v2", "sentence-transformers/all-MiniLM-L6-v2",
            "MiniLM L6 sentence embeddings — the reference AIO embeddings "
            "model", backend="bert-embeddings", usecases=["embeddings"],
            license="apache-2.0", tags=["embeddings"]),
    _family("bge-small-en-v1.5", "BAAI/bge-small-en-v1.5",
            "BGE small English embeddings", backend="bert-embeddings",
            usecases=["embeddings"], license="mit", tags=["embeddings"]),
    _family("bge-base-en-v1.5", "BAAI/bge-base-en-v1.5",
            "BGE base English embeddings", backend="bert-embeddings",
            usecases=["embeddings"], license="mit", tags=["embeddings"]),
    _family("multilingual-e5-small", "intfloat/multilingual-e5-small",
            "E5 small multilingual embeddings",
            backend="bert-embeddings", usecases=["embeddings"],
            license="mit", tags=["embeddings"]),
    # -- rerankers (cross-encoders) ----------------------------------------
    _family("ms-marco-minilm-l6", "cross-encoder/ms-marco-MiniLM-L-6-v2",
            "MS MARCO MiniLM cross-encoder — the reference AIO reranker",
            backend="reranker", usecases=["rerank"],
            license="apache-2.0", tags=["rerank"]),
    _family("bge-reranker-base", "BAAI/bge-reranker-base",
            "BGE reranker base cross-encoder", backend="reranker",
            usecases=["rerank"], license="mit", tags=["rerank"]),
    # -- whisper (speech-to-text) ------------------------------------------
    _family("whisper-tiny", "openai/whisper-tiny",
            "Whisper tiny STT", backend="whisper",
            usecases=["transcript"], license="apache-2.0",
            tags=["audio"]),
    _family("whisper-base", "openai/whisper-base",
            "Whisper base STT — the reference AIO transcription model",
            backend="whisper", usecases=["transcript"],
            license="apache-2.0", tags=["audio"]),
    _family("whisper-small", "openai/whisper-small",
            "Whisper small STT", backend="whisper",
            usecases=["transcript"], license="apache-2.0",
            tags=["audio"]),
    _family("whisper-large-v3-turbo", "openai/whisper-large-v3-turbo",
            "Whisper large v3 turbo STT", backend="whisper",
            usecases=["transcript"], license="apache-2.0",
            tags=["audio"], files=_sharded(2)),
    # -- recurrent-state families (mamba / rwkv) ---------------------------
    _family("mamba-130m", "state-spaces/mamba-130m-hf",
            "Mamba 130M (selective state space LM)", backend="mamba",
            usecases=["chat", "completion"], license="apache-2.0",
            files=["config.json", "tokenizer.json",
                   "tokenizer_config.json", "model.safetensors"]),
    _family("mamba-2.8b", "state-spaces/mamba-2.8b-hf",
            "Mamba 2.8B (selective state space LM)", backend="mamba",
            usecases=["chat", "completion"], license="apache-2.0",
            files=_sharded(3)),
    _family("rwkv-4-pile-169m", "RWKV/rwkv-4-169m-pile",
            "RWKV-4 169M (linear attention LM)", backend="rwkv",
            usecases=["chat", "completion"], license="apache-2.0",
            files=["config.json", "tokenizer.json",
                   "tokenizer_config.json", "model.safetensors"]),
    # -- vits (neural text-to-speech) --------------------------------------
    _family("mms-tts-eng", "facebook/mms-tts-eng",
            "MMS English VITS voice (neural TTS)",
            backend="vits", usecases=["tts"], license="cc-by-nc-4.0",
            tags=["audio", "tts"],
            files=["config.json", "model.safetensors", "vocab.json"]),
    _family("mms-tts-deu", "facebook/mms-tts-deu",
            "MMS German VITS voice (neural TTS)",
            backend="vits", usecases=["tts"], license="cc-by-nc-4.0",
            tags=["audio", "tts"],
            files=["config.json", "model.safetensors", "vocab.json"]),
    _family("vits-ljs", "kakao-enterprise/vits-ljs",
            "VITS LJSpeech voice (neural TTS, 22.05kHz)",
            backend="vits", usecases=["tts"], license="mit",
            tags=["audio", "tts"],
            files=["config.json", "model.safetensors", "vocab.json"]),
    # -- stable diffusion (image generation) -------------------------------
    GalleryModel(
        name="stable-diffusion-1.5",
        description="Stable Diffusion 1.5 (diffusers layout) — SD-class "
                    "image generation",
        license="creativeml-openrail-m",
        tags=["image-generation"],
        files=[f for sub, names in {
            "unet": ["config.json", "diffusion_pytorch_model.safetensors"],
            "vae": ["config.json", "diffusion_pytorch_model.safetensors"],
            "text_encoder": ["config.json", "model.safetensors"],
            "tokenizer": ["merges.txt", "vocab.json",
                          "tokenizer_config.json"],
        }.items() for f in _hf_files(
            "stable-diffusion-v1-5/stable-diffusion-v1-5",
            [f"{sub}/{n}" for n in names])] + _hf_files(
            "stable-diffusion-v1-5/stable-diffusion-v1-5",
            ["model_index.json"]),
        config_file={
            "name": "stable-diffusion-1.5",
            "model": "stable-diffusion-v1-5",
            "backend": "diffusers",
            "known_usecases": ["image"],
            "diffusers": {"scheduler_type": "k_dpmpp_2m", "steps": 25},
        },
    ),
    GalleryModel(
        name="sdxl-base-1.0",
        description="Stable Diffusion XL base 1.0 (dual text encoders, "
                    "1024px) — diffusers layout",
        license="openrail++",
        tags=["image-generation"],
        files=[f for sub, names in {
            "unet": ["config.json",
                     "diffusion_pytorch_model.safetensors"],
            "vae": ["config.json", "diffusion_pytorch_model.safetensors"],
            "text_encoder": ["config.json", "model.safetensors"],
            "text_encoder_2": ["config.json", "model.safetensors"],
            "tokenizer": ["merges.txt", "vocab.json",
                          "tokenizer_config.json"],
            "tokenizer_2": ["merges.txt", "vocab.json",
                            "tokenizer_config.json"],
        }.items() for f in _hf_files(
            "stabilityai/stable-diffusion-xl-base-1.0",
            [f"{sub}/{n}" for n in names])] + _hf_files(
            "stabilityai/stable-diffusion-xl-base-1.0",
            ["model_index.json"]),
        config_file={
            "name": "sdxl-base-1.0",
            "model": "stable-diffusion-xl-base-1.0",
            "backend": "diffusers",
            "known_usecases": ["image"],
            "diffusers": {"scheduler_type": "euler", "steps": 25},
        },
    ),
    GalleryModel(
        name="flux.1-schnell",
        description="FLUX.1 [schnell] rectified-flow MMDiT (4-step "
                    "distilled; dual CLIP+T5 text encoders) — the "
                    "reference's GPU AIO image default family",
        license="apache-2.0",
        tags=["image-generation", "flux"],
        files=[f for sub, names in {
            "transformer": ["config.json"] + [
                f"diffusion_pytorch_model-0000{i}-of-00003.safetensors"
                for i in (1, 2, 3)],
            "vae": ["config.json", "diffusion_pytorch_model.safetensors"],
            "text_encoder": ["config.json", "model.safetensors"],
            "text_encoder_2": ["config.json"] + [
                f"model-0000{i}-of-00002.safetensors" for i in (1, 2)],
            "tokenizer": ["merges.txt", "vocab.json",
                          "tokenizer_config.json"],
            "tokenizer_2": ["spiece.model", "tokenizer.json",
                            "tokenizer_config.json"],
            # schnell declares use_dynamic_shifting=false + shift=1.0 —
            # without this file the loader would apply dev's dynamic shift
            "scheduler": ["scheduler_config.json"],
        }.items() for f in _hf_files(
            "black-forest-labs/FLUX.1-schnell",
            [f"{sub}/{n}" for n in names])] + _hf_files(
            "black-forest-labs/FLUX.1-schnell", ["model_index.json"]),
        config_file={
            "name": "flux.1-schnell",
            "model": "FLUX.1-schnell",
            "backend": "diffusers",
            "known_usecases": ["image"],
            "diffusers": {"steps": 4, "cfg_scale": 0.0},
        },
    ),
    GalleryModel(
        name="dreamshaper-8",
        description="DreamShaper 8 (SD1.5 fine-tune) — the reference AIO "
                    "image model family",
        license="creativeml-openrail-m",
        tags=["image-generation"],
        files=_hf_files("Lykon/dreamshaper-8", ["model_index.json"]),
        config_file={
            "name": "dreamshaper-8",
            "model": "dreamshaper-8",
            "backend": "diffusers",
            "known_usecases": ["image"],
            "diffusers": {"scheduler_type": "k_dpmpp_2m", "steps": 25},
        },
    ),
]


def shipped_index() -> list[GalleryModel]:
    """The shipped gallery entries (name-keyed copies)."""
    return [m.model_copy(deep=True) for m in _ENTRIES]


SHIPPED_MODELS: dict[str, GalleryModel] = {m.name: m for m in _ENTRIES}
