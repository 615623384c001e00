"""Embedded model short-name library.

The port's own copy of ``localai_tpu/gallery/embedded.py``: short names
resolvable without any configured gallery (LocalAI's embedded model
library), so ``run debug-tiny`` style preloading works. Entries are
GalleryModel definitions: debug presets install instantly (no downloads,
synthetic weights), HF entries carry the real safetensors URIs for
networked deployments.
"""

from __future__ import annotations

from localai_tpu_torch.gallery.models import GalleryFile, GalleryModel


def _hf_files(repo: str, files: list[str]) -> list[GalleryFile]:
    owner_repo = repo
    name = repo.split("/")[-1]
    return [
        GalleryFile(
            filename=f"{name}/{f}",
            uri=f"huggingface://{owner_repo}/{f}",
        )
        for f in files
    ]


_SAFETENSOR_SET = ["config.json", "tokenizer.json", "tokenizer_config.json",
                   "model.safetensors"]

EMBEDDED_MODELS: dict[str, GalleryModel] = {
    # instant, offline-safe models (synthetic weights)
    "debug-tiny": GalleryModel(
        name="debug-tiny",
        description="tiny byte-level debug model (synthetic weights)",
        config_file={
            "name": "debug-tiny",
            "model": "debug:tiny",
            "context_size": 1024,
            "embeddings": True,
            "engine": {"max_slots": 4, "prefill_buckets": [128]},
        },
    ),
    "debug-1b": GalleryModel(
        name="debug-1b",
        description="Llama-3.2-1B-class debug model (synthetic weights)",
        config_file={
            "name": "debug-1b",
            "model": "debug:1b",
            "context_size": 8192,
            "engine": {"max_slots": 8, "prefill_buckets": [128, 512, 2048]},
        },
    ),
    # real checkpoints (networked environments)
    "llama-3-8b-instruct": GalleryModel(
        name="llama-3-8b-instruct",
        license="llama3",
        description="Meta Llama 3 8B Instruct (bf16 safetensors)",
        files=_hf_files("meta-llama/Meta-Llama-3-8B-Instruct",
                        ["config.json", "tokenizer.json",
                         "tokenizer_config.json",
                         "model-00001-of-00004.safetensors",
                         "model-00002-of-00004.safetensors",
                         "model-00003-of-00004.safetensors",
                         "model-00004-of-00004.safetensors",
                         "model.safetensors.index.json"]),
        config_file={
            "name": "llama-3-8b-instruct",
            "model": "Meta-Llama-3-8B-Instruct",
            "context_size": 8192,
            "template": {"use_tokenizer_template": True},
            "stopwords": ["<|eot_id|>"],
        },
    ),
    "hermes-2-pro-llama-3-8b": GalleryModel(
        name="hermes-2-pro-llama-3-8b",
        license="llama3",
        description="Hermes 2 Pro Llama-3 8B — the reference AIO text model "
                    "(aio/cpu/text-to-text.yaml), safetensors variant",
        files=_hf_files("NousResearch/Hermes-2-Pro-Llama-3-8B",
                        _SAFETENSOR_SET),
        config_file={
            "name": "hermes-2-pro-llama-3-8b",
            "model": "Hermes-2-Pro-Llama-3-8B",
            "context_size": 8192,
            "template": {"use_tokenizer_template": True},
        },
    ),
    "mistral-7b-instruct": GalleryModel(
        name="mistral-7b-instruct",
        license="apache-2.0",
        description="Mistral 7B Instruct v0.3 (bf16 safetensors)",
        files=_hf_files("mistralai/Mistral-7B-Instruct-v0.3",
                        _SAFETENSOR_SET),
        config_file={
            "name": "mistral-7b-instruct",
            "model": "Mistral-7B-Instruct-v0.3",
            "context_size": 8192,
            "template": {"use_tokenizer_template": True},
        },
    ),
}


def resolve_embedded(name: str) -> GalleryModel | None:
    return EMBEDDED_MODELS.get(name)
