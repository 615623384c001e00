"""The PyTorch port's config autodetection against the JAX package's.

A model YAML that names no backend and no template is completed from its
checkpoint's layout, as on the JAX package (``models/detect.py``,
``config/guesser.py``): the backend from ``config.json``'s
``model_type`` (and, for a bert-class encoder, whether the safetensors
hold a ``classifier.weight``), and for an LLM the checkpoint's own
``tokenizer_config.json`` chat template, or else the family's template
and stopwords. Each tiny checkpoint dir here is written by the test; the
port must set the same ``backend``, ``chat_template`` and ``stopwords``
as ``autodetect_config`` of the JAX package. Every detected backend now
has an engine on the port (diffusers since the image pipeline), so each
such YAML loads with the JAX package's backend.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
st_numpy = pytest.importorskip("safetensors.numpy")

from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.models.detect import autodetect_config as jax_autodetect  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.models.detect import autodetect_config, detect_backend  # noqa: E402
from localai_tpu_torch.models.loader import write_llama_checkpoint  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.models.registry import resolve_model  # noqa: E402

FAMILY_CONFIGS = {
    "llama3": {"model_type": "llama", "eos_token_id": 128009,
               "bos_token_id": 128000},
    "llama3-eos-list": {"model_type": "llama",
                        "eos_token_id": [128009, 128001]},
    "yi-chatml": {"model_type": "llama", "bos_token_id": 1,
                  "eos_token_id": 2},
    "qwen2": {"model_type": "qwen2"},
    "phi3": {"model_type": "phi3"},
    "gemma": {"model_type": "gemma2"},
    "mistral": {"model_type": "mistral"},
    "command-r": {"model_type": "cohere"},
    "deepseek2": {"model_type": "deepseek_v2"},
    "plain-llama": {"model_type": "llama", "eos_token_id": 2},
    "whisper": {"model_type": "whisper"},
    "vits": {"model_type": "vits"},
    "mamba": {"model_type": "mamba"},
    "mamba2": {"model_type": "mamba2"},
    "rwkv": {"model_type": "rwkv"},
    "bert": {"model_type": "bert"},
    "xlm-roberta": {"model_type": "xlm-roberta"},
}
OWN_TEMPLATE = ("{% for m in messages %}<{{ m['role'] }}>{{ m['content'] }}"
                "{% endfor %}{% if add_generation_prompt %}<bot>{% endif %}")


def _checkpoint(root, name, hf, *, own_template=False, classifier=None):
    d = root / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf))
    if own_template:
        (d / "tokenizer_config.json").write_text(json.dumps(
            {"chat_template": OWN_TEMPLATE, "eos_token": "</s>"}))
    if classifier is not None:
        tensors = {"embeddings.weight": np.zeros((4, 2), np.float32)}
        if classifier:
            tensors["classifier.weight"] = np.zeros((1, 2), np.float32)
        st_numpy.save_file(tensors, str(d / "model.safetensors"))
    return d


def _detected(doc, models):
    ours = ModelConfig.from_dict(dict(doc))
    autodetect_config(ours, models)
    ref = JaxModelConfig(**doc)
    jax_autodetect(ref, models)
    return ours, ref


@pytest.mark.parametrize("own_template", [False, True],
                         ids=["family", "own-template"])
@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_autodetection_equals_the_jax_one(tmp_path, family, own_template):
    _checkpoint(tmp_path, "ckpt", FAMILY_CONFIGS[family],
                own_template=own_template)
    for doc in ({"name": family, "model": "ckpt"},
                {"name": family, "model": str(tmp_path / "ckpt")},
                {"name": family, "model": "ckpt", "stopwords": ["<x>"]}):
        ours, ref = _detected(doc, tmp_path)
        assert ours.backend == ref.backend
        assert ours.template.chat_template == ref.template.chat_template
        assert ours.stopwords == ref.stopwords


@pytest.mark.parametrize("classifier,backend", [(True, "reranker"),
                                                (False, "bert-embeddings")])
def test_bert_splits_on_the_classifier_as_on_the_jax_package(
        tmp_path, classifier, backend):
    _checkpoint(tmp_path, "enc", {"model_type": "bert"},
                classifier=classifier)
    ours, ref = _detected({"name": "e", "model": "enc"}, tmp_path)
    assert ours.backend == ref.backend == backend


@pytest.mark.parametrize("ref", ["debug:tiny", "debug:sd-tiny",
                                 "debug:whisper-tiny", "debug:reranker-x",
                                 "debug:bert-tiny", "debug:mamba-tiny",
                                 "debug:rwkv-tiny", "not-downloaded-yet"])
def test_debug_refs_and_missing_dirs_detect_as_on_the_jax_package(tmp_path,
                                                                  ref):
    from localai_tpu.models.detect import detect_backend as jax_detect

    assert detect_backend(ref, tmp_path) == jax_detect(ref, tmp_path)


def test_diffusers_layout_beats_config_json(tmp_path):
    d = _checkpoint(tmp_path, "pipe", {"model_type": "llama"})
    (d / "model_index.json").write_text("{}")
    ours, ref = _detected({"name": "p", "model": "pipe"}, tmp_path)
    assert ours.backend == ref.backend == "diffusers"


def test_explicit_backend_and_templates_are_kept(tmp_path):
    _checkpoint(tmp_path, "ckpt", FAMILY_CONFIGS["llama3"])
    for doc in ({"name": "a", "model": "ckpt", "backend": "jax"},
                {"name": "b", "model": "ckpt",
                 "template": {"chat": "{{.Input}}"}},
                {"name": "c", "model": "ckpt",
                 "template": {"use_tokenizer_template": True}}):
        ours, ref = _detected(doc, tmp_path)
        assert (ours.backend, ours.template.chat_template, ours.stopwords) \
            == (ref.backend, ref.template.chat_template, ref.stopwords)
        assert ours.template.chat_template is None


def _write_yaml(models, name, doc):
    (models / f"{name}.yaml").write_text(yaml.safe_dump(doc))


@pytest.mark.parametrize("family,backend", [
    ("mamba", "mamba"), ("rwkv", "rwkv"), ("whisper", "whisper"),
    ("vits", "vits"), ("bert", "bert-embeddings"),
    ("diffusers", "diffusers")])
def test_detected_unported_backend_is_refused_at_load(tmp_path, family,
                                                      backend):
    """The JAX package routes these checkpoints to another engine. The
    port has the recurrent engine (mamba, rwkv), the sentence encoder
    (bert), the speech engines (whisper, vits) and the image pipeline
    (diffusers) now, so those YAMLs load with the detected backend, as on
    the JAX package (the name is kept from when the port refused some of
    them)."""
    d = _checkpoint(tmp_path, "ckpt",
                    FAMILY_CONFIGS.get(family, {"model_type": "llama"}),
                    classifier=False if family == "bert" else None)
    if family == "diffusers":
        (d / "model_index.json").write_text("{}")
    _write_yaml(tmp_path, "m", {"name": "m", "model": "ckpt"})
    loader = ConfigLoader(tmp_path)
    loader.load_from_path()
    ref = JaxModelConfig(name="m", model="ckpt")
    jax_autodetect(ref, tmp_path)
    assert loader.get("m").backend == ref.backend == backend


def test_undetected_llama_dir_stays_on_the_llama_engine(tmp_path):
    """A real llama checkpoint with no family signal: no backend, no
    guessed template; it loads on the llama engine and serves a chat with
    the role-prefix prompt."""
    tiny = resolve_model("debug:tiny", dtype="float32", device="cpu")
    write_llama_checkpoint(tmp_path / "ckpt", tiny.cfg, tiny.params)
    _write_yaml(tmp_path, "m", {"name": "m", "model": "ckpt",
                                "engine": {"dtype": "float32",
                                           "kv_dtype": "float32",
                                           "max_slots": 2}})
    loader = ConfigLoader(tmp_path)
    loader.load_from_path()
    cfg = loader.get("m")
    assert cfg.backend == "" and cfg.template.chat_template is None
    ref = JaxModelConfig(name="m", model="ckpt")
    jax_autodetect(ref, tmp_path)
    assert ref.backend == "" and ref.template.chat_template is None
    server = APIServer(ModelManager(AppConfig(model_path=str(tmp_path),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    try:
        import urllib.request

        req = urllib.request.Request(
            server.url + "/v1/chat/completions", data=json.dumps({
                "model": "m", "max_tokens": 3, "temperature": 0,
                "messages": [{"role": "user", "content": "hi"}]}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["usage"]["prompt_tokens"] == 3  # BOS + "hi"
    finally:
        server.shutdown()


def test_family_template_reaches_the_chat_prompt(tmp_path):
    """A template-less YAML on a Llama-3-family checkpoint renders the
    Llama-3 prompt and stops at ``<|eot_id|>``, as on the JAX package
    (the port rendered role-prefix text with no stopword)."""
    _checkpoint(tmp_path, "ckpt", FAMILY_CONFIGS["llama3"])
    _write_yaml(tmp_path, "m", {"name": "m", "model": "ckpt"})
    loader = ConfigLoader(tmp_path)
    loader.load_from_path()
    cfg = loader.get("m")
    assert cfg.stopwords == ["<|eot_id|>"]
    from localai_tpu_torch.templates.chat import apply_tokenizer_template

    prompt = apply_tokenizer_template(
        None, [{"role": "user", "content": "hi"}],
        chat_template=cfg.template.chat_template)
    assert prompt == ("<|begin_of_text|><|start_header_id|>user"
                      "<|end_header_id|>\n\nhi<|eot_id|><|start_header_id|>"
                      "assistant<|end_header_id|>\n\n")
