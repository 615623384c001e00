"""Import rules of the PyTorch port.

The port and chip_smoke.py must import nothing of JAX or of the JAX
package, and the port's runtime stands on the standard library, numpy and
torch alone at import time (anything else is imported inside the function
that needs it). Neither imports Jinja2 or PyYAML anywhere, since the
card's machine has neither: a models dir of YAMLs with templates loads,
renders every kind of template and serves with both blocked.
"""

import ast
import dataclasses
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import localai_tpu_torch as port  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PKG_DIR = Path(port.__file__).resolve().parent
PKG = port.__name__
SOURCES = (sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "scripts").glob("*.py")))
# packages the machine with the card does not have
ABSENT_ON_CARD = {"aiohttp", "pydantic", "yaml", "safetensors", "tokenizers",
                  "transformers", "jinja2", "grpc", "ml_dtypes", "PIL",
                  "requests", "httpx"}


def _port_modules() -> list[str]:
    return [PKG] + sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, PKG + "."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where importing jax or the JAX package
    fails, every module of the port and chip_smoke import — and pull in
    no package the card's machine lacks."""
    code = (
        "import json, sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'localai_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch, numpy\n"
        "before = set(sys.modules)\n"
        "for m in json.loads(sys.argv[1]):\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    mods = _port_modules() + ["chip_smoke"]
    res = subprocess.run(
        [sys.executable, "-c", code, json.dumps(mods)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    new = json.loads(res.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in new} & ABSENT_ON_CARD
    assert len(mods) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name
                         if p.parent == REPO else
                         str(p.relative_to(PKG_DIR if PKG_DIR in p.parents
                                           else REPO)))
def test_sources_never_reach_jax(path):
    src = path.read_text()
    assert not re.search(r"\blocalai_tpu\.", src), \
        "refers to a module of the JAX package"
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "localai_tpu"), n


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if PKG_DIR in p.parents],
                         ids=lambda p: str(p.relative_to(PKG_DIR)))
def test_module_level_imports_are_stdlib_numpy_torch(path):
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch", PKG}
    tree = ast.parse(path.read_text())
    for node in tree.body:  # module level only: lazy imports are fine
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in allowed or top == "__future__", top


def test_constrained_decoding_modules_are_covered():
    """The host side of constrained decoding (``functions/``, the C trie
    walk's loader in ``native/``, ``api/inference.py``) is among the
    modules and sources the rules above check."""
    mods = set(_port_modules())
    for m in ("functions", "functions.constraint", "functions.fsm",
              "functions.jsonschema", "functions.parse", "functions.tools",
              "native", "api.inference"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"native/__init__.py", "functions/constraint.py",
            "api/inference.py"} <= rel


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name
                         if p.parent == REPO else
                         str(p.relative_to(PKG_DIR if PKG_DIR in p.parents
                                           else REPO)))
def test_sources_never_import_jinja2_or_yaml(path):
    """Not at module level and not inside a function: the port has its own
    YAML reader and template engine."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        for n in names:
            assert n.split(".")[0] not in ("jinja2", "yaml"), n


def test_vision_and_media_modules_are_covered():
    """The multimodal path (the PNG/JPEG/GIF readers, the bicubic resize,
    media ingestion, the vision tower) is among the modules and sources
    the rules above check."""
    mods = set(_port_modules())
    for m in ("utils.png", "utils.jpeg", "utils.gif", "utils.resample",
              "utils.media", "models.vision"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"utils/png.py", "utils/jpeg.py", "utils/gif.py",
            "utils/media.py", "models/vision.py"} <= rel


def test_encoder_recurrent_and_remote_modules_are_covered():
    """The BERT encoders, the recurrent-state models and their serving
    facade, and the remote-API client are among the modules and sources
    the rules above check: nothing of ``jax`` or ``localai_tpu``, and only
    the stdlib, numpy and torch at module level."""
    mods = set(_port_modules())
    for m in ("models.reranker", "models.mamba", "models.rwkv",
              "models.mamba_serving", "models.hf_api"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"models/reranker.py", "models/mamba.py", "models/rwkv.py",
            "models/mamba_serving.py", "models/hf_api.py"} <= rel


def test_selfextend_and_promptcache_modules_are_covered():
    """Self-extend and the disk prompt cache, the last two modules of the
    JAX package's engine directory, are among the modules and sources the
    rules above check."""
    mods = set(_port_modules())
    for m in ("engine.selfextend", "engine.promptcache"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"engine/selfextend.py", "engine/promptcache.py"} <= rel


def test_audio_modules_are_covered():
    """Speech and sound (wav I/O, the mel frontend, whisper, VITS, the
    speaker encoder, the parametric voice, MusicGen and their routes) are
    among the modules and sources the rules above check: nothing of
    ``jax`` or ``localai_tpu``, and only the stdlib, numpy and torch at
    module level (scipy's resampler is imported inside ``read_wav``)."""
    mods = set(_port_modules())
    for m in ("audio", "audio.wav", "audio.mel", "audio.vits",
              "audio.speaker", "audio.tts", "audio.musicgen",
              "models.whisper", "api.audio"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"audio/wav.py", "audio/mel.py", "audio/vits.py",
            "audio/speaker.py", "audio/tts.py", "audio/musicgen.py",
            "models/whisper.py", "api/audio.py"} <= rel


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.parent != REPO / "scripts"],
                         ids=lambda p: p.name if p.parent == REPO else
                         str(p.relative_to(PKG_DIR)))
def test_sources_never_import_pil(path):
    """Not at module level and not inside a function: the card's machine
    has no PIL, so the port decodes and resizes images itself (the
    fixture generator under scripts/ is the one user of PIL)."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] != "PIL", n


BLOCKED_SERVE = r"""
import importlib, json, sys, tempfile
pkg, ref = sys.argv[1], sys.argv[2]
for name in ("jinja2", "yaml", "jax", ref):
    sys.modules[name] = None
import chip_smoke
oa = importlib.import_module(pkg + ".api.openai")
AppConfig = importlib.import_module(pkg + ".config.app_config").AppConfig
ConfigLoader = importlib.import_module(pkg + ".config.loader").ConfigLoader
ModelManager = importlib.import_module(pkg + ".models.manager").ModelManager

small = lambda text: (text.replace("debug:llama3-8b", "debug:tiny")
                      .replace("bfloat16", "float32")
                      .replace("context_size: 4096", "context_size: 512"))
models = tempfile.mkdtemp()
chip_smoke.write_models_dir(models, {
    chip_smoke.TEMPLATED: small(chip_smoke.TEMPLATED_YAML),
    chip_smoke.CHAT_TEMPLATED: small(chip_smoke.CHAT_TEMPLATE_YAML)})
loader = ConfigLoader(models)
loader.load_from_path()
manager = ModelManager(AppConfig(model_path=models, device="cpu"), loader)
seen = []
for name in loader.names():
    sm = manager.get(name)
    submit = sm.scheduler.submit
    sm.scheduler.submit = (lambda req, _s=submit:
                           seen.append(list(req.prompt)) or _s(req))
out = {}
for i in (0, 2, 3):  # chat_message + chat, functions, chat_template
    body = dict(chip_smoke.TEMPLATED_CHATS[i], max_tokens=2)
    if i == 2:  # keep the tools prompt inside debug:tiny's context
        body["tools"] = body["tools"][1:]
    out[f"chat{i}"] = oa.chat(manager, body)["choices"][0]["message"]
out["completion"] = oa.completions(manager, dict(
    chip_smoke.TEMPLATED_COMPLETION, max_tokens=2))["choices"][0]["text"]
out["edit"] = oa.edits(manager, dict(chip_smoke.TEMPLATED_EDIT,
                                     max_tokens=2))["object"]
manager.shutdown()
tok = sm.tokenizer
golden = [tok.encode(chip_smoke.TEMPLATED_GOLDEN[i], add_bos=True)
          for i in (0, 3)]
print(json.dumps({"served": sorted(out), "prompts": len(seen),
                  "golden_seen": all(g in seen for g in golden),
                  "blocked": [m for m in ("jinja2", "yaml")
                              if sys.modules.get(m) is not None]}))
"""


def test_templated_models_serve_without_jinja2_and_yaml():
    """In a fresh interpreter where importing Jinja2, PyYAML, JAX or the
    JAX package fails: a models dir of YAMLs with Go templates in block
    scalars and a Jinja chat_template loads, and chats (message + chat,
    functions, chat_template), a completion and an edit are served on the
    CPU with their golden prompts."""
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_SERVE, PKG, PKG.rsplit("_", 1)[0]],
        cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"served": ["chat0", "chat2", "chat3", "completion",
                              "edit"],
                   "prompts": 3 + 4 + 1, "golden_seen": True,
                   "blocked": []}


def test_hf_tokenizer_needs_a_package_the_card_lacks(tmp_path):
    """ROADMAP §C 7, repaired: a checkpoint's ``tokenizer.json`` is read by
    the port's own reader, so in a fresh interpreter where importing
    ``tokenizers`` and ``transformers`` fails (as on the card's machine)
    a ``tokenizer.json`` directory loads and encodes Llama-3's special
    tokens as single ids, and neither package is imported; a directory
    with neither file still gets the byte tokenizer."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    chip_smoke.write_llama3_tokenizer(tmp_path)
    code = (
        "import sys, json\n"
        "for name in ('tokenizers', 'transformers'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        "tok = importlib.import_module(sys.argv[1] + '.utils.tokenizer')\n"
        "bare = tok.load_tokenizer(sys.argv[3])\n"
        "t = tok.load_tokenizer(sys.argv[2])\n"
        "ids = t.encode('<|begin_of_text|>hi<|eot_id|>')\n"
        "print(json.dumps([type(bare).__name__, type(t).__name__,\n"
        "                  t.vocab_size, ids[0], ids[-1],\n"
        "                  t.decode(ids),\n"
        "                  [m for m in ('tokenizers', 'transformers')\n"
        "                   if sys.modules.get(m) is not None]]))\n"
    )
    (tmp_path / "bare").mkdir()
    res = subprocess.run(
        [sys.executable, "-c", code, PKG, str(tmp_path),
         str(tmp_path / "bare")], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [
        "ByteTokenizer", "HFTokenizer", 128256, 128000, 128009,
        "<|begin_of_text|>hi<|eot_id|>", []]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name
                         if p.parent == REPO else
                         str(p.relative_to(PKG_DIR if PKG_DIR in p.parents
                                           else REPO)))
def test_sources_never_import_tokenizers_or_transformers(path):
    """Not at module level and not inside a function: the port reads
    ``tokenizer.json`` itself (``utils/hf_tokenizer.py``), and no module
    of its own is named ``tokenizers``."""
    assert path.stem not in ("tokenizers", "transformers")
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        for n in names:
            assert n.split(".")[0] not in ("tokenizers", "transformers"), n


def test_image_modules_are_covered():
    """The image pipeline (samplers, CLIP, UNet, VAE, ControlNet, LoRA,
    the diffusers loader, the pipeline, the image routes, the PNG
    encoder) is among the modules and sources the rules above check."""
    mods = set(_port_modules())
    for m in ("image", "image.schedulers", "image.clip", "image.unet",
              "image.vae", "image.controlnet", "image.lora", "image.loader",
              "image.pipeline", "api.images", "utils.png"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"image/unet.py", "image/loader.py", "image/lora.py",
            "image/pipeline.py", "api/images.py"} <= rel


def test_flux_modules_are_covered():
    """FLUX (T5, the MMDiT, the pipeline) and SentencePiece's formats
    (``utils/spm.py``) are among the modules and sources the rules above
    check."""
    mods = set(_port_modules())
    for m in ("image.t5", "image.mmdit", "image.flux", "utils.spm"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"image/t5.py", "image/mmdit.py", "image/flux.py",
            "utils/spm.py"} <= rel


def test_sentencepiece_model_needs_no_package_the_card_lacks(tmp_path):
    """ROADMAP §C 11's Unigram half: in a fresh interpreter where
    importing ``tokenizers``, ``transformers``, ``sentencepiece`` and
    ``google.protobuf`` fails (as on the card's machine), a T5 directory
    with ``spiece.model`` and ``tokenizer_config.json`` loads and
    encodes, and none of them is imported."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from localai_tpu_torch.utils import spm

    spec = chip_smoke.t5_unigram_spec(300, 5)
    pieces = [spm.Piece(p, s, spm.CONTROL if p in ("<pad>", "</s>")
                        else spm.UNKNOWN if p == "<unk>" else spm.NORMAL)
              for p, s in spec["model"]["vocab"][:300]]
    (tmp_path / "spiece.model").write_bytes(_model_proto(
        pieces, spm.charsmap_bytes({"ｆ": "f"})))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5Tokenizer", "extra_ids": 5}))
    blocked = ("tokenizers", "transformers", "sentencepiece", "google",
               "google.protobuf")
    code = (
        "import sys, json, importlib\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "tok = importlib.import_module(sys.argv[1] + '.utils.tokenizer')\n"
        "t = tok.load_tokenizer(sys.argv[2])\n"
        "ids = t.encode('ｆast caches </s>')\n"
        "print(json.dumps([type(t).__name__, t.vocab_size, ids[-1],\n"
        "                  t.decode(ids)]))\n")
    res = subprocess.run(
        [sys.executable, "-c", code, PKG, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    name, size, last, text = json.loads(res.stdout.strip().splitlines()[-1])
    assert (name, size, last) == ("HFTokenizer", 305, 1)
    assert text == "fast caches</s>"


def _model_proto(pieces, charsmap: bytes) -> bytes:
    """A Unigram ``ModelProto`` (unk id 2) in protobuf's wire format,
    written by hand."""
    import struct

    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num: int, wt: int, payload) -> bytes:
        if wt == 0:
            return varint(num << 3) + varint(payload)
        if wt == 5:
            return varint(num << 3 | 5) + payload
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    data = b""
    for p in pieces:
        data += field(1, 2, field(1, 2, p.piece.encode())
                      + field(2, 5, struct.pack("<f", p.score))
                      + field(3, 0, p.type))
    data += field(2, 2, field(3, 0, 1) + field(40, 0, 2))
    data += field(3, 2, field(2, 2, charsmap))
    return data


def test_faults_and_batch_modules_are_covered():
    """Self-healing and the batch lane (the fault registry, the
    supervisor, the file and job stores, the executor, the files and
    batches routes) are among the modules and sources the rules above
    check: nothing of ``jax`` or the JAX package (no pydantic for the
    executor's line validation), only the stdlib, numpy and torch at
    module level."""
    mods = set(_port_modules())
    for m in ("faults", "faults.registry", "faults.supervisor", "batch",
              "batch.store", "batch.executor", "api.batches",
              "api.assistants"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"faults/__init__.py", "faults/registry.py",
            "faults/supervisor.py", "batch/__init__.py", "batch/store.py",
            "batch/executor.py", "api/batches.py",
            "api/assistants.py"} <= rel


BLOCKED_IMAGE = r"""
import base64, importlib, json, sys
pkg, ref, root = sys.argv[1], sys.argv[2], sys.argv[3]
LACKING = ("PIL", "safetensors", "transformers", "tokenizers", "ml_dtypes",
           "jax", ref)
for name in LACKING:
    sys.modules[name] = None
images = importlib.import_module(pkg + ".api.images")
png = importlib.import_module(pkg + ".utils.png")
AppConfig = importlib.import_module(pkg + ".config.app_config").AppConfig
ConfigLoader = importlib.import_module(pkg + ".config.loader").ConfigLoader
ModelManager = importlib.import_module(pkg + ".models.manager").ModelManager
loader = ConfigLoader(root + "/models")
loader.load_from_path()
manager = ModelManager(AppConfig(model_path=root + "/models", device="cpu",
                                 image_path=root + "/images"), loader)
edge = base64.b64encode(png.encode(
    __import__("numpy").full((40, 40, 3), 200, "uint8"))).decode()
sizes = []
for name, extra in (("sd-lora", {}), ("sd-cn", {"file": edge})):
    out = images.generations(manager, {
        "model": name, "prompt": "a cat|dog", "size": "64x64", "step": 2,
        "seed": 1, "response_format": "b64_json", **extra})
    sizes.append(png.decode(base64.b64decode(
        out["data"][0]["b64_json"])).shape)
sm = manager.get_image("sd-cn")
print(json.dumps({"sizes": sizes,
                  "tokenizer": type(sm.pipeline.tokenizer).__name__,
                  "controlnet": sm.pipeline.controlnet_params is not None,
                  "imported": [m for m in LACKING
                               if sys.modules.get(m) is not None]}))
manager.shutdown()
"""


def test_image_models_serve_without_the_packages_the_card_lacks(tmp_path):
    """In a fresh interpreter where PIL, safetensors, transformers,
    tokenizers, ml_dtypes, JAX and the JAX package cannot be imported:
    a diffusers directory with a CLIP tokenizer (vocab.json + merges.txt)
    loads with a kohya LoRA merged, and another YAML over it attaches a
    ControlNet; both answer /v1/images/generations with a PNG (the
    control image given as base64)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from localai_tpu_torch.image import controlnet as tcn
    from localai_tpu_torch.image import loader as tload
    from localai_tpu_torch.models.loader import write_safetensors

    cfgs = chip_smoke._image_layouts()["sd1"]
    cfgs = {k: dataclasses.replace(v, dtype="bfloat16")
            for k, v in cfgs.items()}
    # a CLIP-format vocabulary holds the 512 byte symbols and two specials
    cfgs["text"] = dataclasses.replace(cfgs["text"], vocab_size=600,
                                       eos_token_id=599)
    from localai_tpu_torch.image import clip as tclip
    from localai_tpu_torch.image import unet as tunet
    from localai_tpu_torch.image import vae as tvae

    ckpt = tmp_path / "sd"
    tload.write_diffusers_pipeline(
        ckpt, unet=(cfgs["unet"], tunet.init_params(cfgs["unet"], 1, "cpu")),
        vae=(cfgs["vae"], tvae.init_params(cfgs["vae"], 2, "cpu")),
        text=(cfgs["text"], tclip.init_params(cfgs["text"], 3, "cpu")),
        dtype="bfloat16")
    size = chip_smoke.CLIP_VOCAB
    try:
        chip_smoke.CLIP_VOCAB = cfgs["text"].vocab_size
        chip_smoke.write_clip_tokenizer(ckpt / "tokenizer")
    finally:
        chip_smoke.CLIP_VOCAB = size
    write_safetensors(tmp_path / "lora.safetensors",
                      chip_smoke._lora_tensors(cfgs["unet"], cfgs["text"],
                                               rank=2))
    tload.write_controlnet(tmp_path / "cn", cfgs["unet"], tcn.init_params(
        cfgs["unet"], 4, "cpu", cond_channels=(8, 16)))
    models = tmp_path / "models"
    chip_smoke.write_models_dir(models, {
        "sd-lora": (f"name: sd-lora\nbackend: diffusers\nmodel: {ckpt}\n"
                    f"lora_adapter: {tmp_path / 'lora.safetensors'}\n"),
        "sd-cn": (f"name: sd-cn\nbackend: diffusers\nmodel: {ckpt}\n"
                  f"diffusers:\n  control_net: {tmp_path / 'cn'}\n")})
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMAGE, PKG, PKG.rsplit("_", 1)[0],
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "sizes": [[64, 64, 3]] * 2, "tokenizer": "ClipTokenizer",
        "controlnet": True, "imported": []}


def test_tuning_store_and_gallery_modules_are_covered():
    """The tuning table and its sweep, the vector store and the gallery
    (with its downloader and registry client on ``urllib``) are among the
    modules and sources the rules above check: nothing of ``jax`` or
    ``localai_tpu``, only the stdlib, numpy and torch at module level, and
    no ``requests``, ``pydantic``, ``yaml`` or ``aiohttp`` anywhere."""
    mods = set(_port_modules())
    new = ("ops.tuning", "tools", "tools.autotune", "stores", "stores.store",
           "api.stores", "api.gallery", "gallery", "gallery.models",
           "gallery.embedded", "gallery.index_data", "gallery.index",
           "gallery.service", "utils.downloader", "utils.oci")
    for m in new:
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    files = {m.replace(".", "/") + ".py" for m in new
             if m not in ("tools", "stores", "gallery")}
    assert files <= rel
    for path in (PKG_DIR / f for f in files):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "requests", "pydantic", "yaml", "aiohttp", "httpx"), \
                    (path.name, n)


def test_web_ui_openapi_and_federation_modules_are_covered():
    """The web UI, the OpenAPI document, the SSE helpers, the assistants
    and the federation router and explorer are among the modules and
    sources the rules above check: nothing of ``jax`` or the JAX
    package, only the stdlib, numpy and torch at module level, and no
    ``aiohttp``, ``jinja2``, ``httpx`` or ``requests`` anywhere (the
    pages are strings, the router stands on ``http.server`` and
    ``http.client``)."""
    mods = set(_port_modules())
    new = ("api.streams", "api.ui", "api.openapi", "api.assistants",
           "federation", "federation.server", "federation.explorer")
    for m in new:
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    files = {"api/streams.py", "api/ui.py", "api/openapi.py",
             "api/assistants.py", "federation/__init__.py",
             "federation/server.py", "federation/explorer.py"}
    assert files <= rel
    for path in (PKG_DIR / f for f in files):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "aiohttp", "jinja2", "httpx", "requests", "pydantic",
                    "yaml"), (path.name, n)


BLOCKED_HTTP = r"""
import importlib, json, sys, urllib.request
pkg, ref, root = sys.argv[1], sys.argv[2], sys.argv[3]
LACKING = ("aiohttp", "jinja2", "httpx", "requests", "pydantic", "yaml",
           "jax", ref)
for name in LACKING:
    sys.modules[name] = None
server = importlib.import_module(pkg + ".api.server")
fed = importlib.import_module(pkg + ".federation")
explorer = importlib.import_module(pkg + ".federation.explorer")
AppConfig = importlib.import_module(pkg + ".config.app_config").AppConfig
ConfigLoader = importlib.import_module(pkg + ".config.loader").ConfigLoader
ModelManager = importlib.import_module(pkg + ".models.manager").ModelManager
loader = ConfigLoader(root + "/models")
loader.load_from_path()
app = AppConfig(model_path=root + "/models", device="cpu",
                config_path=root + "/conf", upload_path=root + "/up")
srv = server.APIServer(ModelManager(app, loader), "127.0.0.1", 0).start()
router = fed.FederatedServer(["127.0.0.1:%d" % srv.port],
                             health_interval=3600).start()
ex = explorer.ExplorerServer(router.url, interval=3600).start()
out = {}
for base, path in ((srv.url, "/chat/"), (srv.url, "/swagger/doc.json"),
                   (router.url, "/swarm"), (router.url, "/federated/nodes"),
                   (ex.url, "/"), (ex.url, "/api/nodes")):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        out[path] = [r.status, r.headers["Content-Type"].split(";")[0]]
ex.shutdown()
router.shutdown()
srv.shutdown()
out["imported"] = [m for m in LACKING if sys.modules.get(m) is not None]
print(json.dumps(out))
"""


def test_ui_and_federation_serve_without_the_packages_the_card_lacks(
        tmp_path):
    """In a fresh interpreter where aiohttp, Jinja2, httpx, requests,
    pydantic, PyYAML, JAX and the JAX package cannot be imported, the
    port's server answers a web UI page and its OpenAPI document, its
    router proxies a page and lists its nodes, and the explorer renders
    its dashboard and the router's nodes."""
    models = tmp_path / "models"
    models.mkdir()
    (models / "tiny.yaml").write_text(json.dumps({
        "name": "tiny", "model": "debug:tiny",
        "engine": {"dtype": "float32", "kv_dtype": "float32"}}))
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_HTTP, PKG, PKG.removesuffix("_torch"),
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {
        "/chat/": [200, "text/html"],
        "/swagger/doc.json": [200, "application/json"],
        "/swarm": [200, "text/html"],
        "/federated/nodes": [200, "application/json"],
        "/": [200, "text/html"], "/api/nodes": [200, "application/json"],
        "imported": []}


def test_worker_tier_modules_are_covered():
    """The worker tier (its messages, transport, client, process manager,
    servicers, worker-backed serving and device pinning) is among the
    modules and sources the rules above check, and no module of the port's
    ``worker/`` imports ``grpc``, ``google.protobuf`` or ``yaml``
    anywhere: the card's machine has none of them."""
    mods = set(_port_modules())
    new = ("worker.backend_pb2", "worker.rpc", "worker.client",
           "worker.process", "worker.server", "worker.serving",
           "fleet.pinning")
    for m in new:
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {f"{m.replace('.', '/')}.py" for m in new} <= rel
    for path in sorted((PKG_DIR / "worker").glob("*.py")) + [
            PKG_DIR / "fleet" / "pinning.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert not n.startswith(("grpc", "google", "yaml")), \
                    (path.name, n)


BLOCKED_WORKER = r"""
import importlib, json, sys
pkg, ref = sys.argv[1], sys.argv[2]
LACKING = ("grpc", "google", "google.protobuf", "yaml", "jax", ref)
for name in LACKING:
    sys.modules[name] = None
server = importlib.import_module(pkg + ".worker.server")
client_mod = importlib.import_module(pkg + ".worker.client")
pb = importlib.import_module(pkg + ".worker.backend_pb2")
serving = importlib.import_module(pkg + ".worker.serving")
ModelConfig = importlib.import_module(
    pkg + ".config.model_config").ModelConfig
out = {}
srvs, clients = [], []
for _ in range(2):
    srv, port = server.serve_worker("127.0.0.1:0", block=False)
    c = client_mod.WorkerClient("127.0.0.1:%d" % port)
    doc = serving.config_yaml(ModelConfig.from_dict({
        "name": "tiny", "model": "debug:tiny",
        "engine": {"dtype": "float32", "kv_dtype": "float32"}}))
    out.setdefault("load", []).append(c.load_model(config_yaml=doc).success)
    srvs.append(srv)
    clients.append(c)
opts = pb.PredictOptions(tokens=list(range(1, 40)), max_tokens=4,
                         temperature=0.0)
frames = list(clients[0].predict_stream(opts))
out["final"] = [frames[-1].tokens, frames[-1].finish_reason]
chunks = list(clients[0].prefill_prefix(opts))
out["transfer"] = clients[1].transfer_prefix(iter(chunks)).success
for srv in srvs:
    srv.stop(0).wait(5)
out["imported"] = [m for m in LACKING if sys.modules.get(m) is not None]
print(json.dumps(out))
"""


def test_worker_serves_without_the_packages_the_card_lacks():
    """In a fresh interpreter where grpcio, protobuf, PyYAML, JAX and the
    JAX package cannot be imported, two port workers load a model from
    the YAML the serving instance writes, stream a generation and hand a
    prefix from one to the other."""
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_WORKER, PKG,
         PKG.removesuffix("_torch")], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), "LOCALAI_DEVICE": "cpu"})
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"load": [True, True], "final": [4, "length"],
                   "transfer": True, "imported": []}


def test_parallel_modules_are_covered():
    """The tensor-parallel package (mesh, sharding, overlap, multihost) is
    among the modules and sources the rules above check: no ``jax`` and
    no JAX package anywhere in it, nothing beyond the stdlib, numpy and
    torch (``torch.distributed`` is torch) at module level."""
    mods = set(_port_modules())
    new = ("parallel", "parallel.mesh", "parallel.sharding",
           "parallel.overlap", "parallel.multihost")
    for m in new:
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {f"{m.replace('.', '/')}.py" for m in new[1:]} <= rel
    for path in sorted((PKG_DIR / "parallel").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "localai_tpu"), \
                    (path.name, n)
