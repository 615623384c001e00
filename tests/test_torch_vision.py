"""The PyTorch port's vision tower and multimodal prefill against the JAX
package's, on the CPU.

The JAX package's tower weights (seeded, float32, every leaf perturbed so
biases and gains are not trivial) are carried across with
``utils.device.params_from_numpy``. Held equal: ``preprocess`` (PIL's
bicubic against the port's) and ``patchify``; the tower's ``forward``
within 1e-5 at the ``vit`` preset and at a wider one (head dim 64,
``feature_layer`` -2, tanh GELU); a llava checkpoint in both tensor
layouts (the classic ``language_model.model.*`` and transformers >= 4.52's
``model.language_model.*``) loading the same tower and language weights;
``expand_image_placeholders`` and ``prepare_multimodal`` over images and
a video in several messages; greedy tokens after a multimodal prefill on
a paged runner with speculation on and off and on a contiguous one, with
the K/V rows at the image positions within 1e-5; a chat with an image
through both HTTP servers, streamed and not, and a 400 for a bad image;
and a YAML with ``mmproj`` loading a tower on the engine's device.
"""

import base64
import dataclasses
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")
st_numpy = pytest.importorskip("safetensors.numpy")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.api import inference as jinf  # noqa: E402
from localai_tpu.api.schema import OpenAIRequest  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import loader as jloader  # noqa: E402
from localai_tpu.models import vision as jv  # noqa: E402
from localai_tpu.spec import NGramDrafter as JaxNGram  # noqa: E402
from localai_tpu.spec import SpecEngine as JaxSpecEngine  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch.api import inference as tinf  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader, load_config_file  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import loader as tloader  # noqa: E402
from localai_tpu_torch.models import vision as tv  # noqa: E402
from localai_tpu_torch.utils.device import params_from_numpy  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager, build_runner  # noqa: E402
from localai_tpu_torch.spec import NGramDrafter, SpecEngine  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_media import _gif, picture, pil_bytes  # noqa: E402

TOL = 1e-5
WIDE = jv.VisionConfig(image_size=28, patch_size=14, hidden_size=128,
                       intermediate_size=256, num_layers=3, num_heads=2,
                       projection_dim=96, feature_layer=-2,
                       activation="gelu", dtype="float32")
VIT = dataclasses.replace(jv.DEBUG_PRESETS["vit"], dtype="float32")
LM = jl.LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2,
                    max_position_embeddings=512, dtype="float32")
IMAGE_TOKEN = 7


def tower_tree(cfg, seed: int = 0, bf16_exact: bool = False) -> dict:
    """The JAX package's tower tree as numpy, every leaf perturbed (so
    gains, biases and the CLS embedding are not their init constants);
    rounded to bfloat16-representable values when asked."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jv.init_params(jax.random.key(seed),
                                                   cfg))

    def perturb(a):
        a = np.asarray(a, np.float32) + rng.normal(
            0, 0.02, np.shape(a)).astype(np.float32)
        if bf16_exact:
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        return a

    return jax.tree.map(perturb, tree)


def towers(cfg, seed: int = 0):
    """(JAX VisionTower, port VisionTower) over the same f32 weights."""
    tree = tower_tree(cfg, seed)
    jt = jv.VisionTower(cfg, jax.tree.map(jnp.asarray, tree))
    tt = tv.VisionTower(tv.VisionConfig(**dataclasses.asdict(cfg)),
                        params_from_numpy(tree, "cpu"))
    return jt, tt


def images(seed: int = 0) -> list:
    """Odd sizes, a greyscale 2-D array, RGBA and the tower's own size."""
    rng = np.random.default_rng(seed)
    return [picture(37, 23, "edge", seed), picture(5, 64, "noise", seed),
            rng.integers(0, 256, (19, 19), dtype=np.uint8),
            rng.integers(0, 256, (32, 32, 4), dtype=np.uint8),
            picture(32, 32, "grad")]


# ---------------------------------------------------------------------------
# the tower

@pytest.mark.parametrize("cfg", [VIT, WIDE], ids=["vit", "wide"])
def test_preprocess_and_patchify_equal_the_reference(cfg):
    imgs = images()
    ref = jv.preprocess(imgs, cfg)
    got = tv.preprocess(imgs, tv.VisionConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    pj = np.asarray(jv.patchify(cfg, jnp.asarray(ref)))
    pt = tv.patchify(tv.VisionConfig(**dataclasses.asdict(cfg)),
                     torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("cfg", [VIT, WIDE], ids=["vit", "wide"])
def test_tower_forward_matches_the_reference(cfg):
    jt, tt = towers(cfg, seed=3)
    imgs = images(1)
    ref = jt.encode(imgs)
    got = tt.encode(imgs)
    assert got.shape == ref.shape == (len(imgs), cfg.n_patches,
                                      cfg.projection_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_tower_activations_are_the_references():
    """quick-GELU, and jax.nn.gelu's tanh form (not torch's exact one)."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    for act in ("quick_gelu", "gelu"):
        cfg = dataclasses.replace(VIT, activation=act)
        ref = np.asarray(jv._act(cfg, jnp.asarray(x)))
        got = tv._act(tv.VisionConfig(**dataclasses.asdict(cfg)),
                      torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# llava checkpoints

def _hf_tower(tree: dict, V: str, P: str) -> dict:
    out = {}
    C = tree["patch_embed"].shape[1]
    p = int(round((tree["patch_embed"].shape[0] / 3) ** 0.5))
    out[V + "embeddings.patch_embedding.weight"] = \
        tree["patch_embed"].T.reshape(C, 3, p, p)
    out[V + "embeddings.class_embedding"] = tree["cls"]
    out[V + "embeddings.position_embedding.weight"] = tree["pos_emb"]
    out[V + "pre_layrnorm.weight"] = tree["pre_ln"]["g"]
    out[V + "pre_layrnorm.bias"] = tree["pre_ln"]["b"]
    for i, lp in enumerate(tree["layers"]):
        L = f"{V}encoder.layers.{i}."
        for n in ("1", "2"):
            out[L + f"layer_norm{n}.weight"] = lp[f"ln{n}"]["g"]
            out[L + f"layer_norm{n}.bias"] = lp[f"ln{n}"]["b"]
        for hf, k in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                      ("out_proj", "o")):
            out[L + f"self_attn.{hf}.weight"] = lp["attn"][f"w{k}"].T
            out[L + f"self_attn.{hf}.bias"] = lp["attn"][f"b{k}"]
        for n in ("1", "2"):
            out[L + f"mlp.fc{n}.weight"] = lp["mlp"][f"w{n}"].T
            out[L + f"mlp.fc{n}.bias"] = lp["mlp"][f"b{n}"]
    for n in ("1", "2"):
        out[P + f"linear_{n}.weight"] = tree["projector"][f"w{n}"].T
        out[P + f"linear_{n}.bias"] = tree["projector"][f"b{n}"]
    return out


def write_llava(path, vcfg, lm_tree: dict, tower: dict,
                layout: str = "classic"):
    """A llava checkpoint dir: config.json (text_config, vision_config)
    and one safetensors file in the classic or the transformers >= 4.52
    layout."""
    if layout == "classic":
        body, head = "language_model.model.", "language_model.lm_head.weight"
        V, P = "vision_tower.vision_model.", "multi_modal_projector."
    else:
        body, head = "model.language_model.", "lm_head.weight"
        V, P = "model.vision_tower.vision_model.", "model.multi_modal_projector."
    names = {"input_layernorm.weight": ("attn_norm", False),
             "self_attn.q_proj.weight": ("wq", True),
             "self_attn.k_proj.weight": ("wk", True),
             "self_attn.v_proj.weight": ("wv", True),
             "self_attn.o_proj.weight": ("wo", True),
             "post_attention_layernorm.weight": ("mlp_norm", False),
             "mlp.gate_proj.weight": ("w_gate", True),
             "mlp.up_proj.weight": ("w_up", True),
             "mlp.down_proj.weight": ("w_down", True)}
    out = {body + "embed_tokens.weight": lm_tree["embed"],
           body + "norm.weight": lm_tree["final_norm"],
           head: lm_tree["lm_head"].T}
    for i in range(LM.num_layers):
        for hf, (key, tr) in names.items():
            a = lm_tree["layers"][key][i]
            out[f"{body}layers.{i}.{hf}"] = a.T if tr else a
    out.update(_hf_tower(tower, V, P))
    path.mkdir(parents=True, exist_ok=True)
    st_numpy.save_file({k: np.ascontiguousarray(v, np.float32)
                        for k, v in out.items()},
                       str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llava", "image_token_index": IMAGE_TOKEN,
        "vision_feature_layer": vcfg.feature_layer,
        "text_config": {
            "model_type": "llama", "vocab_size": LM.vocab_size,
            "hidden_size": LM.hidden_size,
            "intermediate_size": LM.intermediate_size,
            "num_hidden_layers": LM.num_layers,
            "num_attention_heads": LM.num_heads,
            "num_key_value_heads": LM.num_kv_heads,
            "max_position_embeddings": LM.max_position_embeddings},
        "vision_config": {
            "image_size": vcfg.image_size, "patch_size": vcfg.patch_size,
            "hidden_size": vcfg.hidden_size,
            "intermediate_size": vcfg.intermediate_size,
            "num_hidden_layers": vcfg.num_layers,
            "num_attention_heads": vcfg.num_heads,
            "hidden_act": vcfg.activation}}))
    return path


def lm_tree(seed: int = 0) -> dict:
    return jax.tree.map(np.asarray, jl.init_params(jax.random.key(seed), LM))


@pytest.mark.parametrize("layout", ["classic", "nested"])
def test_llava_checkpoint_loads_as_on_the_reference(tmp_path, layout):
    vcfg = dataclasses.replace(VIT, projection_dim=LM.hidden_size,
                               feature_layer=-2, dtype="bfloat16")
    tree = tower_tree(vcfg, seed=5)
    lm = lm_tree(1)
    ckpt = write_llava(tmp_path / layout, vcfg, lm, tree, layout)
    # the tower, in bfloat16 (the JAX package's dtype) and in float32
    jt = jv.load_llava_vision(ckpt, projection_dim=LM.hidden_size)
    tt = tv.load_llava_vision(ckpt, projection_dim=LM.hidden_size,
                              dtype="bfloat16", device="cpu")
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    jflat = jax.tree_util.tree_leaves_with_path(jt.params)
    for path, leaf in jflat:
        t = tt.params
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        ref = np.asarray(leaf)
        assert str(t.dtype).split(".")[-1] == ref.dtype.name, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      ref.astype(np.float32))
    t32 = tv.load_llava_vision(ckpt, projection_dim=LM.hidden_size,
                               dtype="float32", device="cpu")
    j32 = jv.VisionTower(dataclasses.replace(jt.cfg, dtype="float32"),
                         jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(t32.encode(images()), j32.encode(images()),
                               rtol=0, atol=TOL)
    # the language model
    cfg_j = jloader.load_hf_config(ckpt)
    cfg_t = tloader.load_hf_config(ckpt)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    _, pj = jloader.load_llama_params(ckpt, dtype="float32")
    _, pt = tloader.load_llama_params(ckpt, dtype="float32", device="cpu")
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(pt[name].numpy(), np.asarray(pj[name]))
    for name, w in pj["layers"].items():
        np.testing.assert_array_equal(pt["layers"][name].numpy(),
                                      np.asarray(w))


# ---------------------------------------------------------------------------
# placeholders and prepare_multimodal

def _data_uri(data: bytes, mime: str) -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _chat(n_video_frames: int = 5) -> list:
    png1 = _data_uri(pil_bytes(picture(37, 23, "edge"), "PNG"), "image/png")
    jpg = _data_uri(pil_bytes(picture(40, 50, "grad"), "JPEG", quality=90),
                    "image/jpeg")
    gif = _data_uri(_gif("P", 1, n_video_frames), "image/gif")
    raw = base64.b64encode(pil_bytes(picture(8, 8, "noise"), "PNG")).decode()
    return [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": [
            {"type": "text", "text": "what is this"},
            {"type": "image_url", "image_url": {"url": png1}}]},
        {"role": "assistant", "content": "a picture"},
        {"role": "user", "content": [
            {"type": "video_url", "video_url": {"url": gif}},
            {"type": "text", "text": "and these"},
            {"type": "image_url", "image_url": jpg},
            {"image_url": raw}]}]


def _sms(jt, tt):
    jsm = types.SimpleNamespace(name="m", vision=jt, tokenizer=JaxByteTokenizer(),
                                image_token_id=IMAGE_TOKEN)
    tsm = types.SimpleNamespace(
        name="m", vision=tt, tokenizer=ByteTokenizer(),
        image_token_id=IMAGE_TOKEN, config=ModelConfig(name="m"))
    return jsm, tsm


def test_prepare_multimodal_and_placeholders_equal_the_reference():
    cfg = dataclasses.replace(VIT, projection_dim=LM.hidden_size)
    jt, tt = towers(cfg, seed=2)
    jsm, tsm = _sms(jt, tt)
    body = {"model": "m", "messages": _chat()}
    jmsgs, jmm = jinf.prepare_multimodal(jsm, JaxModelConfig(name="m"),
                                         OpenAIRequest(**body))
    tmsgs, tmm = tinf.prepare_multimodal(tsm, _chat())
    assert [m["content"] for m in tmsgs] == [m["content"] for m in jmsgs]
    assert tmm.video_groups == jmm.video_groups == [(3, 5)]
    np.testing.assert_allclose(tmm.embeds, jmm.embeds, rtol=0, atol=TOL)
    prompt = "".join(f"<{m['role']}>{m['content']}" for m in jmsgs)
    jtok, jrows, jpos = jinf.expand_image_placeholders(jsm, prompt, jmm)
    ttok, trows, tpos = tinf.expand_image_placeholders(tsm, prompt, tmm)
    assert ttok == jtok
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_allclose(trows, jrows, rtol=0, atol=TOL)
    assert len(tpos) == 8 * cfg.n_patches
    # a raw array (images only), an unknown id, and a template that eats
    # the placeholders (the same warning on both)
    raw = np.asarray(jmm.embeds)[:2]
    for p in ("a[img-0]b[img-1][img-9][vid-0]c", "no placeholders"):
        j = jinf.expand_image_placeholders(jsm, p, raw)
        t = tinf.expand_image_placeholders(tsm, p, raw)
        assert t[0] == j[0]
        assert (t[1] is None) == (j[1] is None)
        if t[1] is not None:
            np.testing.assert_array_equal(t[2], j[2])


def test_prepare_multimodal_without_a_tower_serves_text():
    _, tsm = _sms(None, None)
    msgs, mm = tinf.prepare_multimodal(tsm, _chat())
    assert mm is None and "[img-0]" in msgs[1]["content"]


# ---------------------------------------------------------------------------
# multimodal prefill on the runners

RUNNER_KW = dict(num_slots=2, max_ctx=160, prefill_buckets=[32],
                 kv_dtype="float32")


def _lm():
    tree = lm_tree(4)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(LM))
    return (jax.tree.map(jnp.asarray, tree),
            tl.params_from_numpy(tree, cfg_t, device="cpu"), cfg_t)


def _mm_prompt(seed: int = 0):
    """A byte prompt with two 16-row image spans; rows [32, D] f32."""
    rng = np.random.default_rng(seed)
    prompt = (list(b"abc") + [IMAGE_TOKEN] * 16 + list(b" then ")
              + [IMAGE_TOKEN] * 16 + list(b"ok?"))
    pos = np.asarray([i for i, t in enumerate(prompt) if t == IMAGE_TOKEN],
                     np.int32)
    rows = rng.normal(0, 1, (len(pos), LM.hidden_size)).astype(np.float32)
    return prompt, rows, pos


def _rows_at(kv_stack, tables, slot, positions, paged: bool):
    """K/V rows of ``slot`` at ``positions`` [L, n, H, hd] per tensor."""
    out = []
    for t in kv_stack:
        t = np.asarray(t)
        if paged:
            blocks = np.asarray(tables)[slot]
            rows = t[:, blocks].transpose(0, 1, 3, 2, 4)
            rows = rows.reshape(t.shape[0], -1, *rows.shape[3:])
        else:
            rows = t[:, slot].transpose(0, 2, 1, 3)
        out.append(rows[:, positions])
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_mm_prefill_greedy_and_kv_rows_match_the_reference(paged):
    pj, pt, cfg_t = _lm()
    kw = dict(RUNNER_KW, **({"kv_block_tokens": 16} if paged else {}))
    jr = JaxRunner(LM, pj, paged=paged, attn_impl="xla", **kw)
    tr = ModelRunner(cfg_t, pt, paged=paged, device="cpu", **kw)
    prompt, rows, pos = _mm_prompt()
    outs = []
    for r in (jr, tr):
        s = r.acquire_slot()
        toks = [r.admit(s, prompt, temperature=0.0, mm_embeds=rows,
                        mm_positions=pos)]
        outs.append((s, toks))
    assert tr.last_prefill_path == jr.last_prefill_path == (
        "paged_mm" if paged else "mm")
    assert tr.last_prefix_reused == 0
    (sj, tj), (st, tt) = outs
    kv_j = _rows_at(jr.kv.stacked(), jr.block_tables if paged else None,
                    sj, pos, paged)
    kv_t = _rows_at([t.numpy() for t in tr.kv.stacked()],
                    tr.block_tables.numpy() if paged else None, st, pos,
                    paged)
    for a, b in zip(kv_j, kv_t):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    for _ in range(12):
        tj.append(int(jr.step()[sj]))
        tt.append(int(tr.step()[st]))
    assert tt == tj
    if paged:   # a multimodal prompt publishes no prefix blocks
        assert not tr.allocator.match_prefix(prompt)


def test_mm_prompt_longer_than_a_chunk_is_one_dispatch():
    """A paged multimodal admission never chunks: one dispatch at the
    bucket above the chunk size, ``chunks_remaining`` 1 until done."""
    _, pt, cfg_t = _lm()
    tr = ModelRunner(cfg_t, pt, paged=True, device="cpu",
                     **dict(RUNNER_KW, kv_block_tokens=16, prefill_chunk=16))
    prompt, rows, pos = _mm_prompt()
    adm = tr.begin_admit(tr.acquire_slot(), prompt, temperature=0.0,
                         mm_embeds=rows, mm_positions=pos)
    assert adm.chunks_remaining == 1
    before = tr.prefill_chunks
    assert adm.step_chunk() is not None
    assert tr.prefill_chunks == before + 1 and adm.chunks_remaining == 0
    with pytest.raises(ValueError, match="exceeds context"):
        tr.admit(tr.acquire_slot(), [IMAGE_TOKEN] * 200, mm_embeds=rows,
                 mm_positions=pos)


@pytest.mark.parametrize("paged,spec", [(True, False), (True, True),
                                        (False, False)],
                         ids=["paged", "paged-spec", "contiguous"])
def test_scheduler_mm_greedy_matches_the_reference(paged, spec):
    """Through both schedulers: an image chat beside a text one. A
    multimodal slot keeps no resident record, so its KV is never reused
    and speculation (the n-gram drafter) leaves the tokens unchanged."""
    pj, pt, cfg_t = _lm()
    kw = dict(RUNNER_KW, **({"kv_block_tokens": 16} if paged else {}))
    prompt, rows, pos = _mm_prompt(1)
    text = list(b"abcabcabcabcabc")
    reqs = [dict(prompt=prompt, mm_embeds=rows, mm_positions=pos),
            dict(prompt=text)]
    jr = JaxRunner(LM, pj, paged=paged, attn_impl="xla", **kw)
    jsched = JaxScheduler(jr, JaxByteTokenizer(), multi_step=4)
    try:
        want = [jsched.generate(JaxGenRequest(max_new_tokens=16,
                                              temperature=0.0,
                                              ignore_eos=True, **r),
                                timeout=120).token_ids for r in reqs]
    finally:
        jsched.shutdown()
    tr = ModelRunner(cfg_t, pt, paged=paged, device="cpu", **kw)
    eng = SpecEngine(tr, NGramDrafter(2, gamma=4), gamma=4) if spec else None
    sched = Scheduler(tr, ByteTokenizer(), multi_step=4, spec=eng)
    try:
        hs = [sched.submit(GenRequest(max_new_tokens=16, temperature=0.0,
                                      ignore_eos=True, **r)) for r in reqs]
        got = [h.result(120).token_ids for h in hs]
        mm_slot = [s for s, r in sched._resident.items() if r is None]
        assert len(mm_slot) == 1   # the image chat's slot keeps no record
        again = sched.generate(GenRequest(max_new_tokens=16, temperature=0.0,
                                          ignore_eos=True, **reqs[0]),
                               timeout=120).token_ids
    finally:
        sched.shutdown()
    assert got == want
    assert again == want[0]


# ---------------------------------------------------------------------------
# both HTTP servers

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            if body.get("stream"):
                return 200, "".join(
                    (c.get("delta") or {}).get("content") or ""
                    for line in r.read().splitlines()
                    if line.startswith(b"data: {")
                    for c in json.loads(line[6:])["choices"])
            return 200, json.loads(r.read())["choices"][0]["message"][
                "content"]
    except urllib.error.HTTPError as e:
        return e.code, None


@pytest.fixture(scope="module")
def llava_servers(tmp_path_factory):
    """Both HTTP servers over one llava checkpoint (the tower loaded from
    it). The JAX package runs its tower in bfloat16 and the port in the
    engine's dtype (float32 here): the checkpoint's weights are
    bfloat16-exact and the JAX server's tower is swapped for the float32
    one of the same weights, so both encode alike."""
    root = tmp_path_factory.mktemp("llava")
    vcfg = dataclasses.replace(VIT, projection_dim=LM.hidden_size,
                               feature_layer=-2)
    tree = tower_tree(vcfg, seed=8, bf16_exact=True)
    ckpt = write_llava(root / "ckpt", vcfg, lm_tree(2), tree)
    models = root / "models"
    models.mkdir()
    (models / "llava.yaml").write_text(yaml.safe_dump({
        "name": "llava", "model": str(ckpt), "context_size": 512,
        "engine": dict(max_slots=2, kv_block_tokens=16, prefill_chunk=32,
                       dtype="float32", kv_dtype="float32")}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    state = make_state(models)
    ref = _ServerThread(state)
    jsm = state.manager.get("llava")
    assert jsm.vision is not None and jsm.vision.cfg.dtype == "bfloat16"
    jsm.vision = jv.VisionTower(dataclasses.replace(jsm.vision.cfg,
                                                    dtype="float32"),
                                jax.tree.map(jnp.asarray, tree))
    yield port, ref.base
    ref.stop()
    port.shutdown()


@pytest.mark.parametrize("stream", [False, True])
def test_image_chat_over_http_equals_the_reference(llava_servers, stream):
    port, ref = llava_servers
    sm = port.manager.get("llava")
    assert sm.vision is not None and sm.image_token_id == IMAGE_TOKEN
    assert sm.vision.device.type == "cpu"
    assert sm.vision.params["patch_embed"].dtype == torch.float32
    body = {"model": "llava", "messages": _chat(3), "max_tokens": 12,
            "temperature": 0, "stream": stream, "ignore_eos": True}
    got = [_post(url + "/v1/chat/completions", body)
           for url in (port.url, ref)]
    assert got[0][0] == got[1][0] == 200
    assert got[0][1] == got[1][1] and got[0][1]


@pytest.mark.parametrize("url", ["data:image/png;base64,iVBORw0KGgo=",
                                 "not base64 at all!",
                                 "data:image/webp;base64,UklGRgAAAABXRUJQ"])
def test_bad_image_is_a_400_on_both(llava_servers, url):
    port, ref = llava_servers
    body = {"model": "llava", "max_tokens": 4, "messages": [
        {"role": "user", "content": [
            {"type": "text", "text": "hi"},
            {"type": "image_url", "image_url": {"url": url}}]}]}
    codes = [_post(u + "/v1/chat/completions", body)[0]
             for u in (port.url, ref)]
    assert codes == [400, 400]


def test_yaml_with_mmproj_loads_a_tower_on_the_engine_device(tmp_path):
    p = tmp_path / "v.yaml"
    p.write_text(yaml.safe_dump({
        "name": "v", "model": "debug:tiny", "mmproj": "debug:vit",
        "image_token_id": 3,
        "engine": {"dtype": "float32", "kv_dtype": "float32",
                   "max_slots": 1}}))
    cfg = load_config_file(p)
    assert cfg.mmproj == "debug:vit" and cfg.image_token_id == 3
    assert "vision" in cfg.usecase_heuristic()
    from localai_tpu_torch.models.manager import build_serving_model

    sm = build_serving_model(cfg, AppConfig(device="cpu"))
    try:
        assert sm.image_token_id == 3
        assert sm.vision.cfg.projection_dim == sm.runner.cfg.hidden_size
        assert sm.vision.device.type == "cpu"
        assert sm.vision.params["patch_embed"].dtype == torch.float32
        out = sm.vision.encode([picture(40, 30, "grad")])
        assert out.shape == (1, 16, sm.runner.cfg.hidden_size)
        assert np.isfinite(out).all()
    finally:
        sm.close()
    _, runner = build_runner(cfg, AppConfig(device="cpu"))
    assert runner.paged
