"""GGUF conversion on the PyTorch port, held against the JAX package.

The port's ``utils/gguf.py`` reads the same bytes as the JAX package's:
each block dequantizer gives equal float32 arrays, ``gguf_to_hf_config``
equal dicts, and ``convert_gguf`` of a llama GGUF and of a Mixtral-style
MoE GGUF (llama.cpp's Q4_K_M mix of types, written by chip_smoke's
writer, the pattern of tests/test_gguf.py) writes every tensor equal bit
for bit in bf16 (both round f32 to nearest even) and the same three JSON
files byte for byte. The converted directory serves equal greedy tokens
in both packages, and its ``WordLevel`` tokenizer.json reads as
``tokenizers`` reads it. ``util convert`` runs from the port's CLI.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
tokenizers = pytest.importorskip("tokenizers")

import jax  # noqa: E402,F401

import chip_smoke as smoke  # noqa: E402
from localai_tpu.cli import main as jax_cli  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import registry as jreg  # noqa: E402
from localai_tpu.utils import gguf as JG  # noqa: E402
from localai_tpu_torch.cli import main as cli  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.models import loader as tloader  # noqa: E402
from localai_tpu_torch.models import registry as treg  # noqa: E402
from localai_tpu_torch.utils import gguf as TG  # noqa: E402
from localai_tpu_torch.utils import hf_tokenizer  # noqa: E402
from localai_tpu_torch.utils import tokenizer as port_tok  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TYPES = {"f32": JG.F32, "f16": JG.F16, "q8_0": JG.Q8_0, "q4_0": JG.Q4_0,
         "q4_1": JG.Q4_1, "q4_k": JG.Q4_K, "q6_k": JG.Q6_K}


def test_type_tables_match_jax():
    assert TG._BLOCK == JG._BLOCK
    assert TG._BLOCK == smoke.GGUF_BLOCK
    assert set(TG._DEQUANT) == set(JG._DEQUANT)
    assert TG._MOE_STACKED == JG._MOE_STACKED


@pytest.mark.parametrize("scales", ["finite", "raw"])
@pytest.mark.parametrize("kind", sorted(TYPES))
def test_dequantizer_matches_jax(kind, scales):
    """The same bytes give the same float32 values, element for element:
    blocks with finite f16 scales, and wholly random bytes (any f16,
    inf and NaN included)."""
    dt = TYPES[kind]
    per, nbytes = JG._BLOCK[dt]
    rng = np.random.default_rng(dt)
    blocks = 64
    if scales == "finite":
        raw = smoke.gguf_random_blocks(rng, blocks * per, dt)
    else:
        raw = rng.integers(0, 256, blocks * nbytes, dtype=np.uint8).tobytes()
    want = JG._DEQUANT[dt](raw, blocks)
    got = TG._DEQUANT[dt](raw, blocks)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (blocks * per,)
    np.testing.assert_array_equal(got, want)
    if scales == "finite":
        assert np.isfinite(got).all() and np.abs(got).max() < 1.0


HF_CASES = {
    "llama": {"general.architecture": "llama", "llama.vocab_size": 300,
              "llama.embedding_length": 256, "llama.feed_forward_length": 512,
              "llama.block_count": 2, "llama.attention.head_count": 4,
              "llama.attention.head_count_kv": 2,
              "llama.context_length": 4096, "llama.rope.freq_base": 1e6,
              "llama.attention.layer_norm_rms_epsilon": 1e-5,
              "tokenizer.ggml.bos_token_id": 1,
              "tokenizer.ggml.eos_token_id": 2},
    "mixtral": {"general.architecture": "llama",
                "llama.embedding_length": 4096,
                "llama.feed_forward_length": 14336, "llama.block_count": 32,
                "llama.attention.head_count": 32,
                "llama.attention.head_count_kv": 8,
                "llama.expert_count": 8, "llama.expert_used_count": 2,
                "llama.context_length": 32768,
                "llama.rope.freq_base": 1e6,
                "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"]},
    "yarn-head-dim": {"general.architecture": "llama",
                      "llama.embedding_length": 64,
                      "llama.attention.head_count": 4,
                      "llama.attention.key_length": 32,
                      "llama.rope.scaling.type": "yarn",
                      "llama.rope.scaling.factor": 4.0,
                      "llama.rope.scaling.original_context_length": 4096,
                      "llama.rope.scaling.attn_factor": 1.2},
    "unsupported-scaling": {"general.architecture": "llama",
                            "llama.embedding_length": 64,
                            "llama.attention.head_count": 4,
                            "llama.attention.key_length": 16,
                            "llama.rope.scaling.type": "longrope"},
    "linear": {"general.architecture": "llama",
               "llama.rope.scaling.type": "linear",
               "llama.rope.scaling.factor": 2.0},
    "qwen2": {"general.architecture": "qwen2",
              "qwen2.embedding_length": 896, "qwen2.block_count": 24,
              "qwen2.attention.head_count": 14,
              "qwen2.attention.head_count_kv": 2},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_gguf_to_hf_config_matches_jax(case):
    meta = HF_CASES[case]
    assert TG.gguf_to_hf_config(meta) == JG.gguf_to_hf_config(meta)


def test_unpermute_matches_jax():
    w = np.random.default_rng(5).normal(size=(64, 12)).astype(np.float32)
    for heads in (2, 4, 8):
        np.testing.assert_array_equal(TG._unpermute(w, heads),
                                      JG._unpermute(w, heads))


@pytest.mark.parametrize("name", ["token_embd.weight", "output.weight",
                                  "blk.3.attn_q.weight", "blk.0.ffn_norm."
                                  "weight", "blk.1.ffn_gate_inp.weight",
                                  "blk.0.attn_k.bias", "blk.0.ffn_gate_exps."
                                  "weight", "rope_freqs.weight"])
def test_hf_name_matches_jax(name):
    assert TG._hf_name(name) == JG._hf_name(name)


def test_bf16_rounds_to_nearest_even_as_ml_dtypes():
    """f32 → bf16 in torch (the port's writer) and ml_dtypes (the JAX
    package's) agree bit for bit, ties to even included: each value below
    sits exactly half way between two bf16 values, and half round down
    (to an even mantissa) and half up."""
    import ml_dtypes

    base = np.arange(1, 257, dtype=np.uint32) << 16         # bf16 values
    ties = (base | 0x8000).view(np.float32)                  # half way
    rest = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    vals = np.concatenate([ties, -ties, rest])
    want = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    up = (want[:256] >> 0).astype(np.uint32) << 16 != base
    assert 0 < up.sum() < 256                                # both ways
    assert ((want[:256] & 1) == 0).all()                     # to even


# ---------------------------------------------------------------------------
# converted checkpoints
# ---------------------------------------------------------------------------

D, F, L, H, HKV, V, E = 256, 512, 2, 4, 2, 300, 4
TOKENS = ["<unk>", "<s>", "</s>"] + [f"tok{i}" for i in range(V - 5)] + [
    "hello", "hello world"]
TEMPLATE = "{% for m in messages %}{{ m['content'] }}{% endfor %}"


def _permute(x: np.ndarray, heads: int) -> np.ndarray:
    """llama.cpp's HF→GGUF q/k row permutation."""
    return (x.reshape(heads, 2, x.shape[0] // heads // 2, x.shape[1])
            .swapaxes(1, 2).reshape(x.shape))


def _gguf(path, moe: bool) -> None:
    """A 2-layer llama (``moe``: Mixtral-style, 4 experts) GGUF in
    llama.cpp's Q4_K_M mix (experts and ffn gate/up Q4_K, down Q6_K,
    attn_v Q8_0, output Q6_K), with q4_0 / q4_1 / f16 on other
    projections so every type converts, f32 norms of ones, f32 router,
    the vocabulary, end ids and a chat template."""
    hd = D // H
    ones = np.ones(D, np.float32).tobytes()
    rng = np.random.default_rng(7)
    q_rows = (rng.normal(size=(H * hd, D)) * 0.02).astype(np.float16)
    k_rows = (rng.normal(size=(HKV * hd, D)) * 0.02).astype(np.float16)
    tensors = [("token_embd.weight", (V, D), JG.Q4_K, None),
               ("output_norm.weight", (D,), JG.F32, ones),
               ("output.weight", (V, D), JG.Q6_K, None)]
    for i in range(L):
        b = f"blk.{i}."
        tensors += [
            (b + "attn_norm.weight", (D,), JG.F32, ones),
            # f16 q/k rows, permuted as llama.cpp stores them
            (b + "attn_q.weight", (H * hd, D), JG.F16,
             _permute(q_rows, H).tobytes()),
            (b + "attn_k.weight", (HKV * hd, D), JG.F16,
             _permute(k_rows, HKV).tobytes()),
            (b + "attn_v.weight", (HKV * hd, D), JG.Q8_0, None),
            (b + "attn_output.weight", (D, H * hd),
             JG.Q4_1 if i else JG.Q4_0, None),
            (b + "ffn_norm.weight", (D,), JG.F32, ones)]
        if moe:
            tensors += [
                (b + "ffn_gate_inp.weight", (E, D), JG.F32, None),
                (b + "ffn_gate_exps.weight", (E, F, D), JG.Q4_K, None),
                (b + "ffn_up_exps.weight", (E, F, D), JG.Q4_K, None),
                (b + "ffn_down_exps.weight", (E, D, F), JG.Q6_K, None)]
        else:
            tensors += [
                (b + "ffn_gate.weight", (F, D), JG.Q4_K, None),
                (b + "ffn_up.weight", (F, D), JG.Q4_K, None),
                (b + "ffn_down.weight", (D, F), JG.Q6_K, None)]
    meta = [("general.architecture", 8, "llama"),
            ("llama.vocab_size", 4, V),
            ("llama.embedding_length", 4, D),
            ("llama.feed_forward_length", 4, F),
            ("llama.block_count", 4, L),
            ("llama.attention.head_count", 4, H),
            ("llama.attention.head_count_kv", 4, HKV),
            ("llama.context_length", 4, 512),
            ("llama.rope.freq_base", 6, 1e6),
            ("llama.attention.layer_norm_rms_epsilon", 6, 1e-5),
            ("tokenizer.ggml.tokens", 9, TOKENS),
            ("tokenizer.ggml.bos_token_id", 4, 1),
            ("tokenizer.ggml.eos_token_id", 4, 2),
            ("tokenizer.chat_template", 8, TEMPLATE)]
    if moe:
        meta += [("llama.expert_count", 4, E),
                 ("llama.expert_used_count", 4, 2)]
    smoke.write_gguf(path, meta, tensors, seed=3 + moe)


@pytest.fixture(scope="module", params=["llama", "moe"])
def converted(request, tmp_path_factory):
    """(gguf path, the JAX package's dir, the port's dir), bf16."""
    root = tmp_path_factory.mktemp(request.param)
    src = root / "m.gguf"
    _gguf(src, request.param == "moe")
    want = JG.convert_gguf(src, root / "jax")
    got = TG.convert_gguf(src, root / "port")
    return src, want, got


def _bits(path):
    idx = tloader.read_safetensors_index(path / "model.safetensors")
    return {n: tloader.read_tensor(e) for n, e in idx.items()}


def test_convert_writes_the_jax_tensors_bit_for_bit(converted):
    src, want, got = converted
    a, b = _bits(want), _bits(got)
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype == torch.bfloat16, name
        assert a[name].shape == b[name].shape, name
        assert torch.equal(a[name].view(torch.int16),
                           b[name].view(torch.int16)), name
    moe = "model.layers.0.block_sparse_moe.gate.weight" in a
    assert ("model.layers.1.block_sparse_moe.experts.3.w2.weight" in a) == moe
    # q rows are back in HF order: the f16 source rows, exactly
    q = np.random.default_rng(7).normal(size=(D, D)) * 0.02
    np.testing.assert_array_equal(
        b["model.layers.0.self_attn.q_proj.weight"].float().numpy(),
        torch.from_numpy(q.astype(np.float16).astype(np.float32)).to(
            torch.bfloat16).float().numpy())


@pytest.mark.parametrize("name", ["config.json", "tokenizer.json",
                                  "tokenizer_config.json"])
def test_convert_writes_the_jax_json_files(converted, name):
    _, want, got = converted
    assert (got / name).read_bytes() == (want / name).read_bytes()


def test_convert_float32_matches_jax(tmp_path):
    src = tmp_path / "m.gguf"
    _gguf(src, moe=True)
    a = _bits(JG.convert_gguf(src, tmp_path / "jax", dtype="float32"))
    b = _bits(TG.convert_gguf(src, tmp_path / "port", dtype="float32"))
    assert set(a) == set(b)
    for name in a:
        assert b[name].dtype == torch.float32
        assert torch.equal(a[name], b[name]), name


def test_converted_dir_serves_equal_greedy_tokens(converted):
    """Both packages load the converted bf16 dir in float32 and decode the
    same greedy tokens."""
    _, _, got = converted
    jm = jreg.resolve_model(str(got), dtype="float32")
    tm = treg.resolve_model(str(got), dtype="float32", device="cpu")
    assert tm.cfg.num_experts == jm.cfg.num_experts
    kw = dict(num_slots=2, max_ctx=64, prefill_buckets=[16],
              kv_dtype="float32", kv_block_tokens=16)
    jr = JaxRunner(jm.cfg, jm.params, paged=True, attn_impl="xla", **kw)
    tr = ModelRunner(tm.cfg, tm.params, paged=True, device="cpu", **kw)
    prompt = tm.tokenizer.encode("hello") + [5, 9, 200, 17]
    out = []
    for r in (jr, tr):
        s = r.acquire_slot()
        toks = [r.admit(s, prompt, temperature=0.0)]
        toks += [int(r.step()[s]) for _ in range(12)]
        out.append(toks)
    assert out[0] == out[1]
    # the same weights in both, bit for bit (bf16 on disk, f32 loaded)
    for k, v in tm.params["layers"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jm.params["layers"][k]))


def test_converted_tokenizer_reads_as_tokenizers_does(converted):
    _, _, got = converted
    ref = tokenizers.Tokenizer.from_file(str(got / "tokenizer.json"))
    tok = port_tok.load_tokenizer(got)
    spec = hf_tokenizer.TokenizerJSON.from_file(got / "tokenizer.json")
    assert isinstance(spec.model, hf_tokenizer.WordLevel)
    for text in ["hello", "hello world", "tok7", "", "unknown words",
                 " hello", "héllo", "<s>"]:
        assert spec.encode(text) == ref.encode(
            text, add_special_tokens=False).ids, text
    ids = [3, 4, 0, 298, 299, 1, 2]
    assert spec.decode(ids) == ref.decode(ids, skip_special_tokens=False)
    assert tok.encode("hello world") == [299]


WORDLEVEL = {"version": "1.0", "added_tokens": [
    {"id": 4, "content": "<|end|>", "single_word": False, "lstrip": False,
     "rstrip": False, "normalized": False, "special": True}],
    "model": {"type": "WordLevel", "unk_token": "[UNK]",
              "vocab": {"[UNK]": 0, "the": 1, "cat": 2, "sat": 3,
                        "<|end|>": 4, "Ünï": 5}}}


@pytest.mark.parametrize("pre", [None, {
    "type": "Split", "pattern": {"String": " "}, "behavior": "Removed",
    "invert": False}], ids=["whole-text", "split-on-space"])
def test_wordlevel_matches_tokenizers(pre):
    spec = dict(WORDLEVEL)
    if pre is not None:
        spec["pre_tokenizer"] = pre
    ref = tokenizers.Tokenizer.from_str(json.dumps(spec))
    mine = hf_tokenizer.TokenizerJSON(spec)
    for text in ["the cat sat", "the", "the<|end|>cat", "dog", "Ünï",
                 "the  cat", ""]:
        assert mine.encode(text) == ref.encode(
            text, add_special_tokens=False).ids, text
    for ids in ([1, 2, 3], [0, 4, 5], []):
        assert mine.decode(ids) == ref.decode(ids, skip_special_tokens=False)


def test_wordlevel_refusals():
    spec = json.loads(json.dumps(WORDLEVEL))
    del spec["model"]["unk_token"]
    with pytest.raises(Exception):
        tokenizers.Tokenizer.from_str(json.dumps(spec))
    with pytest.raises(ValueError, match="unk_token"):
        hf_tokenizer.TokenizerJSON(spec)
    spec["model"]["unk_token"] = "<missing>"
    ref = tokenizers.Tokenizer.from_str(json.dumps(spec))
    with pytest.raises(Exception):
        ref.encode("dog")
    with pytest.raises(ValueError, match="not in the vocabulary"):
        hf_tokenizer.TokenizerJSON(spec).encode("dog")


def test_util_convert_cli_matches_jax(tmp_path, capsys):
    src = tmp_path / "m.gguf"
    _gguf(src, moe=True)
    assert cli.main(["util", "convert", str(src), str(tmp_path / "port")]) \
        == 0
    assert "converted" in capsys.readouterr().out
    assert jax_cli.main(["util", "convert", str(src),
                         str(tmp_path / "jax")]) == 0
    for name in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    a, b = _bits(tmp_path / "jax"), _bits(tmp_path / "port")
    assert set(a) == set(b) and all(
        torch.equal(a[n].view(torch.int16), b[n].view(torch.int16))
        for n in a)


def test_util_convert_cli_default_dir_and_dtype(tmp_path):
    src = tmp_path / "model.gguf"
    _gguf(src, moe=False)
    assert cli.main(["util", "convert", str(src), "--dtype", "float32"]) == 0
    out = tmp_path / "model"
    index = tloader.read_safetensors_index(out / "model.safetensors")
    assert {e[3] for e in index.values()} == {torch.float32}
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["num_hidden_layers"] == L and "num_local_experts" not in cfg


def test_util_convert_cli_refuses_a_missing_file(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["util", "convert", str(tmp_path / "none.gguf")])
    assert e.value.code == 2
    assert "not a file" in capsys.readouterr().err


def test_convert_refuses_a_file_that_is_not_gguf(tmp_path):
    bad = tmp_path / "x.gguf"
    bad.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a GGUF"):
        TG.convert_gguf(bad, tmp_path / "out")
