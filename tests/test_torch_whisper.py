"""The port's whisper against the JAX package's, on the CPU.

Both packages load the same tiny HF checkpoints, written by
``transformers`` (``WhisperForConditionalGeneration.save_pretrained``)
with a byte-level BPE ``tokenizer.json`` trained here by ``tokenizers`` on
the repository's README, or carry the same weights across (the JAX
package's debug preset, through ``from_jax_params``). Tolerances: encoder
states and ``decode_logits`` within 1e-4 (float32 throughout, values of
order 1); greedy token ids equal id for id, so ``transcribe``'s text and
segments are equal.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.audio import mel as jmel  # noqa: E402
from localai_tpu.models import whisper as jwh  # noqa: E402
from localai_tpu_torch.audio import mel as tmel  # noqa: E402
from localai_tpu_torch.models import whisper as twh  # noqa: E402
from localai_tpu_torch.models.loader import write_safetensors  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
# whisper's published special ids sit above 50257, so a checkpoint that
# the JAX package's prompt (sot, <|en|>, task, no-timestamps) can index
# has the multilingual vocabulary; widths stay tiny
HF_TINY = dict(vocab_size=51865, num_mel_bins=16, d_model=32,
               encoder_layers=2, encoder_attention_heads=2,
               decoder_layers=2, decoder_attention_heads=2,
               encoder_ffn_dim=64, decoder_ffn_dim=64,
               max_source_positions=1500, max_target_positions=24,
               pad_token_id=50257, bos_token_id=50257, eos_token_id=50257,
               decoder_start_token_id=50258, suppress_tokens=[],
               begin_suppress_tokens=[])


def write_whisper_tokenizer(model_dir: Path, vocab: int = 1000) -> None:
    """A byte-level BPE ``tokenizer.json`` trained on the README, with
    ``<|endoftext|>`` (ids past it decode to nothing in both readers)."""
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        [(REPO / "README.md").read_text()],
        trainers.BpeTrainer(
            vocab_size=vocab, special_tokens=["<|endoftext|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.save(str(model_dir / "tokenizer.json"))


def write_hf_whisper(model_dir: Path, seed: int = 1,
                     dtype=torch.float32, **overrides) -> Path:
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(
        HFWhisperConfig(**{**HF_TINY, **overrides})).eval()
    model.to(dtype).save_pretrained(model_dir, safe_serialization=True)
    write_whisper_tokenizer(model_dir)
    return model_dir


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_hf_whisper(tmp_path_factory.mktemp("whisper") / "w")


@pytest.fixture(scope="module")
def both(ckpt):
    return jwh.load_hf_whisper(ckpt), twh.load_hf_whisper(ckpt, "cpu")


def _speech_like(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.02 * rng.normal(size=t.size)).astype(np.float32)


def _cfg(c) -> dict:
    return dataclasses.asdict(c)


def _params_equal(a, b) -> None:
    for k, v in a.items():
        if isinstance(v, dict):
            _params_equal(v, b[k])
        else:
            np.testing.assert_array_equal(np.asarray(v), b[k].numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16],
                         ids=["f32", "f16"])
def test_load_encode_and_decode_logits_match(tmp_path, dtype):
    """The same checkpoint (float32, or float16 as whisper is published,
    widened to float32 by both loaders) loads to identical parameters;
    encoder states and teacher-forced logits agree within 1e-4."""
    d = write_hf_whisper(tmp_path / "w", seed=2, dtype=dtype)
    ref, ours = jwh.load_hf_whisper(d), twh.load_hf_whisper(d, "cpu")
    assert _cfg(ours.cfg) == _cfg(ref.cfg)
    _params_equal(jax.tree.map(np.asarray, ref.params), ours.params)
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(16, 200)).astype(np.float32) * 0.3
    enc_ref = np.asarray(jwh.encode(ref.cfg, ref.params, jnp.asarray(mel)))
    enc = twh.encode(ours.cfg, ours.params, torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), enc_ref, atol=TOL, rtol=0)
    tokens = np.asarray([50258, 50259, 50359, 50363, 7, 11, 2, 0],
                        np.int32)
    for n in (1, 4, 6):
        want = np.asarray(jwh.decode_logits(ref.cfg, ref.params,
                                            jnp.asarray(tokens),
                                            jnp.int32(n),
                                            jnp.asarray(enc_ref)))
        got = twh.decode_logits(ours.cfg, ours.params,
                                torch.from_numpy(tokens).long(), n,
                                torch.from_numpy(enc_ref))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_cached_steps_match_the_full_decoder(both):
    """A KV-cached step gives the logits of the teacher-forced decoder at
    its position (within 1e-4)."""
    _, ours = both
    cfg, p = ours.cfg, ours.params
    rng = np.random.default_rng(3)
    enc = torch.from_numpy(rng.normal(size=(50, cfg.d_model)).astype(
        np.float32))
    tokens = [50258, 50259, 50359, 50363, 17, 5, 900]
    ca_k, ca_v = twh.cross_kv(cfg, p, enc)
    Tmax = cfg.max_target_positions
    sa_k = torch.zeros((cfg.n_dec_layers, cfg.n_heads, Tmax, cfg.hd))
    sa_v = torch.zeros_like(sa_k)
    buf = torch.tensor(tokens + [0] * (Tmax - len(tokens)))
    for t, tok in enumerate(tokens):
        x = twh.cached_step(cfg, p, tok, t, sa_k, sa_v, ca_k, ca_v)
        want = twh.decode_logits(cfg, p, buf, t + 1, enc)
        np.testing.assert_allclose((x @ p["embed"].T).numpy(),
                                   want.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("language,translate", [(None, False),
                                                ("french", False),
                                                ("de", True)])
def test_transcribe_equals_the_jax_package(both, language, translate):
    """A 65-s recording (three chunks): greedy ids equal chunk for chunk,
    so text and segments are equal."""
    ref, ours = both
    audio = _speech_like(65.0)
    want = ref.transcribe(audio, language=language, translate=translate)
    got = ours.transcribe(audio, language=language, translate=translate)
    assert len(got["segments"]) == 3
    assert got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_debug_preset_carried_across_decodes_the_same_ids(seed):
    """The JAX package's debug preset, its weights carried across: the
    same ids for every chunk, with and without a token cap."""
    ref = jwh.debug_model(seed)
    ours = twh.WhisperModel(
        ref.cfg, twh.from_jax_params(jax.tree.map(np.asarray, ref.params),
                                     "cpu"), device="cpu")
    audio = tmel.chunk_audio(_speech_like(12.0, seed))[0]
    for cap in (None, 7):
        assert ours.transcribe_chunk(audio, max_tokens=cap) == \
            ref.transcribe_chunk(audio, max_tokens=cap)


def test_written_checkpoint_loads_in_both_packages(tmp_path):
    """``hf_tensors`` writes a checkpoint (the chip smoke's writer) that
    both loaders read back to the same parameters."""
    cfg = twh.WhisperConfig(n_mels=16, d_model=32, n_heads=2,
                            n_enc_layers=2, n_dec_layers=3, d_ff=48,
                            vocab_size=51865, max_target_positions=20)
    params = twh.init_params(cfg, seed=4, device="cpu", std=0.05)
    d = tmp_path / "w"
    d.mkdir()
    getters = twh.hf_tensors(cfg, params)
    write_safetensors(d / "model.safetensors", [
        (name, tuple(get().shape), torch.float16, get)
        for name, get in getters.items()])
    (d / "config.json").write_text(json.dumps({
        "model_type": "whisper", "num_mel_bins": 16, "d_model": 32,
        "encoder_attention_heads": 2, "encoder_layers": 2,
        "decoder_layers": 3, "encoder_ffn_dim": 48, "vocab_size": 51865,
        "max_target_positions": 20}))
    write_whisper_tokenizer(d)
    ours = twh.load_hf_whisper(d, "cpu")
    ref = jwh.load_hf_whisper(d)
    assert _cfg(ours.cfg) == _cfg(ref.cfg) == _cfg(cfg)
    _params_equal(jax.tree.map(np.asarray, ref.params), ours.params)
    half = jax.tree.map(lambda t: t.half().float(), params)
    _params_equal({k: v.numpy() if not isinstance(v, dict) else
                   {kk: vv.numpy() for kk, vv in v.items()}
                   for k, v in half.items()}, ours.params)


def test_config_and_language_tokens_match():
    for hf in ({}, HF_TINY, {"num_mel_bins": 128, "vocab_size": 51866,
                             "d_model": 1280, "encoder_layers": 32}):
        assert _cfg(twh.WhisperConfig.from_hf(hf)) == \
            _cfg(jwh.WhisperConfig.from_hf(hf))
    for lang in (None, "", "en", "French", " de ", "haw", "klingon", "su"):
        assert twh.language_token(twh.WhisperConfig(), lang) == \
            jwh.language_token(jwh.WhisperConfig(), lang)
    assert _cfg(twh.DEBUG_CONFIG) == _cfg(jwh.DEBUG_CONFIG)
    assert twh.param_shapes(twh.DEBUG_CONFIG) == \
        jwh.param_shapes(jwh.DEBUG_CONFIG)


def test_init_params_follow_the_jax_scheme():
    """Seeded weights: gains 1, the 1-D leaves 0, the rest drawn; the
    same seed gives the same tensors."""
    a = twh.init_params(twh.DEBUG_CONFIG, seed=5, device="cpu")
    b = twh.init_params(twh.DEBUG_CONFIG, seed=5, device="cpu")
    ref = jwh.init_params(jax.random.key(0), jwh.DEBUG_CONFIG)
    for k, v in a.items():
        items = v.items() if isinstance(v, dict) else [(k, v)]
        for name, t in items:
            r = np.asarray(ref[k][name] if isinstance(v, dict) else ref[k])
            other = b[k][name] if isinstance(v, dict) else b[k]
            assert torch.equal(t, other)
            assert tuple(t.shape) == r.shape
            if np.all(r == 1.0) or np.all(r == 0.0):
                np.testing.assert_array_equal(t.numpy(), r)
            else:
                assert 0.01 < float(t.std()) < 0.03


def test_log_mel_feeds_the_encoder_as_in_the_jax_package(both):
    """One chunk's frontend + encoder on the loaded checkpoint, within
    1e-4 of the JAX package's."""
    ref, ours = both
    audio = tmel.chunk_audio(_speech_like(7.0, 4))[0]
    mel_ref = jmel.log_mel(jnp.asarray(audio), ref.filters,
                           n_mels=ref.cfg.n_mels)
    want = np.asarray(ref._encode(ref.params, mel_ref))
    np.testing.assert_allclose(ours.encode_chunk(audio).numpy(), want,
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("vocab", [300, 503])
def test_small_vocabulary_decodes_as_the_jax_package(vocab):
    """A checkpoint whose vocabulary is smaller than whisper's special ids
    (the prompt's sot / language / task / no-timestamps ids sit past its
    table): the JAX package's gather clamps an out-of-range id to the
    table's last row and decodes on; the port clamps the same way, so the
    ids are equal and the teacher-forced logits agree within 1e-4."""
    cfg = dataclasses.replace(jwh.DEBUG_CONFIG, vocab_size=vocab)
    ref = jwh.WhisperModel(cfg, jwh.init_params(jax.random.key(5), cfg))
    ours = twh.WhisperModel(
        cfg, twh.from_jax_params(jax.tree.map(np.asarray, ref.params),
                                 "cpu"), device="cpu")
    audio = tmel.chunk_audio(_speech_like(6.0, 2))[0]
    assert ours.transcribe_chunk(audio, max_tokens=6) == \
        ref.transcribe_chunk(audio, max_tokens=6)
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    tokens = np.asarray([cfg.sot, cfg.lang_base, cfg.token_transcribe,
                         cfg.token_notimestamps, 7, vocab - 1, 0, 0],
                        np.int32)
    for n in (1, 4, 6):
        want = np.asarray(jwh.decode_logits(cfg, ref.params,
                                            jnp.asarray(tokens),
                                            jnp.int32(n), jnp.asarray(enc)))
        got = twh.decode_logits(ours.cfg, ours.params,
                                torch.from_numpy(tokens).long(), n,
                                torch.from_numpy(enc))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
