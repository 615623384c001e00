"""The port's VITS voice against the JAX package's, on the CPU.

Both packages take the same tiny random ``transformers.VitsModel``
checkpoints (``tests/test_vits.py``'s widths): the state dict carried
across, or a checkpoint directory written with ``safetensors`` in either
weight-norm layout. The port draws its noise from ``torch.Generator``s,
so each waveform is compared at zero noise, and with the JAX package's
own ``jax.random`` draws injected (``_forward(duration_noise=,
prior_noise=)``). Tolerance: the waveform within 1e-4 (float32 samples in
[-1, 1]).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")
st_numpy = pytest.importorskip("safetensors.numpy")

import jax  # noqa: E402

from localai_tpu.audio import vits as jv  # noqa: E402
from localai_tpu_torch.audio import vits as tv  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_vits import TINY  # noqa: E402

TOL = 1e-4
IDS = np.asarray([[1, 5, 9, 3, 7, 2, 11, 4]], np.int32)


def _hf_model(sdp: bool, seed: int = 0, **extra):
    from transformers import VitsConfig as HFVitsConfig
    from transformers import VitsModel

    torch.manual_seed(seed)
    hf = HFVitsConfig(**TINY, use_stochastic_duration_prediction=sdp,
                      **extra)
    return hf, VitsModel(hf).eval()


def _pair(sdp: bool, seed: int = 0, **extra):
    hf, model = _hf_model(sdp, seed, **extra)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    cfg = jv.VitsConfig.from_hf(hf.to_dict())
    return (jv.VitsTTS(cfg, jv._P(state), None),
            tv.VitsTTS(tv.VitsConfig.from_hf(hf.to_dict()),
                       tv._P(state, "cpu"), None))


def _jax_noises(ref, wav_len: int, seed: int):
    """The JAX package's two draws for ``seed`` (its key split order),
    unscaled; the prior's frame count from its waveform's length."""
    cfg = ref.cfg
    key = jax.random.key(seed)
    dur = None
    if cfg.use_stochastic_duration_prediction:
        k1, key = jax.random.split(key)
        dur = np.asarray(jax.random.normal(k1, (1, 2, IDS.shape[1])))
    k2, key = jax.random.split(key)
    frames = wav_len // int(np.prod(cfg.upsample_rates))
    return dur, np.asarray(jax.random.normal(k2, (1, cfg.flow_size,
                                                  frames)))


def _check(ref, ours, *, noise: float, seed: int = 3, **kw):
    args = dict(noise_scale=noise, noise_scale_duration=noise,
                speaking_rate=kw.pop("speaking_rate", 1.0), seed=seed,
                speaker_id=kw.pop("speaker_id", None), **kw)
    pad = np.ones(IDS.shape, np.float32)
    want = np.asarray(ref._forward(IDS, pad, **args)[0], np.float32)
    dur, prior = _jax_noises(ref, want.shape[0], seed)
    got = ours._forward(IDS, pad, duration_noise=dur, prior_noise=prior,
                        **args)[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    return got


@pytest.mark.parametrize("noise", [0.0, 0.667], ids=["zero-noise",
                                                      "jax-noise"])
@pytest.mark.parametrize("sdp", [False, True], ids=["deterministic-dp",
                                                    "stochastic-dp"])
def test_waveform_matches_the_jax_package(sdp, noise):
    ref, ours = _pair(sdp)
    _check(ref, ours, noise=noise, speaking_rate=1.4 if noise else 1.0)


@pytest.mark.parametrize("spk,noise", [(0, 0.0), (2, 0.5)])
def test_multispeaker_conditioning_matches(spk, noise):
    ref, ours = _pair(False, seed=1, num_speakers=3,
                      speaker_embedding_size=8)
    _check(ref, ours, noise=noise, speaker_id=spk)


@pytest.mark.parametrize("sdp", [False, True])
def test_continuous_speaker_embedding_matches(sdp):
    """The cloning path: a continuous embedding scaled by the trained
    table's mean norm conditions every net, as on the JAX package."""
    ref, ours = _pair(sdp, seed=2, num_speakers=4,
                      speaker_embedding_size=8)
    emb = np.random.default_rng(1).normal(size=8).astype(np.float32)
    _check(ref, ours, noise=0.5, speaker_embedding=emb / np.linalg.norm(emb))
    with pytest.raises(ValueError, match="speaker_embedding must be"):
        ours._forward(IDS, np.ones(IDS.shape, np.float32), noise_scale=0,
                      noise_scale_duration=0, speaking_rate=1.0,
                      speaker_id=None, seed=0,
                      speaker_embedding=np.zeros(5, np.float32))


def _write_voice(d, sdp=True, old_weight_norm=False, **extra):
    hf, model = _hf_model(sdp, **extra)
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    if old_weight_norm:  # torch's legacy weight_g / weight_v names
        state = {k.replace(".parametrizations.weight.original0",
                           ".weight_g").replace(
                     ".parametrizations.weight.original1", ".weight_v"): v
                 for k, v in state.items()}
    d.mkdir()
    st_numpy.save_file(state, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(
        {"model_type": "vits", **hf.to_dict()}, default=str))
    vocab = {ch: i for i, ch in enumerate("<pad> abcdefghijklmnopq")}
    vocab["<pad>"] = 0
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "add_blank": True, "pad_token": "<pad>"}))
    return d


@pytest.mark.parametrize("old_weight_norm", [False, True],
                         ids=["parametrizations", "weight_g-weight_v"])
def test_checkpoint_dir_synthesizes_as_the_jax_package(tmp_path,
                                                       old_weight_norm):
    d = _write_voice(tmp_path / "voice", old_weight_norm=old_weight_norm)
    ref, ours = jv.load_hf_vits(d), tv.load_hf_vits(d, "cpu")
    for text in ("Hello, Queen!",):
        assert ours.tokenizer.encode(text) == ref.tokenizer.encode(text)
        want = ref.synthesize(text, noise_scale=0.0,
                              noise_scale_duration=0.0)
        got = ours.synthesize(text, noise_scale=0.0,
                              noise_scale_duration=0.0)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert ours.last_frames * 16 == got.shape[0]


def test_seed_reproduces_the_ports_own_audio(tmp_path):
    """At the default noise scales a seed gives the same waveform every
    time, and another seed another one."""
    d = _write_voice(tmp_path / "voice")
    ours = tv.load_hf_vits(d, "cpu")
    a = ours.synthesize("abc def", seed=1)
    np.testing.assert_array_equal(a, ours.synthesize("abc def", seed=1))
    b = ours.synthesize("abc def", seed=2)
    assert a.shape != b.shape or not np.array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a).max() <= 1.0


def test_char_tokenizer_matches(tmp_path):
    (tmp_path / "vocab.json").write_text(json.dumps(
        {"<pad>": 0, "a": 1, "b": 2, "_": 3}))
    for tc in ({"do_lower_case": True, "add_blank": True,
                "pad_token": "<pad>"},
               {"do_lower_case": False, "add_blank": False,
                "pad_token": "_"}):
        (tmp_path / "tokenizer_config.json").write_text(json.dumps(tc))
        ref = jv.VitsCharTokenizer(tmp_path)
        ours = tv.VitsCharTokenizer(tmp_path)
        for text in ("aB!", "??", "", "ab_ba"):
            assert ours.encode(text) == ref.encode(text)


def test_config_from_hf_matches():
    hf, _ = _hf_model(True)
    for d in ({}, hf.to_dict(), {"num_hidden_layers": 3,
                                 "upsample_rates": [4, 4],
                                 "resblock_dilation_sizes": [[1, 3]]}):
        assert vars(tv.VitsConfig.from_hf(d)) == vars(jv.VitsConfig.from_hf(d))


@pytest.mark.parametrize("extra", [
    {"use_stochastic_duration_prediction": True},
    {"use_stochastic_duration_prediction": False},
    {"use_stochastic_duration_prediction": True, "num_speakers": 4,
     "speaker_embedding_size": 16},
    {"use_stochastic_duration_prediction": False, "num_speakers": 3,
     "speaker_embedding_size": 8, "window_size": 0},
], ids=["sdp", "dp", "sdp-speakers", "dp-speakers-no-window"])
def test_param_shapes_are_the_hf_inference_tensors(extra):
    """Every tensor the inference path reads, by its HF name and shape
    (weight norms fused), and nothing else; a voice drawn by
    ``init_params`` from them synthesizes."""
    from transformers import VitsConfig as HFVitsConfig
    from transformers import VitsModel

    hf = HFVitsConfig(**{**TINY, **extra})
    state = {k: v.detach().numpy() for k, v in VitsModel(hf).state_dict()
             .items() if not k.startswith(("posterior_encoder.",
                                           "duration_predictor.post_"))}
    fused = tv._P(state, "cpu")
    cfg = tv.VitsConfig.from_hf(hf.to_dict())
    assert {k: tuple(t.shape) for k, t in fused.t.items()} == \
        tv.param_shapes(cfg)
    voice = tv.VitsTTS(cfg, tv._P(tv.init_params(cfg, seed=1), "cpu"),
                       None)
    wav = voice._forward(IDS, np.ones(IDS.shape, np.float32),
                         noise_scale=0.667, noise_scale_duration=0.8,
                         speaking_rate=1.0, seed=0,
                         speaker_id=1 if cfg.num_speakers > 1 else None)
    assert np.isfinite(wav).all() and wav.shape[1] >= 16
