"""The port's audio front end, parametric voice, speaker encoder, audio
routes and audio subcommands against the JAX package's, on the CPU.

Wav I/O and the mel filterbank are equal bit for bit (the same numpy and
scipy code). ``log_mel`` holds within 1e-5 at whisper's 80 bins on
white noise. Where a mel band holds a small share of its frame's energy
(large-v3's 128 bins, whose narrowest low-frequency filters cover a
fraction of one FFT bin, or a voiced signal's gaps between harmonics),
each package's float32 FFT lies ~1e-5 from the float64 result (measured
on the inputs here: the JAX package's up to 1.8e-5, the port's up to
2.4e-5, the two 2.9e-5 apart), so every case is held within 4e-5 of
float64 and the two within 5e-5 of each other. ``_synth`` holds within 1e-5 on integer-valued pitch
tracks, with the JAX package's noise draw injected: its phase is a
float32 cumulative sum, which XLA and torch round in different orders
(~0.2 of a 1.6e6 sum apart, moving the sines by 1e-4), and integer sums
below 2**24 are exact in any order; ``synthesize`` hands it the same
frame tracks and noise seed. ``SpeakerEncoder`` holds within 1e-5 with
the JAX package's projections carried across. The HTTP cases drive the
port's server on the CPU beside the JAX package's over one models dir
(a whisper checkpoint, two VITS voices, a parametric voice), and hold
the statuses, JSON keys and bodies, and ``audio/wav`` bodies alike.
"""

import io
import json
import math
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")
pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.api import audio as jaudio  # noqa: E402
from localai_tpu.audio import mel as jmel  # noqa: E402
from localai_tpu.audio import speaker as jsp  # noqa: E402
from localai_tpu.audio import tts as jtts  # noqa: E402
from localai_tpu.audio import wav as jwav  # noqa: E402
from localai_tpu.cli import main as jcli  # noqa: E402
from localai_tpu_torch.api import audio as taudio  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.audio import mel as tmel  # noqa: E402
from localai_tpu_torch.audio import speaker as tsp  # noqa: E402
from localai_tpu_torch.audio import tts as ttts  # noqa: E402
from localai_tpu_torch.audio import wav as twav  # noqa: E402
from localai_tpu_torch.cli import main as tcli  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_vits import _write_voice  # noqa: E402
from test_torch_whisper import _speech_like, write_hf_whisper  # noqa: E402


def _wav_bytes(x: np.ndarray, rate: int, width: int, channels: int) -> bytes:
    x = np.clip(x, -1, 1)
    if channels > 1:
        x = np.stack([x * (0.5 + 0.5 * c / channels)
                      for c in range(channels)], 1).reshape(-1)
    pcm = {1: lambda v: (v * 127 + 128).astype(np.uint8),
           2: lambda v: (v * 32767).astype(np.int16),
           4: lambda v: (v * 2147483647).astype(np.int32)}[width](x)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


# ---------------------------------------------------------------------------
# wav and mel


@pytest.mark.parametrize("rate", [16000, 22050, 8000])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_read_wav_equals_the_jax_package(width, channels, rate):
    data = _wav_bytes(_speech_like(0.4), rate, width, channels)
    want = jwav.read_wav(data)
    got = twav.read_wav(data)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_write_wav_and_refusals_equal_the_jax_package():
    x = _speech_like(0.3) * 3   # clipped
    assert twav.write_wav(x, 22050) == jwav.write_wav(x, 22050)
    for bad in (b"", b"RIFF not a wave", b"ID3\x03mp3 data"):
        with pytest.raises(ValueError) as ours:
            twav.read_wav(bad)
        with pytest.raises(ValueError) as ref:
            jwav.read_wav(bad)
        assert str(ours.value) == str(ref.value)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:     # 24-bit PCM: refused by both
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16000)
        w.writeframes(bytes(300))
    for read in (twav.read_wav, jwav.read_wav):
        with pytest.raises(ValueError, match="sample width: 3"):
            read(buf.getvalue())


@pytest.mark.parametrize("n_mels,n_fft,rate", [(80, 400, 16000),
                                               (128, 400, 16000),
                                               (40, 400, 16000),
                                               (64, 512, 22050)])
def test_mel_filterbank_is_the_jax_one(n_mels, n_fft, rate):
    np.testing.assert_array_equal(tmel.mel_filterbank(n_mels, n_fft, rate),
                                  jmel.mel_filterbank(n_mels, n_fft, rate))


def _float64_log_mel(audio: np.ndarray, filters: np.ndarray) -> np.ndarray:
    x = np.pad(audio.astype(np.float64), (200, 200), mode="reflect")
    idx = np.arange(3000)[:, None] * 160 + np.arange(400)[None]
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))
    p = np.abs(np.fft.rfft(x[idx] * w, axis=-1)) ** 2
    ls = np.log10(np.maximum(p @ filters.T.astype(np.float64), 1e-10))
    return ((np.maximum(ls, ls.max() - 8) + 4) / 4).T


@pytest.mark.parametrize("signal", ["noise", "voiced"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches(n_mels, signal):
    rng = np.random.default_rng(0)
    audio = ((rng.normal(size=30 * 16000) * 0.1).astype(np.float32)
             if signal == "noise" else _speech_like(30.0, 1))
    f = jmel.mel_filterbank(n_mels)
    want = np.asarray(jmel.log_mel(jnp.asarray(audio), jnp.asarray(f),
                                   n_mels=n_mels))
    got = tmel.log_mel(torch.from_numpy(audio), torch.from_numpy(f)).numpy()
    assert got.shape == want.shape == (n_mels, 3000)
    if n_mels == 80 and signal == "noise":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    truth = _float64_log_mel(audio, f)
    np.testing.assert_allclose(got, truth, atol=4e-5, rtol=0)
    np.testing.assert_allclose(want, truth, atol=4e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 480000, 480001, 1500000])
def test_chunk_audio_matches(n):
    audio = np.linspace(-1, 1, n, dtype=np.float32)
    got, want = tmel.chunk_audio(audio), jmel.chunk_audio(audio)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the parametric voice


def _tracks(n_frames: int, seed: int):
    """Frame tracks drawn from the synthesiser's own values, the pitch
    integer-valued (see the module docstring)."""
    rng = np.random.default_rng(seed)
    f1 = rng.choice([0.0, 300, 320, 400, 500, 800, 2500], n_frames)
    f2 = rng.choice([0.0, 800, 900, 1200, 1400, 1800, 2300, 4000], n_frames)
    mix = rng.choice([0.0, 0.05, 0.35, 0.6, 0.95], n_frames)
    amp = (f1 > 0).astype(np.float64)
    pitch = rng.integers(95, 240, n_frames).astype(np.float64)
    return [a.astype(np.float32) for a in (f1, f2, mix, amp, pitch)]


@pytest.mark.parametrize("n_frames", [64, 256])
def test_synth_matches_with_the_jax_noise(n_frames):
    tracks = _tracks(n_frames, n_frames)
    key = jax.random.key(n_frames)
    noise = np.asarray(jax.random.normal(key, (n_frames * ttts.FRAME,)))
    want = np.asarray(jtts._synth(*map(jnp.asarray, tracks), key, n_frames))
    got = ttts._synth(*map(torch.from_numpy, tracks), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


class _Capture:
    """Stands in for ``_synth``: records its arguments, returns silence
    of the package's array type."""

    def __init__(self, zeros):
        self.calls = []
        self.zeros = zeros

    def __call__(self, *args):
        self.calls.append(args)
        return self.zeros(4 * 160)


@pytest.mark.parametrize("text,voice,speed", [
    ("Hello, world! This is a test.", "alloy", 1.0),
    ("a" * 2500, "echo", 0.5), ("", "nova", 2.0), ("  ?! 42", "x", 0.1)])
def test_synthesize_builds_the_jax_tracks(monkeypatch, text, voice, speed):
    ours, ref = _Capture(torch.zeros), _Capture(np.zeros)
    monkeypatch.setattr(ttts, "_synth", ours)
    monkeypatch.setattr(jtts, "_synth", ref)
    got = ttts.synthesize(text, voice, speed, device="cpu")
    want = jtts.synthesize(text, voice, speed)
    assert got.shape == want.shape
    (*o_tracks, noise), (*r_tracks, key, bucket) = ours.calls[0], ref.calls[0]
    assert len(o_tracks) == len(r_tracks) == 5
    for a, b in zip(o_tracks, r_tracks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert noise.shape == (bucket * ttts.FRAME,)
    assert jax.random.key_data(key).tolist() == jax.random.key_data(
        jax.random.key(ttts._noise_seed(voice, text))).tolist()


def test_synthesize_takes_the_reference_pitch(monkeypatch):
    ours, ref = _Capture(torch.zeros), _Capture(np.zeros)
    monkeypatch.setattr(ttts, "_synth", ours)
    monkeypatch.setattr(jtts, "_synth", ref)
    voice = _voice(180.0, 1.5)
    ttts.synthesize("hello there", "alloy", ref_audio=voice, device="cpu")
    jtts.synthesize("hello there", "alloy", ref_audio=voice)
    # the pitch estimates agree to float32 rounding (within 1e-5 Hz/Hz)
    np.testing.assert_allclose(ours.calls[0][4].numpy(),
                               np.asarray(ref.calls[0][4]), rtol=1e-5)


def test_synthesized_audio_is_speech_shaped():
    a = ttts.synthesize("Hello world.", "alloy", device="cpu")
    b = ttts.synthesize("Hello world.", "alloy", device="cpu")
    np.testing.assert_array_equal(a, b)     # the seeded noise repeats
    assert a.dtype == np.float32 and np.isfinite(a).all()
    assert 0.5 < np.abs(a).max() <= 0.7 + 1e-6
    assert a.shape == jtts.synthesize("Hello world.", "alloy").shape


def test_full_f32_holds_tf32_off_across_threads():
    """Concurrent audio calls: while any holds ``full_f32`` both TF32
    flags read off, and the last one out restores them (a lost update of
    the holder count would restore them under a running call)."""
    import sys
    import threading

    from localai_tpu_torch.utils.device import full_f32

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    saved = flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []

    def work():
        for _ in range(300):
            with full_f32():
                if flags() != (False, False):
                    seen.append(flags())

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen and flags() == (True, True)
    finally:
        sys.setswitchinterval(switch)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# the speaker encoder


def _voice(f0: float, seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2
    return (0.3 * x * env + 0.01 * rng.normal(size=t.size)).astype(
        np.float32)


@pytest.fixture(scope="module")
def encoders():
    ref = jsp.SpeakerEncoder()
    ours = tsp.SpeakerEncoder(device="cpu")
    ours.params = {"proj": torch.from_numpy(np.asarray(ref.params["proj"]))}
    return ref, ours


@pytest.mark.parametrize("f0,seconds", [(110.0, 1.0), (210.0, 3.0),
                                        (150.0, 5.0), (300.0, 0.05)])
def test_speaker_embedding_matches(encoders, f0, seconds):
    ref, ours = encoders
    audio = _voice(f0, seconds)
    want = ref.embed(audio)
    got = ours.embed(audio)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    table = np.asarray(jax.random.normal(jax.random.key(1234), (8, 192))
                       / np.sqrt(192))
    ours.projection = lambda size: table
    try:
        np.testing.assert_allclose(ours.project(got, 8), ref.project(want, 8),
                                   atol=1e-5, rtol=0)
    finally:
        del ours.projection
    assert ours.project(got, 192) is got


def test_speaker_encoder_load_and_seeded_projection(tmp_path, encoders):
    _, ours = encoders
    proj = np.random.default_rng(0).normal(size=(16, 306)).astype(np.float32)
    np.savez(tmp_path / "enc.npz", proj=proj)
    enc = tsp.SpeakerEncoder(device="cpu")
    enc.load(tmp_path / "enc.npz")
    ref = jsp.SpeakerEncoder()
    ref.load(tmp_path / "enc.npz")
    audio = _voice(140.0, 2.0)
    np.testing.assert_allclose(enc.embed(audio), ref.embed(audio),
                               atol=1e-5, rtol=0)
    p = ours.projection(24)
    np.testing.assert_array_equal(p, ours.projection(24))
    assert p.shape == (24, 192)
    out = ours.project(ours.embed(audio), 24)
    assert out.shape == (24,) and abs(np.linalg.norm(out) - 1) < 1e-5
    assert tsp.get_speaker_encoder("cpu") is tsp.get_speaker_encoder("cpu")


@pytest.mark.parametrize("f0", [95.0, 140.0, 250.0])
def test_estimate_pitch_matches(f0):
    audio = _voice(f0, 2.0, seed=int(f0))
    want = jsp.estimate_pitch(audio)
    got = tsp.estimate_pitch(audio, device="cpu")
    assert math.isclose(got, want, rel_tol=1e-5)
    assert abs(got - f0) < 0.05 * f0
    silence = np.zeros(16000, np.float32)
    assert tsp.estimate_pitch(silence, device="cpu") == \
        jsp.estimate_pitch(silence) == 140.0
    assert tsp.estimate_pitch(audio[:100], device="cpu") == 140.0


# ---------------------------------------------------------------------------
# the HTTP routes, beside the JAX package's server


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    models = tmp_path_factory.mktemp("audio") / "models"
    models.mkdir()
    write_hf_whisper(models / "whisper-ckpt")
    _write_voice(models / "voice-ckpt")
    _write_voice(models / "voice-ms", sdp=False, num_speakers=3,
                 speaker_embedding_size=8)
    (models / "voices").mkdir()
    (models / "voices" / "alice.wav").write_bytes(
        twav.write_wav(_voice(200.0, 2.0)))
    (models / "outside.wav").write_bytes(twav.write_wav(_voice(90.0, 2.0)))
    docs = {"stt": {"backend": "whisper", "model": "whisper-ckpt"},
            "voice": {"model": "voice-ckpt"},
            "clone": {"backend": "vits", "model": "voice-ms",
                      "tts": {"audio_path": "voices", "voice": "alice"}},
            "speak": {"backend": "tts", "model": "debug:tts",
                      "tts": {"voice": "echo", "language": "en"}}}
    for name, doc in docs.items():
        (models / f"{name}.yaml").write_text(
            yaml.safe_dump({"name": name, **doc}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device="cpu"),
                           loader)
    port = APIServer(manager, "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield {"port": port.url, "ref": ref.base, "manager": manager,
           "state": ref.state, "models": models}
    ref.stop()
    port.shutdown()


def _call(url, *, body=None, data=None, ctype="application/json"):
    """(status, body bytes, headers)."""
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _both(servers, path, **kw):
    return [_call(servers[s] + path, **kw) for s in ("port", "ref")]


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "----audio-test-7d2f"
    out = b""
    for name, value in fields.items():
        out += f"--{boundary}\r\n".encode()
        if isinstance(value, bytes):
            out += (f'Content-Disposition: form-data; name="{name}"; '
                    f'filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n'
                    ).encode() + value + b"\r\n"
        else:
            out += (f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                    f"{value}\r\n").encode()
    out += f"--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


@pytest.mark.parametrize("fmt", ["json", "text", "verbose_json", None])
def test_transcription_formats_as_the_jax_server(servers, fmt):
    fields = {"file": twav.write_wav(_speech_like(5.0, 2)), "model": "stt"}
    if fmt:
        fields["response_format"] = fmt
    data, ctype = _multipart(fields)
    (s1, b1, h1), (s2, b2, h2) = _both(
        servers, "/v1/audio/transcriptions", data=data, ctype=ctype)
    assert s1 == s2 == 200
    if fmt == "text":
        assert h1["Content-Type"].startswith("text/plain")
        assert b1 == b2 and b1.endswith(b"\n")
    else:
        port, ref = json.loads(b1), json.loads(b2)
        assert port == ref
        assert set(port) == ({"task", "duration", "text", "segments"}
                             if fmt == "verbose_json"
                             else {"text", "segments"})
        assert set(port["segments"][0]) == {"id", "start", "end", "text",
                                            "tokens"}


def test_transcription_picks_the_whisper_model_and_language(servers):
    """No ``model`` field: the first config with the transcript usecase;
    ``language`` and ``translate`` reach the prompt as on the JAX
    server."""
    data, ctype = _multipart({"file": twav.write_wav(_speech_like(3.0, 5)),
                              "language": "de", "translate": "true"})
    (s1, b1, _), (s2, b2, _) = _both(servers, "/v1/audio/transcriptions",
                                     data=data, ctype=ctype)
    assert s1 == s2 == 200 and json.loads(b1) == json.loads(b2)


@pytest.mark.parametrize("case", ["json-body", "missing-file", "bad-wav",
                                  "unknown-model", "debug-ref"])
def test_transcription_errors_as_the_jax_server(servers, case):
    wav = twav.write_wav(_speech_like(1.0))
    if case == "json-body":
        kw = {"body": {"model": "stt"}}
    else:
        fields = {"missing-file": {"model": "stt"},
                  "bad-wav": {"file": b"ID3 not a wav", "model": "stt"},
                  "unknown-model": {"file": wav, "model": "nope"},
                  "debug-ref": {"file": wav, "model": "debug:whisper"}}[case]
        data, ctype = _multipart(fields)
        kw = {"data": data, "ctype": ctype}
    (s1, b1, _), (s2, b2, _) = _both(servers, "/v1/audio/transcriptions",
                                     **kw)
    want = {"json-body": 400, "missing-file": 400, "bad-wav": 400,
            "unknown-model": 404, "debug-ref": 200}[case]
    assert s1 == s2 == want, (b1, b2)
    if case == "debug-ref":   # a bare debug: ref registers a transient
        assert set(json.loads(b1)) == set(json.loads(b2))


@pytest.mark.parametrize("path,body", [
    ("/v1/audio/speech", {"model": "voice", "input": "abc def"}),
    ("/tts", {"model": "voice", "text": "abc"}),
    ("/v1/audio/speech", {"model": "speak", "input": "Hello there."}),
    ("/tts", {"input": "plain voice", "voice": "nova", "speed": 1.5}),
    ("/v1/audio/speech", {"model": "clone", "input": "abc"}),
    ("/v1/audio/speech", {"model": "clone", "input": "abc", "voice": "1"}),
    ("/v1/text-to-speech/alice", {"text": "eleven labs"}),
    ("/v1/sound-generation", {"text": "rain", "duration_seconds": 0.3}),
    ("/sound-generation", {"input": "wind", "duration_seconds": "0.25"}),
])
def test_speech_routes_answer_wav_as_the_jax_server(servers, path, body):
    (s1, b1, h1), (s2, b2, h2) = _both(servers, path, body=body)
    assert s1 == s2 == 200, (b1[:200], b2[:200])
    assert h1["Content-Type"] == h2["Content-Type"] == "audio/wav"
    ours, ref = (twav.read_wav(b) for b in (b1, b2))
    assert b1[:4] == b"RIFF" and np.isfinite(ours).all() and ours.size > 100
    if body.get("model") not in ("voice", "clone"):
        # the parametric voice and the generator: lengths are fixed by
        # the text and duration, whatever the noise
        assert ours.shape == ref.shape


@pytest.mark.parametrize("path,body,status", [
    ("/v1/audio/speech", {"model": "voice", "input": ""}, 400),
    ("/tts", {"input": "x", "speed": "fast"}, 400),
    ("/v1/text-to-speech/alice", {}, 400),
    ("/v1/sound-generation", {"text": ""}, 400),
    ("/v1/sound-generation", {"text": "x", "duration_seconds": "long"}, 400),
    ("/sound-generation", {"text": "x", "temperature": [1]}, 400),
])
def test_speech_errors_as_the_jax_server(servers, path, body, status):
    (s1, _, _), (s2, _, _) = _both(servers, path, body=body)
    assert s1 == s2 == status


def test_reference_voice_is_confined_to_audio_path(servers):
    """A voice name that walks out of ``audio_path`` gets no reference
    (the request still answers); one inside it does, on both packages."""
    manager, state = servers["manager"], servers["state"]
    for voice in ("../outside", "../../etc/passwd", "/abs/alice"):
        assert taudio._reference_voice(manager, "clone", voice) is None
        assert jaudio._reference_voice(state, "clone", voice) is None
    ours = taudio._reference_voice(manager, "clone", "alice")
    np.testing.assert_array_equal(
        ours, jaudio._reference_voice(state, "clone", "alice"))
    assert taudio._reference_voice(manager, "voice", "alice") is None
    (s1, _, _), (s2, _, _) = _both(
        servers, "/v1/audio/speech",
        body={"model": "clone", "input": "abc", "voice": "../outside"})
    assert s1 == s2 == 200


def test_audio_models_are_managed_and_traced(servers):
    """Whisper and VITS models live in the manager's registry (monitor,
    metrics) and their routes pass the request wrapper: a trace id
    answered, an HTTP span, ``localai_api_call_seconds`` by route."""
    url, manager = servers["port"], servers["manager"]
    s, _, h = _call(url + "/v1/audio/speech",
                    body={"model": "voice", "input": "abc"})
    assert s == 200 and h["X-Trace-ID"]
    data, ctype = _multipart({"file": twav.write_wav(_speech_like(1.0)),
                              "model": "stt"})
    assert _call(url + "/v1/audio/transcriptions", data=data,
                 ctype=ctype)[0] == 200
    for name, kind in (("stt", "whisper"), ("voice", "vits")):
        s, b, _ = _call(url + "/backend/monitor", body={"model": name})
        mon = json.loads(b)
        assert s == 200 and mon["loaded"] and mon["type"] == kind
        assert mon["requests_served"] >= 1
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    paths = {line.split('path="')[1].split('"')[0]
             for line in text.splitlines()
             if line.startswith("localai_api_call_seconds_count")}
    assert {"/v1/audio/speech", "/v1/audio/transcriptions"} <= paths
    with urllib.request.urlopen(url + "/v1/traces?kind=http&limit=500",
                                timeout=60) as r:
        traced = {t["attrs"].get("path")
                  for t in json.loads(r.read())["traces"]}
    assert "/v1/audio/transcriptions" in traced
    assert set(manager.metrics()["stt"]) == {"type", "requests_served"}


def test_oversized_and_malformed_bodies_are_refused(servers):
    url = servers["port"]
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions", data=b"x", method="POST",
        headers={"Content-Type": "multipart/form-data; boundary=b",
                 "Content-Length": str(65 << 20)})
    try:
        urllib.request.urlopen(req, timeout=60)
        raise AssertionError("expected 413")
    except urllib.error.HTTPError as e:
        assert e.code == 413
    except (ConnectionError, urllib.error.URLError):
        pass    # the server may close before the client sends
    s, _, _ = _call(url + "/v1/audio/transcriptions",
                    data=b"--b\r\nno headers here", ctype="multipart/"
                    "form-data; boundary=b")
    assert s == 400


def test_parse_multipart_reads_binary_fields_exactly():
    payload = bytes(range(256)) * 5 + b"\r\n--not-the-boundary\r\n\r\n"
    data, ctype = _multipart({"file": payload, "model": "m é",
                              "empty": ""})
    fields = taudio.parse_multipart(ctype, data)
    assert fields == {"file": payload, "model": "m é".encode(),
                      "empty": b""}


def test_welcome_lists_the_audio_routes(servers):
    with urllib.request.urlopen(servers["port"] + "/", timeout=60) as r:
        port = set(json.loads(r.read())["endpoints"])
    with urllib.request.urlopen(urllib.request.Request(
            servers["ref"] + "/", headers={"Accept": "application/json"}),
            timeout=60) as r:
        ref = set(json.loads(r.read())["endpoints"])
    audio = {"/v1/audio/transcriptions", "/v1/audio/speech", "/tts",
             "/v1/text-to-speech/{voice_id}", "/v1/sound-generation",
             "/sound-generation"}
    assert audio <= port and audio <= ref


# ---------------------------------------------------------------------------
# the subcommands


def _flags(parser, command: str) -> set:
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {opt for a in sub.choices[command]._actions
            for opt in (a.option_strings or [a.dest])}


@pytest.mark.parametrize("command", ["tts", "transcript",
                                     "sound-generation"])
def test_subcommands_take_the_jax_flags(command):
    assert _flags(tcli.build_parser(), command) == \
        _flags(jcli.build_parser(), command) | {"--device"}


def test_subcommands_run_on_the_cpu_as_the_jax_ones(servers, tmp_path,
                                                   capsys):
    models = str(servers["models"])
    out = tmp_path / "t.wav"
    assert tcli.main(["tts", "Hello", "world", "-m", "speak", "-o", str(out),
                      "--models-path", models, "--device", "cpu"]) == 0
    ours = twav.read_wav(out.read_bytes())
    assert jcli.main(["tts", "Hello", "world", "-m", "speak",
                      "-o", str(tmp_path / "j.wav"),
                      "--models-path", models]) == 0
    assert ours.shape == twav.read_wav(
        (tmp_path / "j.wav").read_bytes()).shape
    audio = tmp_path / "speech.wav"
    audio.write_bytes(twav.write_wav(_speech_like(4.0, 7)))
    capsys.readouterr()
    assert tcli.main(["transcript", str(audio), "--models-path", models,
                      "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["transcript", str(audio), "--models-path",
                      models]) == 0
    assert got == capsys.readouterr().out
    snd = tmp_path / "s.wav"
    assert tcli.main(["sound-generation", "rain", "-d", "0.3", "-o",
                      str(snd), "--device", "cpu"]) == 0
    assert twav.read_wav(snd.read_bytes()).shape == (4800,)
