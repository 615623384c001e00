"""Audio endpoints: transcription (OpenAI), speech (OpenAI and LocalAI),
and the Elevenlabs routes.

Port of ``localai_tpu/api/audio.py`` as framework-free functions that
``api.server`` maps HTTP onto, with the JAX package's statuses, JSON keys
and ``audio/wav`` bodies:

  * POST /v1/audio/transcriptions — multipart/form-data (``file``,
    ``model``, ``language``, ``translate``, ``response_format`` text |
    json | verbose_json) → the whisper engine; a non-multipart request,
    a missing ``file`` and an unparsable WAV are 400s
  * POST /v1/audio/speech and /tts — JSON → a VITS voice when the model
    names a VITS checkpoint, else the parametric synthesiser
  * POST /v1/text-to-speech/{voice_id} — Elevenlabs TTS
  * POST /v1/sound-generation and /sound-generation — the MusicGen-class
    generator

A model's ``tts.audio_path`` names a reference recording (a wav file, or
a directory of ``<voice>.wav`` that the voice name is confined to by
``utils.paths.verify_path``): a multi-speaker VITS voice is conditioned
on its ``SpeakerEncoder`` embedding, the parametric voice takes its
pitch. Each call runs on the request's thread, on the server's device.
The multipart body is parsed here (:func:`parse_multipart`: the stdlib
server has no form parser, and the ``cgi`` module is gone from Python
3.13).
"""

from __future__ import annotations

import re
from pathlib import Path

from localai_tpu_torch.api.openai import APIError
from localai_tpu_torch.config.model_config import ModelConfig

WAV = "audio/wav"


def parse_multipart(ctype: str, body: bytes,
                    filenames: dict[str, str] | None = None
                    ) -> dict[str, bytes]:
    """A ``multipart/form-data`` body → {field name: raw bytes}; a given
    ``filenames`` dict receives each file field's ``filename``. Raises
    ``APIError`` 400 for another content type or a malformed body."""
    m = re.search(r'boundary="?([^";]+)"?', ctype or "")
    if not (ctype or "").startswith("multipart/") or m is None:
        raise APIError(400, "expected multipart/form-data")
    delim = b"--" + m.group(1).encode("latin-1")
    fields: dict[str, bytes] = {}
    for part in body.split(delim)[1:]:
        if part.startswith(b"--"):          # the closing delimiter
            break
        head, sep, data = part.removeprefix(b"\r\n").partition(b"\r\n\r\n")
        name = re.search(rb'(?im)^content-disposition:.*?\bname="([^"]*)"',
                         head)
        if not sep or name is None:
            raise APIError(400, "malformed multipart/form-data body")
        # the CRLF before the next delimiter belongs to the delimiter
        field = name.group(1).decode("utf-8", "replace")
        fields[field] = data.removesuffix(b"\r\n")
        fname = re.search(
            rb'(?im)^content-disposition:.*?\bfilename="([^"]*)"', head)
        if filenames is not None and fname is not None:
            filenames[field] = fname.group(1).decode("utf-8", "replace")
    return fields


def _whisper_for(manager, name: str):
    """name → whisper AudioServingModel through the manager; a bare
    ``debug:`` ref or a checkpoint dir named directly registers a
    transient config first, as on the JAX package."""
    try:
        return manager.get_whisper(name)
    except FileNotFoundError as e:
        raise APIError(404, str(e)) from None
    except KeyError:
        pass
    resolvable = name.startswith("debug:") or any(
        (cand / "config.json").exists()
        for cand in (Path(name), Path(manager.app.model_path) / name))
    if not resolvable:
        raise APIError(404, f"model {name!r} not configured")
    manager.loader.register(ModelConfig(
        name=name, model=name, backend="whisper",
        known_usecases=["transcript"]))
    try:
        return manager.get_whisper(name)
    except FileNotFoundError as e:
        raise APIError(404, str(e)) from None


def _transcript_model(manager, name: str) -> str:
    if name:
        return name
    for n in manager.loader.names():
        if manager.loader.get(n).has_usecase("transcript"):
            return n
    raise APIError(404, "no transcription model configured "
                        "(backend: whisper)")


def transcriptions(manager, fields: dict[str, bytes]):
    """POST /v1/audio/transcriptions over the parsed form."""
    from localai_tpu_torch.audio import read_wav

    audio_bytes = fields.get("file", b"")
    if not audio_bytes:
        raise APIError(400, "missing file field")
    text = {k: v.decode("utf-8", "replace") for k, v in fields.items()
            if k != "file"}
    name = _transcript_model(manager, text.get("model", ""))
    sm = _whisper_for(manager, name)
    try:
        audio = read_wav(audio_bytes)
    except ValueError as e:
        raise APIError(400, str(e)) from None
    result = sm.run("transcribe", audio,
                    language=text.get("language") or None,
                    translate=text.get("translate", "") in ("1", "true"))
    fmt = text.get("response_format", "json")
    if fmt == "text":
        return result["text"] + "\n"
    if fmt == "verbose_json":
        return {"task": "transcribe",
                "duration": result["segments"][-1]["end"]
                if result["segments"] else 0.0,
                "text": result["text"],
                "segments": result["segments"]}
    return {"text": result["text"], "segments": result["segments"]}


def _reference_voice(manager, model_name: str, voice: str):
    """The reference-voice recording of a model's ``tts.audio_path``
    (vall-e-x ``audio_path`` parity): a wav file, or a directory holding
    one ``<voice>.wav`` per voice name. float32 @16 kHz, or None."""
    from localai_tpu_torch.audio.wav import read_wav
    from localai_tpu_torch.utils.paths import verify_path

    mcfg = manager.loader.get(model_name) if model_name else None
    ap = mcfg.tts.audio_path if mcfg is not None else None
    if not ap:
        return None
    base = Path(ap)
    if not base.is_absolute():
        base = Path(manager.app.model_path) / base
    if base.is_dir():
        try:
            # the voice name is caller-supplied — confine it to audio_path
            cand = verify_path(f"{voice}.wav", base)
        except ValueError:
            return None
    else:
        cand = base
    if not cand.is_file():
        return None
    try:
        return read_wav(cand.read_bytes())
    except Exception:  # noqa: BLE001 — bad reference ≠ failed request
        return None


def _tts_params(manager, model_name: str) -> tuple[str, float]:
    """Default voice/speed from the named TTS config, if any."""
    voice, speed = "alloy", 1.0
    mcfg = manager.loader.get(model_name) if model_name else None
    if mcfg is not None and mcfg.tts.voice:
        voice = mcfg.tts.voice
    return voice, speed


def _vits_for(manager, name: str):
    """name → VITS AudioServingModel when the config points at a vits
    checkpoint; None → the parametric synthesiser (a ``debug:`` ref, or a
    non-vits config whose checkpoint is not a vits one)."""
    if not name:
        return None
    mcfg = manager.loader.get(name)
    if mcfg is None:
        return None
    ref = mcfg.model or name
    if ref.startswith("debug:"):
        return None  # debug TTS rides the parametric synth
    if mcfg.backend != "vits":
        from localai_tpu_torch.models.detect import detect_backend

        if detect_backend(ref, manager.app.model_path) != "vits":
            return None
    try:
        return manager.get_vits(name)
    except FileNotFoundError as e:
        raise APIError(404, str(e)) from None


def _speak(manager, text: str, voice: str, speed: float,
           model_name: str = "") -> tuple[str, bytes]:
    from localai_tpu_torch.audio import tts as ttsmod
    from localai_tpu_torch.audio import write_wav

    if not text:
        raise APIError(400, "empty input text")
    device = manager.app.device
    ref_audio = _reference_voice(manager, model_name, voice)
    sm = _vits_for(manager, model_name)
    if sm is None:
        return WAV, write_wav(ttsmod.synthesize(
            text, voice=voice, speed=speed, ref_audio=ref_audio,
            device=device))
    # the neural path; `voice` selects the speaker of a multispeaker
    # model. The model is snapshotted before its cfg is read: an eviction
    # nulls sm.model, and run() raises that case as its error.
    model = sm.model
    if model is None:
        raise RuntimeError(f"vits model {sm.name} was evicted")
    cfg = model.cfg
    spk = spk_emb = None
    if ref_audio is not None and cfg.speaker_embedding_size:
        # voice cloning: reference recording → identity embedding →
        # continuous conditioning (audio.speaker)
        from localai_tpu_torch.audio.speaker import get_speaker_encoder

        enc = get_speaker_encoder(device)
        spk_emb = enc.project(enc.embed(ref_audio),
                              cfg.speaker_embedding_size)
    elif voice.isdigit():
        spk = int(voice)
    wav = sm.run("synthesize", text, speaker_id=spk,
                 speaker_embedding=spk_emb,
                 speaking_rate=cfg.speaking_rate * speed)
    return WAV, write_wav(wav, rate=cfg.sampling_rate)


def speech(manager, body: dict) -> tuple[str, bytes]:
    """POST /v1/audio/speech (OpenAI) and POST /tts (LocalAI)."""
    text = body.get("input") or body.get("text") or ""
    model = body.get("model") or ""
    voice, speed = _tts_params(manager, model)
    voice = body.get("voice") or voice
    try:
        speed = float(body.get("speed") or speed)
    except (TypeError, ValueError):
        raise APIError(400, "speed must be a number") from None
    return _speak(manager, text, voice, speed, model_name=model)


def elevenlabs_tts(manager, body: dict, voice_id: str) -> tuple[str, bytes]:
    """POST /v1/text-to-speech/{voice_id} (Elevenlabs parity)."""
    return _speak(manager, body.get("text") or "", voice_id, 1.0)


def sound_generation(manager, body: dict) -> tuple[str, bytes]:
    """POST /v1/sound-generation (Elevenlabs parity; the reference fans
    out to transformers-musicgen)."""
    from localai_tpu_torch.audio import tts as ttsmod
    from localai_tpu_torch.audio import write_wav

    text = body.get("text") or body.get("input") or ""
    if not text:
        raise APIError(400, "empty input text")
    try:
        duration = float(body.get("duration_seconds") or 3.0)
        temperature = float(body.get("temperature") or 1.0)
    except (TypeError, ValueError):
        raise APIError(400, "duration/temperature must be numbers") from None
    return WAV, write_wav(ttsmod.generate_sound(
        text, duration, temperature, device=manager.app.device))

