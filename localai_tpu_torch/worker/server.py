"""The model worker: one process, one loaded model, the worker contract.

Port of ``localai_tpu/worker/server.py``. The serving instance spawns one
of these per model (``worker.process``), so an engine crash never takes
down the API, and external workers can serve the same contract
(``worker.rpc.METHODS``). Inside the process the engine is the port's
``ModelRunner`` + ``Scheduler`` (``models.manager.build_serving_model``);
the worker adds only the wire surface over the port's transport.

``LoadModel`` reads its ``config_yaml`` with the port's YAML reader and
builds its ``AppConfig`` from the worker's environment, so a worker runs
on the card unless ``LOCALAI_DEVICE=cpu`` says otherwise (the JAX
servicer's device is JAX's). ``gen_request_from_options`` is the one
request decoder of every replica kind, in-process fleet replicas
included.

``python -m localai_tpu_torch.worker.server --addr HOST:PORT --servicer
llm|store|audio|image`` prints ``WORKER_READY port=<n>`` once bound, arms
``LOCALAI_FAULT_*`` at boot, and on SIGTERM stops the engine before the
transport, then prints ``WORKER_LAUNCHES {json}``: the launch counts of
this process's kernel wrappers (``launches``) beside its engine's decode
steps, verify windows, prefill chunks and Embedding calls, read at the
same moment (the serving instance cannot count the kernels another
process launches).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Iterator, Optional

from localai_tpu_torch.faults import registry as _faults
from localai_tpu_torch.worker import backend_pb2 as pb
from localai_tpu_torch.worker import rpc
from localai_tpu_torch.worker.rpc import StatusCode

log = logging.getLogger(__name__)


def gen_request_from_options(req, sm, trace_id: str = "",
                             tenant: str = ""):
    """``PredictOptions`` → GenRequest against a serving model (the
    inverse of ``worker.serving.predict_options``)."""
    from localai_tpu_torch.engine.scheduler import GenRequest

    if req.tokens:
        prompt = list(req.tokens)
    else:
        prompt = sm.tokenizer.encode(req.prompt, add_bos=req.add_bos)
    constraint = None
    if req.constraint_schema:
        from localai_tpu_torch.functions.constraint import (
            constraint_for_schema,
        )

        constraint = constraint_for_schema(
            json.loads(req.constraint_schema), sm.tokenizer)
    elif req.constraint_regex:
        from localai_tpu_torch.functions.constraint import (
            constraint_for_regex,
        )

        constraint = constraint_for_regex(req.constraint_regex, sm.tokenizer)
    return GenRequest(
        prompt=prompt,
        max_new_tokens=req.max_tokens or 2048,
        temperature=req.temperature,
        top_k=req.top_k,
        top_p=req.top_p,
        min_p=req.min_p,
        repeat_penalty=req.repeat_penalty,
        presence_penalty=req.presence_penalty,
        frequency_penalty=req.frequency_penalty,
        seed=req.seed,
        logit_bias=dict(req.logit_bias) or None,
        stop=tuple(req.stop),
        ignore_eos=req.ignore_eos,
        constraint=constraint,
        correlation_id=req.correlation_id,
        # the engine's spans record under the front door's trace id
        trace_id=trace_id or req.correlation_id,
        # the hashed tenant bucket of the usage ledger; an in-process
        # replica's resubmit leaves it empty, so the fleet's front-door
        # request is the one the ledger counts
        tenant=tenant,
        stream=req.stream,
    )


def _import_engine() -> None:
    import localai_tpu_torch.models.manager  # noqa: F401


def _app_config(model_path: str):
    from localai_tpu_torch.config.app_config import AppConfig

    return AppConfig.from_env(model_path=model_path or "models")


class BackendServicer:
    """LLM worker: Predict/PredictStream/Embedding + lifecycle calls. The
    modality calls are absent (``rpc.add_servicer`` answers
    UNIMPLEMENTED); the audio, image and store servicers serve them."""

    def __init__(self) -> None:
        self._sm: Optional[Any] = None  # ServingModel
        self._load_error = ""
        self._lock = threading.Lock()
        self.embeddings = 0          # Embedding calls served
        # the engine's modules (torch among them, seconds of imports) load
        # in the background from the start, so a worker that waits for
        # its LoadModel (a remote one, started ahead) has them by then
        threading.Thread(target=_import_engine, daemon=True,
                         name="worker-preload").start()
        self._final = {"decode_steps": 0, "verify_windows": 0,
                       "prefill_chunks": 0, "embeddings": 0}

    # -- lifecycle -------------------------------------------------------

    def Health(self, request, context):
        return pb.Reply(message=b"OK")

    def LoadModel(self, request, context):
        t0 = time.monotonic()
        from localai_tpu_torch.config.model_config import ModelConfig
        from localai_tpu_torch.config.yaml_subset import safe_load
        from localai_tpu_torch.models.manager import build_serving_model

        log.info("LoadModel: engine modules ready after %.1fs",
                 time.monotonic() - t0)
        with self._lock:
            if self._sm is not None:
                return pb.Result(success=True, message="already loaded")
            try:
                if request.config_yaml:
                    doc = safe_load(request.config_yaml) or {}
                else:
                    doc = {"name": request.model or "model",
                           "model": request.model}
                if request.model:
                    doc.setdefault("model", request.model)
                if request.context_size:
                    doc["context_size"] = request.context_size
                if request.seed:
                    doc["seed"] = request.seed
                mcfg = ModelConfig.from_dict(doc)
                self._sm = build_serving_model(
                    mcfg, _app_config(request.model_path))
                return pb.Result(success=True, message="ok")
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._load_error = f"{type(e).__name__}: {e}"
                log.exception("LoadModel failed")
                return pb.Result(success=False, message=self._load_error)

    # _sm and _load_error are single assignments made by LoadModel under
    # the lock; the serving paths read them without it (None, or a whole
    # model)
    def Status(self, request, context):
        if self._sm is None:
            state = (pb.StatusResponse.ERROR if self._load_error
                     else pb.StatusResponse.UNINITIALIZED)
            return pb.StatusResponse(state=state)
        busy = self._sm.scheduler.busy
        state = pb.StatusResponse.BUSY if busy else pb.StatusResponse.READY
        mem = {}
        try:
            import resource

            mem["maxrss_kb"] = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss
        except Exception:  # noqa: BLE001
            pass
        return pb.StatusResponse(state=state, memory=mem)

    def GetMetrics(self, request, context):
        if self._sm is None:
            return pb.MetricsResponse(json="{}")
        payload = self._sm.scheduler.metrics()
        # the worker has no HTTP surface, so its engine span trees ride
        # the metrics JSON (the API tier shows them at /backend/metrics)
        from localai_tpu_torch.obs.trace import STORE

        payload["recent_traces"] = [
            t.to_dict() for t in STORE.recent(limit=20, kind="request")
        ]
        return pb.MetricsResponse(json=json.dumps(payload))

    def GetTelemetry(self, request, context):
        """This replica's spans for one trace id (or a recent window), its
        flight-ring snapshot and its scheduler metrics, all host-side
        (``obs.fleetview.telemetry_payload``, shared with in-process
        replicas)."""
        from localai_tpu_torch.obs.fleetview import telemetry_payload

        sched = self._sm.scheduler if self._sm is not None else None
        # 0/unset → defaults; -1 is the client's explicit "none"
        payload = telemetry_payload(
            sched, trace_id=request.trace_id, since=request.since,
            limit=max(0, request.limit or 256),
            recent=max(0, request.recent or 20))
        return pb.TelemetryResponse(json=json.dumps(payload))

    # -- inference -------------------------------------------------------

    def _require_model(self, context):
        if self._sm is None:
            context.abort(
                StatusCode.FAILED_PRECONDITION,
                self._load_error or "no model loaded (call LoadModel first)",
            )
        return self._sm

    def _gen_request(self, req, sm, context):
        return gen_request_from_options(
            req, sm, trace_id=rpc.trace_id_from_context(context),
            tenant=rpc.tenant_from_context(context))

    def Predict(self, request, context):
        sm = self._require_model(context)
        handle = sm.scheduler.submit(self._gen_request(request, sm, context))
        try:
            handle.result(timeout=600.0)
        finally:
            if handle.finish_reason is None:
                # timeout or abandoned call: free the decode slot
                handle.cancel()
        return pb.Reply(
            message=handle.text.encode("utf-8"),
            tokens=handle.completion_tokens,
            prompt_tokens=handle.prompt_tokens,
            finish_reason=handle.finish_reason or "stop",
        )

    def PredictStream(self, request, context) -> Iterator:
        sm = self._require_model(context)
        handle = sm.scheduler.submit(self._gen_request(request, sm, context))
        # a client that goes away cancels the request at once, even while
        # it waits for its first token (the context runs this at the end
        # of every call; a finished handle ignores it)
        context.add_callback(
            lambda: handle.finish_reason is None and handle.cancel())
        try:
            for item in handle:
                if _faults.ACTIVE:
                    # a worker stream that errors (raise) or crawls (sleep)
                    # mid-flight: the caller's failover paths absorb it
                    _faults.apply("worker.stream", key=sm.name)
                if item.finish_reason is not None:
                    yield pb.Reply(
                        message=b"",
                        tokens=handle.completion_tokens,
                        prompt_tokens=handle.prompt_tokens,
                        finish_reason=item.finish_reason,
                    )
                    break
                if item.delta:
                    yield pb.Reply(message=item.delta.encode("utf-8"))
        finally:
            if not context.is_active():
                handle.cancel()

    # -- fleet disaggregation (fleet) ------------------------------------

    def _fleet_cache(self, sm):
        """The replica's in-memory prefix cache, attached at first
        PrefillPrefix/TransferPrefix use. A configured disk prompt cache
        lacks the ``wait_for`` signalling the export blocks on, so the RAM
        tier fronts it (``attach_prompt_cache(layer=True)``)."""
        sched = sm.scheduler
        if not hasattr(sched.prompt_cache, "wait_for"):
            from localai_tpu_torch.fleet.prefix import PrefixCache

            with self._lock:
                if not hasattr(sched.prompt_cache, "wait_for"):
                    sched.attach_prompt_cache(PrefixCache(
                        min_prefix=getattr(sm.runner, "prefix_reuse_min",
                                           16)), layer=True)
        return sched.prompt_cache

    def PrefillPrefix(self, request, context) -> Iterator:
        """Prefill-replica half of the handoff: run the prompt's prefill
        (one sampled token, then the slot frees), wait for the off-thread
        prefix export, stream the packed KV rows out in chunks."""
        from localai_tpu_torch.fleet.prefix import (
            PrefixUnavailable,
            export_prefix,
            pack_chunks,
        )

        sm = self._require_model(context)
        cache = self._fleet_cache(sm)
        gr = gen_request_from_options(
            request, sm, trace_id=rpc.trace_id_from_context(context))
        try:
            prompt, arrays = export_prefix(sm, gr, cache)
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        except PrefixUnavailable as e:
            context.abort(StatusCode.FAILED_PRECONDITION, str(e))
        except RuntimeError as e:
            context.abort(StatusCode.INTERNAL, str(e))
        for chunk in pack_chunks(prompt, arrays):
            yield pb.PrefixChunk(**chunk)

    def TransferPrefix(self, request_iterator, context):
        """Decode-replica half: assemble the streamed chunks and seed the
        prefix cache; the next PredictStream for this prompt resumes past
        the transferred rows at admission."""
        from localai_tpu_torch.fleet.prefix import import_prefix

        sm = self._require_model(context)
        cache = self._fleet_cache(sm)
        try:
            n = import_prefix(cache, request_iterator)
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Result(success=True, message=f"{n} rows")

    def Embedding(self, request, context):
        sm = self._require_model(context)
        if request.tokens:
            toks = list(request.tokens)
        else:
            toks = sm.tokenizer.encode(request.text, add_bos=True)
        vec = sm.runner.embed(toks)
        with self._lock:
            self.embeddings += 1
        return pb.EmbeddingResult(embeddings=[float(x) for x in vec])

    def TokenizeString(self, request, context):
        sm = self._require_model(context)
        ids = sm.tokenizer.encode(request.text, add_bos=request.add_bos)
        return pb.TokenizationResponse(length=len(ids), tokens=ids)

    def counters(self) -> dict:
        """The engine's step counters and the Embedding calls (the launch
        report's denominators); after ``shutdown``, those it stopped at."""
        r = self._sm.runner if self._sm is not None else None
        if r is None:
            return dict(self._final)
        return {"decode_steps": r.decode_steps,
                "verify_windows": r.verify_windows,
                "prefill_chunks": r.prefill_chunks,
                "embeddings": self.embeddings}

    def shutdown(self) -> None:
        with self._lock:
            if self._sm is not None:
                self._sm.scheduler.shutdown()
                self._final = self.counters()
                self._sm = None


class StoreServicer:
    """A standalone vector-store worker (the Stores calls)."""

    def __init__(self) -> None:
        from localai_tpu_torch.stores import VectorStore

        self._store = VectorStore(device=_app_config("").device)

    def Health(self, request, context):
        return pb.Reply(message=b"OK")

    def LoadModel(self, request, context):
        return pb.Result(success=True, message="store ready")

    def Status(self, request, context):
        return pb.StatusResponse(state=pb.StatusResponse.READY)

    def StoresSet(self, request, context):
        try:
            self._store.set([list(k.floats) for k in request.keys],
                            [v.bytes for v in request.values])
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Result(success=True)

    def StoresDelete(self, request, context):
        try:
            self._store.delete([list(k.floats) for k in request.keys])
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Result(success=True)

    def StoresGet(self, request, context):
        try:
            keys, values = self._store.get(
                [list(k.floats) for k in request.keys])
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        out = pb.StoresGetResult()
        for k, v in zip(keys, values):
            if v is None:
                continue
            out.keys.append(pb.StoresKey(floats=list(k)))
            out.values.append(pb.StoresValue(bytes=v))
        return out

    def StoresFind(self, request, context):
        if request.top_k < 0:
            context.abort(StatusCode.INVALID_ARGUMENT, "top_k must be >= 1")
        key = request.key.floats if request.key is not None else []
        try:
            keys, values, sims = self._store.find(list(key),
                                                  request.top_k or 10)
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        out = pb.StoresFindResult(similarities=list(sims))
        for k, v in zip(keys, values):
            out.keys.append(pb.StoresKey(floats=list(k)))
            out.values.append(pb.StoresValue(bytes=v))
        return out

    def shutdown(self) -> None:
        pass


class AudioServicer:
    """Audio worker: AudioTranscription, TTS and SoundGeneration."""

    def __init__(self) -> None:
        self._whisper = None
        self._device = _app_config("").device
        self._lock = threading.Lock()

    def Health(self, request, context):
        return pb.Reply(message=b"OK")

    def Status(self, request, context):
        return pb.StatusResponse(state=pb.StatusResponse.READY)

    def LoadModel(self, request, context):
        from pathlib import Path

        from localai_tpu_torch.models import whisper as wh

        with self._lock:
            try:
                ref = request.model or "debug:whisper"
                if ref.startswith("debug:"):
                    self._whisper = wh.debug_model(seed=request.seed,
                                                   device=self._device)
                else:
                    base = Path(request.model_path or "models")
                    cand = Path(ref) if Path(ref).is_dir() else base / ref
                    self._whisper = wh.load_hf_whisper(cand,
                                                       device=self._device)
                return pb.Result(success=True, message="ok")
            except Exception as e:  # noqa: BLE001
                log.exception("audio LoadModel failed")
                return pb.Result(success=False,
                                 message=f"{type(e).__name__}: {e}")

    def AudioTranscription(self, request, context):
        from localai_tpu_torch.audio import read_wav

        if self._whisper is None:
            context.abort(StatusCode.FAILED_PRECONDITION,
                          "no model loaded (call LoadModel first)")
        data = request.audio
        if not data and request.path:
            try:
                with open(request.path, "rb") as f:
                    data = f.read()
            except OSError as e:
                context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        try:
            audio = read_wav(data)
        except ValueError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        res = self._whisper.transcribe(
            audio, language=request.language or None,
            translate=request.translate)
        out = pb.TranscriptResult(text=res["text"])
        for seg in res["segments"]:
            out.segments.append(pb.TranscriptSegment(
                id=seg["id"], start=int(seg["start"] * 1e9),
                end=int(seg["end"] * 1e9), text=seg["text"],
                tokens=list(seg["tokens"])))
        return out

    def _reply(self, wav: bytes, dst: str):
        if dst:
            with open(dst, "wb") as f:
                f.write(wav)
            return pb.AudioResult(success=True, message=dst)
        return pb.AudioResult(success=True, audio=wav)

    def TTS(self, request, context):
        from localai_tpu_torch.audio import tts as ttsmod
        from localai_tpu_torch.audio import write_wav

        if not request.text:
            context.abort(StatusCode.INVALID_ARGUMENT, "empty text")
        return self._reply(write_wav(ttsmod.synthesize(
            request.text, voice=request.voice or "alloy",
            device=self._device)), request.dst)

    def SoundGeneration(self, request, context):
        from localai_tpu_torch.audio import tts as ttsmod
        from localai_tpu_torch.audio import write_wav

        if not request.text:
            context.abort(StatusCode.INVALID_ARGUMENT, "empty text")
        dur = request.duration if request.duration is not None else 3.0
        temp = (request.temperature if request.temperature is not None
                else 1.0)
        return self._reply(write_wav(ttsmod.generate_sound(
            request.text, dur, temp, device=self._device)), request.dst)

    def shutdown(self) -> None:
        pass


class ImageServicer:
    """Image-generation worker behind GenerateImage."""

    def __init__(self) -> None:
        self._pipe = None
        self._lock = threading.Lock()

    def Health(self, request, context):
        return pb.Reply(message=b"OK")

    def Status(self, request, context):
        return pb.StatusResponse(state=pb.StatusResponse.READY)

    def LoadModel(self, request, context):
        from localai_tpu_torch.image.pipeline import resolve_image_model

        with self._lock:
            try:
                self._pipe = resolve_image_model(
                    request.model or "debug:sd-tiny",
                    model_path=request.model_path or "models",
                    device=_app_config("").device)
                return pb.Result(success=True, message="ok")
            except Exception as e:  # noqa: BLE001
                log.exception("image LoadModel failed")
                return pb.Result(success=False,
                                 message=f"{type(e).__name__}: {e}")

    def GenerateImage(self, request, context):
        from localai_tpu_torch.utils import png

        if self._pipe is None:
            context.abort(StatusCode.FAILED_PRECONDITION,
                          "no model loaded (call LoadModel first)")
        try:
            result = self._pipe.generate(
                request.positive_prompt,
                negative_prompt=request.negative_prompt,
                width=request.width or 512,
                height=request.height or 512,
                steps=request.step or None,
                seed=request.seed if request.seed else None,
                cfg_scale=request.cfg_scale,
            )
        except Exception as e:  # noqa: BLE001
            log.exception("GenerateImage failed")
            return pb.ImageResult(success=False,
                                  message=f"{type(e).__name__}: {e}")
        data = png.encode(result.image)
        if request.dst:
            with open(request.dst, "wb") as f:
                f.write(data)
            return pb.ImageResult(success=True, message=request.dst)
        return pb.ImageResult(success=True, image=data)

    def shutdown(self) -> None:
        pass


SERVICERS = {
    "llm": BackendServicer,
    "store": StoreServicer,
    "audio": AudioServicer,
    "image": ImageServicer,
}


def serve_worker(addr: str = "127.0.0.1:0",
                 servicer: Optional[Any] = None,
                 block: bool = True) -> tuple[rpc.Server, int]:
    """Start the worker's server. Returns (server, bound port)."""
    servicer = servicer or BackendServicer()
    server = rpc.Server(max_workers=32)
    rpc.add_servicer(server, servicer)
    try:
        port = server.add_insecure_port(addr)
    except OSError as e:
        raise RuntimeError(f"could not bind worker to {addr}: {e}") from None
    server.start()
    log.info("worker listening on port %d", port)
    if block:
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        stop.wait()
        if hasattr(servicer, "shutdown"):
            servicer.shutdown()
        server.stop(grace=5.0).wait(10.0)
    return server, port


def launch_counts() -> dict:
    """This process's kernel wrappers' launch counts (K1–K5 and the expert
    grid), by wrapper name."""
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )
    from localai_tpu_torch.ops.qmatmul import (
        w4_matmul,
        w8_matmul,
        w8_matmul_experts,
    )

    return {fn.__name__: fn.launches
            for fn in (paged_decode_attention, decode_attention,
                       prefill_attention, w8_matmul, w4_matmul,
                       w8_matmul_experts)}


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="localai-tpu model worker")
    parser.add_argument("--addr", default="127.0.0.1:0",
                        help="host:port to bind (port 0 = ephemeral)")
    parser.add_argument("--servicer", default="llm",
                        help=f"which servicer to run ({'/'.join(SERVICERS)})")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("LOCALAI_LOG_LEVEL", "INFO").upper(),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    # deterministic fault injection: LOCALAI_FAULT_* in a spawned worker's
    # environment arms its registry at boot, never per request
    _faults.install_from_env()
    if args.servicer not in SERVICERS:
        parser.error(f"unknown servicer {args.servicer!r}; "
                     f"have {sorted(SERVICERS)}")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    servicer = SERVICERS[args.servicer]()
    server, port = serve_worker(args.addr, servicer=servicer, block=False)
    # the parent's process manager reads the bound port from this line
    print(f"WORKER_READY port={port}", flush=True)
    stop.wait()
    # stop the engine thread before the transport, so no handler is
    # mid-flight on a freed engine; the counters are read once it stopped
    servicer.shutdown()
    report = {"launches": launch_counts(),
              **getattr(servicer, "counters", dict)()}
    server.stop(grace=2.0).wait(5.0)
    print(f"WORKER_LAUNCHES {json.dumps(report)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
