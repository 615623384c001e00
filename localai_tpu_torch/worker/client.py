"""WorkerClient: the typed client of a worker.

Port of ``localai_tpu/worker/client.py`` over the port's transport
(``worker.rpc``): per-call busy marking for the watchdog, calls
serialised when parallel requests are off, and a default deadline on every
call: control-plane calls (health and status 5 s, metrics 10 s, tokenize,
stores and telemetry ``CONTROL_TIMEOUT_S``) a short one, work-shaped calls
(predict, load, media) ``WORK_TIMEOUT_S``. A peer that dies without a
reset fails a call in flight within about 40 s (the transport's TCP
keepalive); streams are also bounded per reply by the fleet
(``fleet.net.bounded_stream``), since their total deadline must stay at
the scale of a generation.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Iterator, Optional

from localai_tpu_torch.worker import backend_pb2 as pb
from localai_tpu_torch.worker import rpc
from localai_tpu_torch.worker.rpc import BackendStub, RpcError

# work-shaped calls (generation, model load, media): bounded at the scale
# of the work itself
WORK_TIMEOUT_S = 600.0
# control-plane calls: a wedged peer must cost seconds on these paths
CONTROL_TIMEOUT_S = 60.0


class WorkerClient:
    def __init__(self, address: str, *, parallel: bool = True,
                 watchdog: Optional[Any] = None):
        self.address = address
        self._channel = rpc.Channel(address)
        self._stub = BackendStub(self._channel)
        # parallel=False serialises every call (--parallel-requests off)
        self._op_lock = threading.Lock() if not parallel else None
        self._watchdog = watchdog
        self.busy = False

    # -- busy/watchdog bookkeeping ---------------------------------------

    def _enter(self):
        if self._op_lock is not None:
            self._op_lock.acquire()
        self.busy = True
        if self._watchdog is not None:
            self._watchdog.mark(self.address)

    def _exit(self):
        self.busy = False
        if self._watchdog is not None:
            self._watchdog.unmark(self.address)
        if self._op_lock is not None:
            self._op_lock.release()

    def _call(self, fn: Callable, request, timeout: Optional[float] = None,
              metadata: Optional[tuple] = None):
        self._enter()
        try:
            return fn(request, timeout=timeout, metadata=metadata)
        finally:
            self._exit()

    # -- the calls --------------------------------------------------------

    def health(self, timeout: float = 5.0) -> bool:
        try:
            reply = self._stub.Health(pb.HealthMessage(), timeout=timeout)
            return reply.message == b"OK"
        except RpcError:
            return False

    def load_model(self, *, model: str = "", config_yaml: str = "",
                   model_path: str = "", context_size: int = 0,
                   seed: int = 0, timeout: float = WORK_TIMEOUT_S):
        return self._call(self._stub.LoadModel, pb.ModelOptions(
            model=model, config_yaml=config_yaml, model_path=model_path,
            context_size=context_size, seed=seed,
        ), timeout)

    def predict(self, opts, timeout: float = WORK_TIMEOUT_S,
                trace_id: str = ""):
        return self._call(self._stub.Predict, opts, timeout,
                          metadata=rpc.trace_metadata(trace_id) or None)

    def predict_stream(self, opts, timeout: float = WORK_TIMEOUT_S,
                       trace_id: str = "", tenant: str = "") -> Iterator:
        self._enter()
        try:
            yield from self._stub.PredictStream(
                opts, timeout=timeout,
                metadata=(rpc.trace_metadata(trace_id)
                          + rpc.tenant_metadata(tenant)) or None,
            )
        finally:
            self._exit()

    def prefill_prefix(self, opts, timeout: float = WORK_TIMEOUT_S,
                       trace_id: str = "") -> Iterator:
        """Run a prefill on this (prefill-role) replica and stream back its
        packed KV-prefix chunks (fleet disaggregation)."""
        self._enter()
        try:
            yield from self._stub.PrefillPrefix(
                opts, timeout=timeout,
                metadata=rpc.trace_metadata(trace_id) or None,
            )
        finally:
            self._exit()

    def transfer_prefix(self, chunks: Iterator, timeout: float = WORK_TIMEOUT_S,
                        trace_id: str = ""):
        """Stream prefix chunks into this (decode-role) replica's cache."""
        return self._call(self._stub.TransferPrefix, chunks, timeout,
                          metadata=rpc.trace_metadata(trace_id) or None)

    def embedding(self, text: str = "", tokens: Optional[list[int]] = None,
                  timeout: float = WORK_TIMEOUT_S) -> list[float]:
        res = self._call(self._stub.Embedding, pb.EmbeddingRequest(
            text=text, tokens=tokens or []), timeout)
        return list(res.embeddings)

    def tokenize(self, text: str, add_bos: bool = False,
                 timeout: float = CONTROL_TIMEOUT_S) -> list[int]:
        res = self._call(self._stub.TokenizeString, pb.TokenizationRequest(
            text=text, add_bos=add_bos), timeout)
        return list(res.tokens)

    def status(self, timeout: float = 5.0):
        return self._stub.Status(pb.HealthMessage(), timeout=timeout)

    def metrics(self, timeout: float = 10.0) -> dict:
        res = self._stub.GetMetrics(pb.MetricsRequest(), timeout=timeout)
        return json.loads(res.json or "{}")

    def get_telemetry(self, *, trace_id: str = "", since: float = 0.0,
                      limit: int = 256, recent: int = 20,
                      timeout: float = CONTROL_TIMEOUT_S) -> dict:
        """Harvest this worker's telemetry pane (trace spans for one trace
        id or a recent window, flight-ring snapshot, scheduler metrics).
        Proto3 cannot tell an explicit 0 from unset, so "no flight
        records" / "no recent traces" travel as -1: the servicer maps
        0/unset to its defaults and negatives to zero."""
        res = self._stub.GetTelemetry(pb.TelemetryRequest(
            trace_id=trace_id, since=since,
            limit=limit if limit > 0 else -1,
            recent=recent if recent > 0 else -1,
        ), timeout=timeout)
        return json.loads(res.json or "{}")

    def tts(self, text: str, *, voice: str = "", language: str = "",
            dst: str = "", timeout: float = WORK_TIMEOUT_S):
        return self._call(self._stub.TTS, pb.TTSRequest(
            text=text, voice=voice, language=language, dst=dst), timeout)

    def sound_generation(self, text: str, *, duration: Optional[float] = None,
                         dst: str = "", timeout: float = WORK_TIMEOUT_S):
        return self._call(self._stub.SoundGeneration, pb.SoundGenerationRequest(
            text=text, dst=dst, duration=duration), timeout)

    def transcribe(self, *, path: str = "", audio: bytes = b"",
                   language: str = "", translate: bool = False,
                   timeout: float = WORK_TIMEOUT_S):
        return self._call(self._stub.AudioTranscription, pb.TranscriptRequest(
            path=path, audio=audio, language=language, translate=translate,
        ), timeout)

    def generate_image(self, prompt: str, *, negative: str = "",
                       width: int = 512, height: int = 512, step: int = 0,
                       seed: int = 0, dst: str = "",
                       timeout: float = WORK_TIMEOUT_S):
        return self._call(self._stub.GenerateImage, pb.GenerateImageRequest(
            positive_prompt=prompt, negative_prompt=negative,
            width=width, height=height, step=step, seed=seed, dst=dst,
        ), timeout)

    def rerank(self, query: str, documents: list[str], top_n: int = 0,
               timeout: float = WORK_TIMEOUT_S):
        return self._call(self._stub.Rerank, pb.RerankRequest(
            query=query, documents=documents, top_n=top_n), timeout)

    def stores_set(self, keys: list[list[float]], values: list[bytes],
                   timeout: float = CONTROL_TIMEOUT_S):
        return self._call(self._stub.StoresSet, pb.StoresSetOptions(
            keys=[pb.StoresKey(floats=k) for k in keys],
            values=[pb.StoresValue(bytes=v) for v in values],
        ), timeout)

    def stores_get(self, keys: list[list[float]],
                   timeout: float = CONTROL_TIMEOUT_S):
        return self._call(self._stub.StoresGet, pb.StoresGetOptions(
            keys=[pb.StoresKey(floats=k) for k in keys]), timeout)

    def stores_find(self, key: list[float], top_k: int,
                    timeout: float = CONTROL_TIMEOUT_S):
        return self._call(self._stub.StoresFind, pb.StoresFindOptions(
            key=pb.StoresKey(floats=key), top_k=top_k), timeout)

    def stores_delete(self, keys: list[list[float]],
                      timeout: float = CONTROL_TIMEOUT_S):
        return self._call(self._stub.StoresDelete, pb.StoresDeleteOptions(
            keys=[pb.StoresKey(floats=k) for k in keys]), timeout)

    def close(self) -> None:
        self._channel.close()
