"""Serving facade for the recurrent-state models (Mamba, RWKV).

Port of ``localai_tpu/models/mamba_serving.py``: a model with O(1)
recurrent state a stream has no KV cache, so the llama engine's slots and
pages do not apply. Each request generates on a thread of its own, and a
model-wide lock runs the generations one at a time (as the JAX package,
and the mamba backend process it mirrors, do). The HTTP endpoints see the
usual ``scheduler.submit → GenHandle`` contract: text deltas through the
port's ``IncrementalDetokenizer`` and ``StopChecker``, EOS from the
tokenizer and the model config, and the finish reasons "length", "stop",
"cancelled" and "error". A request's constraint (tools, JSON mode) is
ignored here, as in the JAX package.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time

from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest
from localai_tpu_torch.engine.stream import IncrementalDetokenizer, StopChecker
from localai_tpu_torch.templates.cache import TemplateCache

log = logging.getLogger(__name__)


class _Stopped(Exception):
    pass


class _Cancelled(Exception):
    pass


class MambaScheduler:
    """``submit()`` runs the generation on a daemon thread feeding the
    handle; a model-wide lock serialises generations."""

    def __init__(self, lm, tokenizer):
        self.lm = lm
        self.tokenizer = tokenizer
        self._ids = itertools.count()
        self._gen_lock = threading.Lock()
        self._inflight = 0
        self._lock = threading.Lock()
        self.total_generated = 0

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def submit(self, gr: GenRequest) -> GenHandle:
        handle = GenHandle(gr, next(self._ids))
        with self._lock:
            self._inflight += 1
        threading.Thread(target=self._run, args=(handle,), daemon=True,
                         name=f"mamba-{handle.id}").start()
        return handle

    def _run(self, handle: GenHandle) -> None:
        gr = handle.request
        budget = gr.max_new_tokens or 256
        try:
            detok = IncrementalDetokenizer(self.tokenizer.decode)
            stopper = StopChecker(gr.stop)
            eos = set() if gr.ignore_eos else set(
                getattr(self.tokenizer, "eos_ids", set())
            ) | {self.lm.cfg.eos_token_id}

            def on_token(t: int) -> None:
                if handle.cancelled:
                    raise _Cancelled
                handle._emit(stopper.push(detok.push(t)), t)
                if stopper.stopped is not None:
                    raise _Stopped

            finish = "length"
            with self._gen_lock:
                try:
                    self.lm.generate(gr.prompt, max_new_tokens=budget,
                                     temperature=gr.temperature or 0.0,
                                     seed=gr.seed or 0, eos_ids=eos,
                                     on_token=on_token)
                except _Stopped:
                    finish = "stop"
                except _Cancelled:
                    finish = "cancelled"
            handle._emit(stopper.flush(), None)
            if finish == "length" and len(handle.token_ids) < budget:
                finish = "stop"  # ended on EOS before the budget
            with self._lock:
                self.total_generated += len(handle.token_ids)
            handle._finish(finish)
        except Exception as e:  # noqa: BLE001 — a request error, not a crash
            log.warning("recurrent generation failed: %s", e)
            handle._finish("error")
        finally:
            with self._lock:
                self._inflight -= 1

    def metrics(self) -> dict:
        with self._lock:
            return {"type": "mamba", "inflight": self._inflight,
                    "total_generated_tokens": self.total_generated}

    def shutdown(self, timeout: float = 10.0) -> None:
        pass


class MambaServingModel:
    """The serving model of ``backend: mamba`` and ``backend: rwkv`` (both
    expose the ``generate`` surface of ``MambaLM``/``RwkvLM``), on
    ``app.device`` in the engine's dtype."""

    def __init__(self, mcfg: ModelConfig, app: AppConfig):
        t0 = time.monotonic()
        self.name = mcfg.name
        self.config = mcfg
        if mcfg.backend == "rwkv":
            from localai_tpu_torch.models.rwkv import resolve_rwkv as resolve
        else:
            from localai_tpu_torch.models.mamba import (
                resolve_mamba as resolve,
            )
        self.lm = resolve(mcfg.model or mcfg.name, model_path=app.model_path,
                          dtype=mcfg.engine.dtype, seed=mcfg.seed or 0,
                          device=app.device)
        self.tokenizer = self.lm.tokenizer
        self.templates = TemplateCache(app.model_path)
        self.vision = None
        self.image_token_id = 0
        self.scheduler = MambaScheduler(self.lm, self.tokenizer)
        self.loaded_at = time.monotonic()
        self.last_used = time.monotonic()
        log.info("loaded %s model %s in %.1fs on %s", mcfg.backend or "mamba",
                 mcfg.name, time.monotonic() - t0, self.lm.device)

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def alive(self) -> bool:
        return self.lm is not None

    def engine_metrics(self) -> dict:
        return self.scheduler.metrics()

    def close(self) -> None:
        self.lm = None
