"""Model lifecycle: config → live engine (runner + scheduler + tokenizer).

Port of ``localai_tpu/models/manager.py::build_runner`` /
``build_serving_model`` and ``ServingModel`` for one device, plus a small
thread-safe ``ModelManager`` that loads each configured model on first
use. The engine is always the paged layout; speculative decoding, the
prompt cache and the self-healing supervisor are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Optional

from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.loader import ConfigLoader
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.engine.runner import ModelRunner
from localai_tpu_torch.engine.scheduler import Scheduler
from localai_tpu_torch.models.registry import LoadedModel, resolve_model

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ServingModel:
    """One loaded model: engine + tokenizer + its declarative config."""

    name: str
    config: ModelConfig
    runner: ModelRunner
    scheduler: Scheduler
    tokenizer: Any
    loaded_at: float = dataclasses.field(default_factory=time.monotonic)

    def close(self) -> None:
        self.scheduler.shutdown()


def build_runner(mcfg: ModelConfig, app: AppConfig,
                 ) -> tuple[LoadedModel, ModelRunner]:
    """Config → (resolved model, live ModelRunner) on ``app.device``."""
    mcfg.check_supported()
    eng = mcfg.engine
    model = resolve_model(mcfg.model or mcfg.name,
                          model_path=app.model_path, dtype=eng.dtype,
                          seed=mcfg.seed or 0, device=app.device)
    ctx = min(mcfg.context_size or app.context_size,
              model.cfg.max_position_embeddings)
    runner = ModelRunner(
        model.cfg, model.params,
        num_slots=eng.max_slots,
        max_ctx=ctx,
        kv_dtype=eng.kv_dtype,
        rope_freq_base=mcfg.rope_freq_base,
        rope_freq_scale=mcfg.rope_freq_scale,
        seed=mcfg.seed or 0,
        kv_block_tokens=eng.kv_block_tokens,
        prefill_chunk=eng.prefill_chunk,
        device=app.device,
    )
    return model, runner


def build_serving_model(mcfg: ModelConfig, app: AppConfig) -> ServingModel:
    """Config → live engine: weights, runner, scheduler, tokenizer."""
    t0 = time.monotonic()
    model, runner = build_runner(mcfg, app)
    eng = mcfg.engine
    scheduler = Scheduler(
        runner, model.tokenizer,
        default_max_tokens=mcfg.parameters.max_tokens or 2048,
        multi_step=eng.decode_steps_per_dispatch,
    )
    log.info("loaded model %s (%s) in %.1fs on %s: slots=%d ctx=%d "
             "attention=%s", mcfg.name, mcfg.model, time.monotonic() - t0,
             runner.device, eng.max_slots, runner.max_ctx,
             runner.paged_attn_impl)
    return ServingModel(name=mcfg.name, config=mcfg, runner=runner,
                        scheduler=scheduler, tokenizer=model.tokenizer)


class ModelManager:
    """Thread-safe registry of loaded models (loaded on first use)."""

    def __init__(self, app: Optional[AppConfig] = None,
                 loader: Optional[ConfigLoader] = None):
        self.app = app or AppConfig()
        self.loader = loader or ConfigLoader(self.app.model_path)
        self._models: dict[str, ServingModel] = {}
        self._lock = threading.Lock()

    def loaded_names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def get(self, name: str) -> ServingModel:
        """Load-or-get; one load at a time (a load holds the card)."""
        with self._lock:
            sm = self._models.get(name)
            if sm is None:
                mcfg = self.loader.get(name)
                if mcfg is None:
                    raise KeyError(name)
                sm = build_serving_model(mcfg, self.app)
                self._models[name] = sm
            return sm

    def shutdown(self) -> None:
        with self._lock:
            models, self._models = list(self._models.values()), {}
        for sm in models:
            sm.close()
