"""Remote inference-API client: serve a model hosted elsewhere.

Port of ``localai_tpu/models/hf_api.py`` (the ``huggingface`` /
``langchain-huggingface`` backends): each request is one
``urllib.request`` POST of ``{"inputs": prompt, "parameters": ...}`` to
``{api_base}/{repo}``, with the token of the config's ``api_token`` or
else ``HUGGINGFACEHUB_API_TOKEN`` / ``HF_TOKEN`` as a bearer; a model
without a token fails at load. The prompt round-trips through the byte
tokenizer (its ids are UTF-8 bytes, decoded back to the text sent), and
the answer's ``generated_text`` arrives as one delta. A failed call
finishes the request with "error", which the API answers with a 502.
The facade has the serving-model surface, so a remote model takes part
in the manager's lifecycle like a local one. A request's constraint is
ignored, as in the JAX package.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import urllib.request

from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.engine.scheduler import GenHandle, GenRequest
from localai_tpu_torch.templates.cache import TemplateCache
from localai_tpu_torch.utils.tokenizer import ByteTokenizer

log = logging.getLogger(__name__)

DEFAULT_API_BASE = "https://api-inference.huggingface.co/models"
TOKEN_ENV = ("HUGGINGFACEHUB_API_TOKEN", "HF_TOKEN")


def _resolve_token(mcfg: ModelConfig) -> str:
    if mcfg.api_token:
        return mcfg.api_token
    for env in TOKEN_ENV:
        if os.environ.get(env):
            return os.environ[env]
    return ""


class HFApiScheduler:
    """``submit()`` posts to the API on a daemon thread feeding a
    GenHandle."""

    def __init__(self, repo: str, token: str, api_base: str,
                 timeout: float = 120.0):
        self.repo = repo
        self.token = token
        self.api_base = api_base.rstrip("/")
        self.timeout = timeout
        self._ids = itertools.count()
        self._inflight = 0
        self._lock = threading.Lock()
        self._tok = ByteTokenizer()

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def submit(self, gr: GenRequest) -> GenHandle:
        handle = GenHandle(gr, next(self._ids))
        with self._lock:
            self._inflight += 1
        threading.Thread(target=self._run, args=(handle,), daemon=True,
                         name=f"hf-api-{handle.id}").start()
        return handle

    def _run(self, handle: GenHandle) -> None:
        try:
            handle._emit(self._predict(handle.request), None)
            handle._finish("stop")
        except Exception as e:  # noqa: BLE001 — a remote failure, no crash
            log.warning("remote API request failed: %s", e)
            handle._finish("error")
        finally:
            with self._lock:
                self._inflight -= 1

    def _predict(self, gr: GenRequest) -> str:
        parameters: dict = {"max_new_tokens": gr.max_new_tokens,
                            "return_full_text": False}
        if gr.temperature is not None and gr.temperature > 0:
            parameters["temperature"] = gr.temperature
        if gr.top_p is not None:
            parameters["top_p"] = gr.top_p
        if gr.top_k is not None:
            parameters["top_k"] = gr.top_k
        if gr.stop:
            parameters["stop"] = list(gr.stop)[:4]  # the API's cap
        req = urllib.request.Request(
            f"{self.api_base}/{self.repo}",
            data=json.dumps({"inputs": self._tok.decode(gr.prompt),
                             "parameters": parameters}).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.token}"}
                        if self.token else {})})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = json.loads(resp.read())
        # text-generation answers: [{"generated_text": ...}]; some
        # endpoints answer {"generated_text": ...} or {"error": ...}
        if isinstance(body, dict):
            if "error" in body:
                raise RuntimeError(str(body["error"]))
            body = [body]
        if body and isinstance(body[0], dict):
            return str(body[0].get("generated_text", ""))
        return ""

    def metrics(self) -> dict:
        with self._lock:
            return {"type": "hf-api", "inflight": self._inflight,
                    "repo": self.repo}

    def shutdown(self, timeout: float = 10.0) -> None:
        pass


class HFApiServingModel:
    """The serving model of a remote model (no local weights)."""

    def __init__(self, mcfg: ModelConfig, app: AppConfig):
        token = _resolve_token(mcfg)
        if not token:
            raise ValueError(
                f"model {mcfg.name!r}: backend huggingface needs an API "
                f"token (api_token: in the config, or "
                f"{'/'.join(TOKEN_ENV)} in the environment)")
        self.name = mcfg.name
        self.config = mcfg
        self.tokenizer = ByteTokenizer()
        self.templates = TemplateCache(app.model_path)
        self.vision = None
        self.image_token_id = 0
        self.scheduler = HFApiScheduler(mcfg.model or mcfg.name, token,
                                        mcfg.api_base or DEFAULT_API_BASE)
        self.loaded_at = time.monotonic()
        self.last_used = time.monotonic()

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def alive(self) -> bool:
        return True  # remote: failures surface per request

    def engine_metrics(self) -> dict:
        return self.scheduler.metrics()

    def close(self) -> None:
        pass
