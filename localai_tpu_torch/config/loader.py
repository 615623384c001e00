"""Model-config registry: load YAML files from a models dir.

Port of ``localai_tpu/config/loader.py`` (single-document files and whole
dirs; ``load_single`` and ``remove`` keep it in step with gallery installs
and deletes). Files are read by the port's own YAML reader
(``config.yaml_subset``, PyYAML's ``safe_load`` meaning, stdlib only), in
every environment. Each config then goes through backend and chat-default
autodetection (``models.detect.autodetect_config``), as on the JAX
package, and the detected config is checked again (``check_supported``).
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Optional

from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.config.yaml_subset import safe_load

log = logging.getLogger(__name__)


def load_config_file(path: str | Path) -> ModelConfig:
    """Load a single-document model YAML."""
    with open(path, encoding="utf-8") as f:
        data = safe_load(f.read()) or {}
    if not isinstance(data, dict):
        raise ValueError(f"a model config is a mapping, not a "
                         f"{type(data).__name__}")
    return ModelConfig.from_dict(data)


class ConfigLoader:
    """Thread-safe name→ModelConfig registry."""

    def __init__(self, model_path: str | Path = "models"):
        self.model_path = Path(model_path)
        self._configs: dict[str, ModelConfig] = {}
        self._lock = threading.RLock()

    def load_from_path(self, path: Optional[str | Path] = None,
                       context_size: int = 4096) -> None:
        """Register every *.yaml/*.yml config in a dir. A config the port
        cannot serve raises (it names the file)."""
        root = Path(path or self.model_path)
        if not root.is_dir():
            return
        for entry in sorted(root.iterdir()):
            if not entry.is_file() or entry.suffix not in (".yaml", ".yml"):
                continue
            try:
                cfg = load_config_file(entry)
                if not cfg.name:
                    cfg.name = entry.stem
                cfg.set_defaults(context_size=context_size)
                self._autodetect(cfg)
            except ValueError as e:
                raise ValueError(f"{entry}: {e}") from None
            self.register(cfg)

    def load_single(self, path: str | Path,
                    context_size: int = 4096) -> ModelConfig:
        """Register one config file (a gallery install's), named by its
        ``name:`` or else its file stem."""
        cfg = load_config_file(path)
        if not cfg.name:
            cfg.name = Path(path).stem
        cfg.set_defaults(context_size=context_size)
        self._autodetect(cfg)
        self.register(cfg)
        return cfg

    def _autodetect(self, cfg: ModelConfig) -> None:
        """Backend selection for bare ``model:`` configs by checkpoint
        sniff, and the family's chat defaults (``models/detect.py``); the
        completed config is checked again."""
        explicit = cfg.backend
        try:
            from localai_tpu_torch.models.detect import autodetect_config

            autodetect_config(cfg, self.model_path)
        except Exception as e:  # noqa: BLE001 — sniffing must not block load
            log.warning("backend autodetect for %s failed: %s",
                        cfg.name, e)
        if cfg.backend and not explicit:
            cfg.check_supported()

    def register(self, cfg: ModelConfig) -> None:
        with self._lock:
            self._configs[cfg.name] = cfg

    def remove(self, name: str) -> None:
        with self._lock:
            self._configs.pop(name, None)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._configs

    def get(self, name: str) -> Optional[ModelConfig]:
        with self._lock:
            return self._configs.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._configs)
