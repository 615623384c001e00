"""Model-config registry: load YAML files from a models dir.

Port of ``localai_tpu/config/loader.py`` (single-document files and whole
dirs). ``yaml`` is imported inside the file reader: the port's runtime
does not need it unless a config file is read.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Optional

from localai_tpu_torch.config.model_config import ModelConfig

log = logging.getLogger(__name__)


def load_config_file(path: str | Path) -> ModelConfig:
    """Load a single-document model YAML."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
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
            except ValueError as e:
                raise ValueError(f"{entry}: {e}") from None
            if not cfg.name:
                cfg.name = entry.stem
            cfg.set_defaults(context_size=context_size)
            self.register(cfg)

    def register(self, cfg: ModelConfig) -> None:
        with self._lock:
            self._configs[cfg.name] = cfg

    def get(self, name: str) -> Optional[ModelConfig]:
        with self._lock:
            return self._configs.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._configs)
