"""Process-wide settings of the port's server (the subset of
``localai_tpu/config/app_config.py`` this slice reads)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AppConfig:
    model_path: str = "models"      # dir of model YAMLs / checkpoints
    context_size: int = 4096        # default when a model sets none
    device: str = "cuda"            # "cuda" (default) or "cpu", explicitly
    address: str = "127.0.0.1"
    port: int = 8080
