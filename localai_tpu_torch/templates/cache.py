"""Template cache keyed by (type, name).

Port of ``localai_tpu/templates/cache.py``: a template name resolves to
``<name>.tmpl`` (or ``.jinja``/``.j2``) in the templates dir; if no such
file exists the name string ITSELF is the template (gallery configs embed
template bodies inline). Go-template sources are transpiled to Jinja on
load (``templates.gotmpl``) and every template is parsed once into the
port's engine (``templates.engine``); path traversal outside the
templates dir is rejected.
"""

from __future__ import annotations

import enum
import threading
from pathlib import Path
from typing import Any, Optional

from localai_tpu_torch.templates.engine import Template
from localai_tpu_torch.templates.gotmpl import (
    go_template_to_jinja,
    looks_like_go_template,
    make_environment,
)
from localai_tpu_torch.utils.paths import verify_path


class TemplateType(enum.Enum):
    """The kinds of prompt template (the JAX package's TemplateType)."""

    CHAT = "chat"
    CHAT_MESSAGE = "chat_message"
    COMPLETION = "completion"
    EDIT = "edit"
    FUNCTIONS = "functions"
    MULTIMODAL = "multimodal"


class TemplateCache:
    def __init__(self, templates_path: str | Path):
        self.templates_path = Path(templates_path)
        self._env = make_environment()
        self._cache: dict[tuple[TemplateType, str], Template] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _could_be_filename(name: str) -> bool:
        return "\n" not in name and "{{" not in name and len(name) < 200

    def _load(self, name: str) -> Template:
        src: Optional[str] = None
        if self._could_be_filename(name):
            for suffix in (".tmpl", ".jinja", ".j2"):
                fname = name + suffix
                cand = self.templates_path / fname
                try:
                    found = cand.exists()
                except OSError:
                    found = False
                if found:
                    verify_path(fname, self.templates_path)
                    src = cand.read_text()
                    break
        if src is None:
            src = name  # inline template body
        if looks_like_go_template(src):
            src = go_template_to_jinja(src)
        return self._env.from_string(src)

    def evaluate(
        self, ttype: TemplateType, name: str, data: dict[str, Any]
    ) -> str:
        if not name:
            return ""
        key = (ttype, name)
        with self._lock:
            tmpl = self._cache.get(key)
            if tmpl is None:
                tmpl = self._load(name)
                self._cache[key] = tmpl
        # _data/_it support bare {{.}} refs from transpiled Go templates
        return tmpl.render(**data, _data=data)

    def exists_file(self, name: str) -> bool:
        if not self._could_be_filename(name):
            return False
        try:
            return any(
                (self.templates_path / (name + s)).exists()
                for s in (".tmpl", ".jinja", ".j2")
            )
        except OSError:
            return False
