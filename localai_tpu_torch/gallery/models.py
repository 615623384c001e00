"""Gallery model schema + install/delete operations.

Port of ``localai_tpu/gallery/models.py``. ``GalleryFile`` and
``GalleryModel`` are dataclasses that validate their fields as the JAX
package's pydantic models do (strict strings, lists of strings, dicts
with string keys, lax booleans) and keep unknown fields, as
``extra="allow"`` does: ``model_validate``, ``model_dump`` (declared
fields in order, then the extra ones) and ``model_copy`` keep those
models' names. ``install_model`` resolves the config (inline
``config_file`` → a definition URL → bare files), downloads each file
sha-verified with progress, deep-merges the overrides and writes the
config YAML (``config.yaml_subset.safe_dump``); ``delete_model`` removes
the config and the files its install recorded.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import re
from pathlib import Path
from typing import Any, Callable, Optional

from localai_tpu_torch.config.yaml_subset import safe_dump, safe_load
from localai_tpu_torch.utils import downloader

log = logging.getLogger(__name__)

ProgressFn = Callable[[str, int, int], None]  # (filename, done, total)

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _check(kind: str, value: Any, where: str) -> Any:
    """``value`` of a field of type ``kind`` as pydantic's lax mode takes
    it, or ValueError naming the field."""
    if kind == "str":
        if isinstance(value, str):
            return value
        raise ValueError(f"{where}: Input should be a valid string")
    if kind == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise ValueError(f"{where}: Input should be a valid boolean")
    if kind == "str_list":
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{where}: Input should be a valid list")
        return [_check("str", v, f"{where}.{i}")
                for i, v in enumerate(value)]
    if kind in ("dict", "opt_dict"):
        if value is None and kind == "opt_dict":
            return None
        if not isinstance(value, dict):
            raise ValueError(f"{where}: Input should be a valid dictionary")
        for k in value:
            _check("str", k, f"{where}.{k}.[key]")
        return dict(value)
    if kind == "files":
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{where}: Input should be a valid list")
        return [v if isinstance(v, GalleryFile)
                else GalleryFile.model_validate(v, f"{where}.{i}")
                for i, v in enumerate(value)]
    raise AssertionError(kind)


class _Schema:
    """Validation, dump and copy shared by the two models: ``_KINDS``
    maps each declared field to its kind; ``extra_fields`` holds the
    unknown ones."""

    _KINDS: dict[str, str] = {}

    def __post_init__(self):
        for name, kind in self._KINDS.items():
            setattr(self, name, _check(kind, getattr(self, name), name))

    @classmethod
    def model_validate(cls, data: Any, where: str = ""):
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise ValueError(f"{where or cls.__name__}: Input should be a "
                             "valid dictionary")
        known = {k: v for k, v in data.items() if k in cls._KINDS}
        extra = {k: v for k, v in data.items() if k not in cls._KINDS}
        for f in dataclasses.fields(cls):
            if f.name in cls._KINDS and f.name not in known and \
                    f.default is dataclasses.MISSING and \
                    f.default_factory is dataclasses.MISSING:
                raise ValueError(f"{(where + '.') if where else ''}"
                                 f"{f.name}: Field required")
        try:
            return cls(**known, extra_fields=extra)
        except ValueError as e:
            raise ValueError(f"{where}.{e}" if where else str(e)) from None

    def __getattr__(self, name: str) -> Any:
        extra = self.__dict__.get("extra_fields") or {}
        if name in extra:
            return extra[name]
        raise AttributeError(name)

    def model_dump(self, exclude: Any = ()) -> dict:
        out = {}
        for name in self._KINDS:
            if name in exclude:
                continue
            v = getattr(self, name)
            if name == "files":
                v = [f.model_dump() for f in v]
            else:
                v = copy.deepcopy(v)
            out[name] = v
        for k, v in self.extra_fields.items():
            if k not in exclude:
                out[k] = copy.deepcopy(v)
        return out

    def model_copy(self, update: Optional[dict] = None, deep: bool = False):
        new = copy.deepcopy(self) if deep else copy.copy(self)
        if not deep:
            new.extra_fields = dict(self.extra_fields)
        for k, v in (update or {}).items():
            if k in self._KINDS:
                setattr(new, k, v)
            else:
                new.extra_fields[k] = v
        return new


@dataclasses.dataclass
class GalleryFile(_Schema):
    _KINDS = {"filename": "str", "uri": "str", "sha256": "str"}

    filename: str
    uri: str
    sha256: str = ""
    extra_fields: dict = dataclasses.field(default_factory=dict,
                                           repr=False)


@dataclasses.dataclass
class GalleryModel(_Schema):
    """One entry in a gallery index (the model metadata, files and
    overrides of a model definition)."""

    _KINDS = {"name": "str", "description": "str", "license": "str",
              "urls": "str_list", "tags": "str_list", "icon": "str",
              "url": "str", "config_file": "opt_dict", "files": "files",
              "overrides": "dict", "gallery": "str", "installed": "bool"}

    name: str
    description: str = ""
    license: str = ""
    urls: list = dataclasses.field(default_factory=list)
    tags: list = dataclasses.field(default_factory=list)
    icon: str = ""
    # install payload
    url: str = ""                       # URL of a model-definition YAML
    config_file: Optional[dict] = None  # inline model config
    files: list = dataclasses.field(default_factory=list)
    overrides: dict = dataclasses.field(default_factory=dict)
    gallery: str = ""                   # which gallery it came from
    installed: bool = False
    extra_fields: dict = dataclasses.field(default_factory=dict,
                                           repr=False)

    @property
    def id(self) -> str:
        return f"{self.gallery}@{self.name}" if self.gallery else self.name


def deep_merge(base: dict, overrides: dict) -> dict:
    """Merge-with-override: nested dicts merge, scalars and lists from
    ``overrides`` win."""
    out = dict(base)
    for k, v in overrides.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


_NAME_RX = re.compile(r"[^a-zA-Z0-9._-]")


def safe_name(name: str) -> str:
    return _NAME_RX.sub("_", name)


def _verify_inside(base: Path, target: Path) -> Path:
    """Path-traversal guard: ``target`` must resolve inside ``base``."""
    base_r = base.resolve()
    target_r = target.resolve()
    if not str(target_r).startswith(str(base_r) + "/") and target_r != base_r:
        raise ValueError(f"path {target} escapes models dir {base}")
    return target


def install_model(
    model: GalleryModel,
    models_path: str | Path,
    *,
    install_name: str = "",
    overrides: Optional[dict] = None,
    progress: Optional[ProgressFn] = None,
) -> Path:
    """Download the model's files (sha-verified, resumable) and write its
    config YAML into the models dir. Returns the config path. The config
    comes from the inline config_file, else from the definition at
    ``model.url``, else the files alone."""
    models_path = Path(models_path)
    models_path.mkdir(parents=True, exist_ok=True)
    name = install_name or model.name

    config: dict = {}
    if model.url:
        # model definition lives at a URL (yaml with files/overrides/config)
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td) / "def.yaml"
            downloader.download_uri(model.url, tmp)
            doc = safe_load(tmp.read_text()) or {}
        remote = GalleryModel.model_validate({"name": name, **doc})
        if remote.config_file:
            config = dict(remote.config_file)
        files = remote.files or model.files
        config = deep_merge(config, remote.overrides or {})
    else:
        files = model.files
        if model.config_file:
            config = dict(model.config_file)

    config = deep_merge(config, model.overrides or {})
    config = deep_merge(config, overrides or {})
    config["name"] = name

    total_all = 0
    for f in files:
        dest = _verify_inside(models_path, models_path / f.filename)
        log.info("gallery: downloading %s ← %s", f.filename, f.uri)

        def file_progress(done: int, total: int, _fn=f.filename):
            if progress:
                progress(_fn, done, total)

        downloader.download_uri(
            f.uri, dest, sha256=f.sha256 or None, progress=file_progress
        )
        total_all += dest.stat().st_size

    if files:
        # manifest of downloaded files so delete can remove them
        config["downloaded_files"] = [f.filename for f in files]
    config_path = models_path / f"{safe_name(name)}.yaml"
    config_path.write_text(safe_dump(config, sort_keys=False))
    log.info("gallery: installed %s (%d files, %d bytes) → %s",
             name, len(files), total_all, config_path)
    return config_path


def delete_model(name: str, models_path: str | Path) -> bool:
    """Remove a model's config and its referenced weight files."""
    models_path = Path(models_path)
    config_path = models_path / f"{safe_name(name)}.yaml"
    found = config_path.exists()
    files: list[str] = []
    if found:
        try:
            doc = safe_load(config_path.read_text()) or {}
            files.extend(doc.get("downloaded_files") or [])
            ref = doc.get("model") or ""
            if ref and not ref.startswith("debug:"):
                files.append(ref)
        except Exception:  # noqa: BLE001
            pass
        config_path.unlink()
    dirs: set[Path] = set()
    for ref in files:
        target = models_path / ref
        try:
            _verify_inside(models_path, target)
        except ValueError:
            continue
        if target.is_dir():
            import shutil

            shutil.rmtree(target, ignore_errors=True)
        elif target.exists():
            target.unlink()
            if target.parent != models_path:
                dirs.add(target.parent)
    for d in dirs:  # prune now-empty per-model dirs
        try:
            d.rmdir()
        except OSError:
            pass
    return found
