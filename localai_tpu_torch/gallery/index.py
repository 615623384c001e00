"""Gallery indexes: load, merge, search, and resolve ``gallery@name`` refs.

Port of ``localai_tpu/gallery/index.py``: a gallery index is a YAML list
of model entries (anchors, aliases and merge keys read as PyYAML reads
them, by ``config.yaml_subset``), fetched from ``file://`` or any URL the
downloader takes. Both ``gallery@name`` and ``name@gallery`` resolve, and
configured galleries win over the shipped index.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from localai_tpu_torch.config.yaml_subset import safe_load
from localai_tpu_torch.gallery.models import GalleryModel, safe_name
from localai_tpu_torch.utils import downloader

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Gallery:
    """A named index of models."""

    name: str
    url: str


def load_gallery_index(gallery: Gallery) -> list[GalleryModel]:
    """Fetch + parse one gallery index YAML (list of model entries)."""
    import tempfile

    if gallery.url.startswith("file://"):
        text = Path(gallery.url[len("file://"):]).read_text()
    else:
        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td) / "index.yaml"
            downloader.download_uri(gallery.url, tmp)
            text = tmp.read_text()
    docs = safe_load(text) or []
    if not isinstance(docs, list):
        raise ValueError(f"gallery index {gallery.url} is not a list")
    out = []
    for doc in docs:
        try:
            m = GalleryModel.model_validate(doc)
            m.gallery = gallery.name
            out.append(m)
        except Exception as e:  # noqa: BLE001 — skip malformed entries
            log.warning("gallery %s: skipping bad entry: %s", gallery.name, e)
    return out


def available_models(
    galleries: list[Gallery], models_path: str | Path = "models"
) -> list[GalleryModel]:
    """All models across galleries plus the shipped index, flagged
    installed when their config YAML exists in the models dir."""
    models_path = Path(models_path)
    out: list[GalleryModel] = []
    for g in galleries:
        try:
            models = load_gallery_index(g)
        except Exception as e:  # noqa: BLE001 — one dead gallery ≠ no list
            log.warning("gallery %s unavailable: %s", g.name, e)
            continue
        out.extend(models)
    # the shipped index; configured galleries win on name collisions.
    # Shallow copies only (the flags set here are scalars)
    from localai_tpu_torch.gallery.index_data import _ENTRIES

    seen = {m.name for m in out}
    for m in _ENTRIES:
        if m.name not in seen:
            out.append(m.model_copy(update={"gallery": "shipped"}))
    for m in out:
        m.installed = (models_path / f"{safe_name(m.name)}.yaml").exists()
    return out


def resolve_ref(
    galleries: list[Gallery], ref: str, *, name: str = ""
) -> Optional[GalleryModel]:
    """The model-ref resolution chain, shared by CLI, API and preload:
    embedded short name → definition URL → gallery lookup → the shipped
    index."""
    from localai_tpu_torch.gallery.embedded import resolve_embedded

    m = resolve_embedded(ref)
    if m is not None:
        return m
    if downloader.looks_like_url(ref):
        return GalleryModel(name=name or "model", url=ref)
    m = find_model(galleries, ref)
    if m is not None:
        return m
    # shipped index short names, gallery-qualified as shipped@name too
    from localai_tpu_torch.gallery.index_data import SHIPPED_MODELS

    short = ref.removeprefix("shipped@")
    hit = SHIPPED_MODELS.get(short)
    return hit.model_copy(deep=True) if hit is not None else None


def find_model(
    galleries: list[Gallery], ref: str
) -> Optional[GalleryModel]:
    """Resolve ``name``, ``gallery@name`` or ``name@gallery``."""
    name, wanted_gallery = ref, ""
    if "@" in ref:
        a, b = ref.split("@", 1)
        gallery_names = {g.name for g in galleries}
        if a in gallery_names:
            wanted_gallery, name = a, b
        else:
            name, wanted_gallery = a, b
    for g in galleries:
        if wanted_gallery and g.name != wanted_gallery:
            continue
        try:
            for m in load_gallery_index(g):
                if m.name == name:
                    return m
        except Exception as e:  # noqa: BLE001
            log.warning("gallery %s unavailable: %s", g.name, e)
    return None
