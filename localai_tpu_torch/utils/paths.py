"""Path safety: the traversal guard every user-supplied filename passes
through. Port of ``localai_tpu/utils/paths.py``."""

from __future__ import annotations

from pathlib import Path


def verify_path(filename: str | Path, base_dir: str | Path) -> Path:
    """Resolve ``base_dir/filename`` and require it to stay inside base_dir.
    Returns the resolved absolute path or raises ValueError."""
    base = Path(base_dir).resolve()
    target = (base / filename).resolve()
    if base != target and base not in target.parents:
        raise ValueError(f"path {filename!r} escapes {base}")
    return target
