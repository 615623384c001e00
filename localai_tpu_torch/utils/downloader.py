"""URI downloader with scheme abstraction, sha256 verify and .partial resume.

Port of ``localai_tpu/utils/downloader.py`` on ``urllib``: schemes
``huggingface://owner/repo/file@branch`` (and ``hf://``), ``github:`` /
``github://``, ``file://``, http(s); sha256 verification; resume of a
``.partial`` file with a ``Range`` header; progress callbacks. ``oci://``
(image layers extracted beside the target) and ``ollama://`` (the model
layer blob) ride the registry client of ``utils.oci``.
"""

from __future__ import annotations

import hashlib
import logging
import shutil
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable, Optional

log = logging.getLogger(__name__)

HUGGINGFACE_PREFIX = "huggingface://"
HF_SHORT_PREFIX = "hf://"
GITHUB_PREFIX = "github:"
OCI_PREFIX = "oci://"
OLLAMA_PREFIX = "ollama://"
FILE_PREFIX = "file://"

ProgressFn = Callable[[int, int], None]  # (downloaded_bytes, total_bytes)

_CHUNK = 1 << 20


def resolve_url(uri: str) -> str:
    """Map scheme URIs to concrete https URLs."""
    if uri.startswith((HUGGINGFACE_PREFIX, HF_SHORT_PREFIX)):
        ref = uri.split("://", 1)[1]
        branch = "main"
        if "@" in ref:
            ref, branch = ref.rsplit("@", 1)
        parts = ref.split("/")
        if len(parts) < 3:
            raise ValueError(f"huggingface uri needs owner/repo/file: {uri}")
        owner, repo, filepath = parts[0], parts[1], "/".join(parts[2:])
        return (
            f"https://huggingface.co/{owner}/{repo}/resolve/{branch}/{filepath}"
        )
    if uri.startswith("github://") or uri.startswith(GITHUB_PREFIX):
        ref = uri.split("://", 1)[1] if "://" in uri else uri[len(GITHUB_PREFIX):]
        branch = "main"
        if "@" in ref:
            ref, branch = ref.rsplit("@", 1)
        parts = ref.split("/")
        if len(parts) < 3:
            raise ValueError(f"github uri needs owner/repo/file: {uri}")
        owner, repo, filepath = parts[0], parts[1], "/".join(parts[2:])
        return (
            f"https://raw.githubusercontent.com/{owner}/{repo}/{branch}/{filepath}"
        )
    return uri


def looks_like_url(uri: str) -> bool:
    return uri.startswith(
        ("http://", "https://", HUGGINGFACE_PREFIX, HF_SHORT_PREFIX,
         GITHUB_PREFIX, "github://", OCI_PREFIX, OLLAMA_PREFIX)
    )


def sha256_file(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_uri(
    uri: str,
    dest: str | Path,
    sha256: Optional[str] = None,
    progress: Optional[ProgressFn] = None,
    timeout: float = 600.0,
) -> Path:
    """Download ``uri`` to ``dest`` with resume + sha verification."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)

    if dest.exists():
        if sha256 is None or sha256_file(dest) == sha256:
            return dest
        log.warning("sha mismatch for existing %s, re-downloading", dest)
        dest.unlink()

    if uri.startswith(FILE_PREFIX):
        src = Path(uri[len(FILE_PREFIX):])
        shutil.copyfile(src, dest)
    elif uri.startswith(OLLAMA_PREFIX):
        # the model layer blob becomes the destination file
        from localai_tpu_torch.utils.oci import ollama_fetch_model

        ollama_fetch_model(uri[len(OLLAMA_PREFIX):], dest, progress)
    elif uri.startswith(OCI_PREFIX):
        # image layers extract into the destination's directory; there is
        # no single output file to checksum
        from localai_tpu_torch.utils.oci import oci_extract_image

        oci_extract_image(uri[len(OCI_PREFIX):], dest.parent, progress)
        return dest
    else:
        _http_download(resolve_url(uri), dest, progress, timeout)

    if sha256 is not None:
        actual = sha256_file(dest)
        if actual != sha256:
            dest.unlink(missing_ok=True)
            raise ValueError(
                f"sha256 mismatch for {uri}: want {sha256} got {actual}"
            )
    return dest


def _http_download(
    url: str, dest: Path, progress: Optional[ProgressFn], timeout: float
) -> None:
    partial = dest.with_suffix(dest.suffix + ".partial")
    headers = {}
    offset = 0
    if partial.exists():
        offset = partial.stat().st_size
        headers["Range"] = f"bytes={offset}-"
    req = urllib.request.Request(url, headers=headers)
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        if e.code == 416:  # range not satisfiable → restart
            e.close()
            partial.unlink(missing_ok=True)
            return _http_download(url, dest, progress, timeout)
        raise
    with resp:
        mode = "ab" if offset and resp.status == 206 else "wb"
        total = int(resp.headers.get("content-length") or 0) + (
            offset if mode == "ab" else 0
        )
        done = offset if mode == "ab" else 0
        with open(partial, mode) as f:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                if progress:
                    progress(done, total)
    partial.rename(dest)
