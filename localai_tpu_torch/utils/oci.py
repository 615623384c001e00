"""OCI registry v2 client: ollama model pulls and OCI image extraction.

Port of ``localai_tpu/utils/oci.py`` on ``urllib``: the slice of the
distribution spec those paths use — anonymous Bearer token auth, manifest
fetch (manifest lists resolved to linux/amd64, else their first entry),
digest-verified blob download, the ollama model-layer convention (the
layer whose mediaType contains "model"), and tar-layer extraction with a
path traversal guard.
"""

from __future__ import annotations

import hashlib
import json
import logging
import tarfile
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

log = logging.getLogger(__name__)

ProgressFn = Callable[[int, int], None]

MANIFEST_TYPES = (
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.v2+json",
)
INDEX_TYPES = (
    "application/vnd.oci.image.index.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
)


@dataclass
class ImageRef:
    """registry/repository:tag(@digest) parsed per the docker reference
    grammar."""

    registry: str
    repository: str
    reference: str  # tag or sha256:... digest
    scheme: str = "https"

    @property
    def base(self) -> str:
        return f"{self.scheme}://{self.registry}/v2/{self.repository}"


def parse_image_ref(image: str, *, default_registry: str = "docker.io",
                    default_tag: str = "latest") -> ImageRef:
    """'gemma:2b' → registry.ollama.ai/library/gemma:2b style defaulting;
    full refs like 'quay.io/org/repo:tag' and digests pass through."""
    scheme = "https"
    if image.startswith("http://"):     # tests / local registries
        scheme, image = "http", image[len("http://"):]
    elif image.startswith("https://"):
        image = image[len("https://"):]
    digest = ""
    if "@" in image:
        image, digest = image.split("@", 1)
    head, _, rest = image.partition("/")
    if rest and ("." in head or ":" in head or head == "localhost"):
        registry, path = head, rest
    else:
        registry, path = default_registry, image
    if registry == "docker.io":
        registry = "registry-1.docker.io"
    tag = default_tag
    if ":" in path.rsplit("/", 1)[-1]:
        path, tag = path.rsplit(":", 1)
    if "/" not in path:
        path = f"library/{path}"
    return ImageRef(registry, path, digest or tag, scheme=scheme)


class RegistryClient:
    """Minimal distribution-spec client with anonymous token auth."""

    def __init__(self, ref: ImageRef, timeout: float = 60.0):
        self.ref = ref
        self.timeout = timeout
        self._token: Optional[str] = None

    def _open(self, url: str, headers: dict):
        return urllib.request.urlopen(
            urllib.request.Request(url, headers=headers),
            timeout=self.timeout)

    def _get(self, url: str, headers: Optional[dict] = None):
        """The response to a GET of ``url`` (a file-like object with
        ``.headers``); a 401 with a Bearer challenge fetches an anonymous
        token once and retries. Other HTTP errors raise."""
        h = dict(headers or {})
        if self._token:
            h["Authorization"] = f"Bearer {self._token}"
        try:
            return self._open(url, h)
        except urllib.error.HTTPError as e:
            if e.code != 401 or self._token is not None:
                raise
            challenge = e.headers.get("WWW-Authenticate", "")
            e.close()
        self._authenticate(challenge)
        if not self._token:
            raise urllib.error.HTTPError(url, 401, "Unauthorized", None,
                                         None)
        h["Authorization"] = f"Bearer {self._token}"
        return self._open(url, h)

    def _authenticate(self, challenge: str) -> None:
        """Bearer realm="…",service="…"(,scope="…") → anonymous token."""
        if not challenge.startswith("Bearer "):
            return
        fields = {}
        for part in challenge[len("Bearer "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v.strip('"')
        realm = fields.get("realm")
        if not realm:
            return
        params = {
            "service": fields.get("service", ""),
            "scope": fields.get(
                "scope", f"repository:{self.ref.repository}:pull"
            ),
        }
        url = realm + ("&" if "?" in realm else "?") + \
            urllib.parse.urlencode(params)
        with self._open(url, {}) as resp:
            body = json.loads(resp.read())
        self._token = body.get("token") or body.get("access_token")

    # -- manifests ---------------------------------------------------------

    def manifest(self, reference: Optional[str] = None) -> dict:
        """Fetch and (for indexes) resolve to a concrete image manifest —
        linux/amd64 preferred, else the first entry."""
        ref = reference or self.ref.reference
        with self._get(
            f"{self.ref.base}/manifests/{ref}",
            headers={"Accept": ", ".join(MANIFEST_TYPES + INDEX_TYPES)},
        ) as resp:
            m = json.loads(resp.read())
        mtype = m.get("mediaType", "")
        if mtype in INDEX_TYPES or "manifests" in m and "layers" not in m:
            entries = m.get("manifests", [])
            if not entries:
                raise ValueError("empty manifest index")
            chosen = next(
                (e for e in entries
                 if (e.get("platform") or {}).get("os") == "linux"
                 and (e.get("platform") or {}).get("architecture")
                 == "amd64"),
                entries[0],
            )
            return self.manifest(chosen["digest"])
        return m

    # -- blobs -------------------------------------------------------------

    def fetch_blob(self, digest: str, dest: str | Path,
                   progress: Optional[ProgressFn] = None,
                   expected_size: int = 0) -> Path:
        """Stream a blob to dest, verifying the sha256 digest."""
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        algo, _, want = digest.partition(":")
        if algo != "sha256":
            raise ValueError(f"unsupported digest algorithm {algo!r}")
        h = hashlib.sha256()
        done = 0
        partial = dest.with_suffix(dest.suffix + ".partial")
        with self._get(f"{self.ref.base}/blobs/{digest}") as resp:
            total = int(resp.headers.get("Content-Length") or expected_size)
            with open(partial, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    h.update(chunk)
                    done += len(chunk)
                    if progress:
                        progress(done, total)
        if h.hexdigest() != want:
            partial.unlink(missing_ok=True)
            raise ValueError(
                f"digest mismatch for {digest}: got sha256:{h.hexdigest()}"
            )
        partial.replace(dest)
        return dest


def ollama_fetch_model(image: str, dest: str | Path,
                       progress: Optional[ProgressFn] = None) -> Path:
    """ollama://gemma:2b → download the model layer (the GGUF weights) to
    ``dest`` (the layer whose mediaType contains "model")."""
    ref = parse_image_ref(image, default_registry="registry.ollama.ai")
    client = RegistryClient(ref)
    manifest = client.manifest()
    layer = next(
        (l for l in manifest.get("layers", [])
         if "model" in l.get("mediaType", "")),
        None,
    )
    if layer is None:
        raise ValueError(f"no model layer in ollama manifest for {image}")
    return client.fetch_blob(
        layer["digest"], dest, progress,
        expected_size=layer.get("size", 0),
    )


def _safe_extract_tar(tf: tarfile.TarFile, dest: Path) -> None:
    """Extract with a traversal guard: links are skipped and a member
    outside ``dest`` raises."""
    from localai_tpu_torch.utils.paths import verify_path

    for member in tf.getmembers():
        if member.issym() or member.islnk():
            # links could point outside the tree; models don't need them
            log.warning("skipping link %s in layer tar", member.name)
            continue
        verify_path(member.name, dest)  # raises on ../ escapes
        tf.extract(member, dest, filter="data")


def oci_extract_image(image: str, dest_dir: str | Path,
                      progress: Optional[ProgressFn] = None) -> Path:
    """oci://registry/repo:tag → pull all layers and extract them in order
    into ``dest_dir``."""
    import gzip
    import shutil
    import tempfile

    ref = parse_image_ref(image)
    client = RegistryClient(ref)
    manifest = client.manifest()
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    for layer in manifest.get("layers", []):
        digest = layer["digest"]
        with tempfile.NamedTemporaryFile(suffix=".layer",
                                         delete=False) as tmp:
            tmp_path = Path(tmp.name)
        raw = tmp_path
        try:
            client.fetch_blob(digest, tmp_path, progress,
                              expected_size=layer.get("size", 0))
            if layer.get("mediaType", "").endswith("gzip"):
                raw = tmp_path.with_suffix(".tar")
                with gzip.open(tmp_path, "rb") as src, \
                        open(raw, "wb") as out:
                    shutil.copyfileobj(src, out)
            with tarfile.open(raw) as tf:
                _safe_extract_tar(tf, dest_dir)
        finally:
            # failure mid-extraction must not strand the decompressed
            # multi-GB .tar in the temp dir
            if raw is not tmp_path:
                raw.unlink(missing_ok=True)
            tmp_path.unlink(missing_ok=True)
    return dest_dir
