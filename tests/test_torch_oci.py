"""The port's OCI registry client (``utils/oci.py``, on ``urllib``) against
the JAX package's (on ``requests``), both over the in-process mock
registry of ``tests/test_oci.py``: the anonymous Bearer-token dance,
manifest and manifest-index resolution, digest-verified blobs, ollama's
model-layer convention, layer extraction with its traversal guard, and
the downloader's ``ollama://`` and ``oci://`` routes. Every case of that
file runs on both modules.
"""

import pytest

pytest.importorskip("torch")

from localai_tpu.utils import downloader as jdl  # noqa: E402
from localai_tpu.utils import oci as joci  # noqa: E402
from localai_tpu_torch.utils import downloader as tdl  # noqa: E402
from localai_tpu_torch.utils import oci as toci  # noqa: E402
from test_oci import _MockRegistry, _tar_bytes  # noqa: E402

MODS = {"jax": (joci, jdl), "port": (toci, tdl)}


@pytest.fixture()
def registry():
    r = _MockRegistry()
    yield r
    r.close()


@pytest.mark.parametrize("image,kw", [
    ("gemma:2b", {"default_registry": "registry.ollama.ai"}),
    ("quay.io/org/repo:v1", {}),
    ("repo@sha256:abc", {}),
    ("http://localhost:5000/m:t", {}),
    ("https://ghcr.io/o/r/sub:tag", {}),
    ("localhost/m", {}),
    ("library/ubuntu", {}),
    ("a.b/c@sha256:00", {"default_tag": "x"}),
])
def test_parse_image_ref_as_the_jax_package(image, kw):
    assert toci.parse_image_ref(image, **kw).__dict__ == \
        joci.parse_image_ref(image, **kw).__dict__
    assert toci.parse_image_ref(image, **kw).base == \
        joci.parse_image_ref(image, **kw).base


def test_parse_image_ref_defaults():
    r = toci.parse_image_ref("gemma:2b",
                             default_registry="registry.ollama.ai")
    assert (r.registry, r.repository, r.reference) == (
        "registry.ollama.ai", "library/gemma", "2b")
    r = toci.parse_image_ref("quay.io/org/repo:v1")
    assert (r.registry, r.repository, r.reference) == (
        "quay.io", "org/repo", "v1")
    r = toci.parse_image_ref("repo@sha256:abc")
    assert r.registry == "registry-1.docker.io"
    assert r.reference == "sha256:abc"
    r = toci.parse_image_ref("http://localhost:5000/m:t")
    assert (r.scheme, r.registry) == ("http", "localhost:5000")


@pytest.mark.parametrize("mod", MODS)
def test_ollama_model_pull(registry, tmp_path, mod):
    oci, _ = MODS[mod]
    weights = b"GGUF-fake-model-bytes" * 100
    dg = registry.add_blob(weights)
    registry.add_manifest("2b", {
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "layers": [
            {"mediaType": "application/vnd.ollama.image.license",
             "digest": registry.add_blob(b"license"), "size": 7},
            {"mediaType": "application/vnd.ollama.image.model",
             "digest": dg, "size": len(weights)},
        ],
    })
    dest = tmp_path / "model.gguf"
    seen = []
    out = oci.ollama_fetch_model(f"http://{registry.host}/gemma:2b", dest,
                                 progress=lambda d, t: seen.append((d, t)))
    assert out.read_bytes() == weights
    assert seen[-1] == (len(weights), len(weights))


@pytest.mark.parametrize("mod", MODS)
def test_no_model_layer_refused(registry, tmp_path, mod):
    oci, _ = MODS[mod]
    registry.add_manifest("t", {"layers": [
        {"mediaType": "application/vnd.ollama.image.license",
         "digest": registry.add_blob(b"l"), "size": 1}]})
    with pytest.raises(ValueError, match="no model layer"):
        oci.ollama_fetch_model(f"http://{registry.host}/m:t",
                               tmp_path / "x")


@pytest.mark.parametrize("mod", MODS)
def test_blob_digest_verification(registry, tmp_path, mod):
    oci, _ = MODS[mod]
    data = b"payload"
    dg = registry.add_blob(data)
    registry.blobs[dg] = b"tampered"  # corrupt after digest computed
    client = oci.RegistryClient(oci.parse_image_ref(
        f"http://{registry.host}/m:t"))
    with pytest.raises(ValueError, match="digest mismatch"):
        client.fetch_blob(dg, tmp_path / "out")
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "out.partial").exists()
    with pytest.raises(ValueError, match="unsupported digest"):
        client.fetch_blob("md5:00", tmp_path / "out")


@pytest.mark.parametrize("mod", MODS)
def test_anonymous_token_auth_flow(registry, tmp_path, mod):
    """The first request is a 401 with a challenge; the client fetches a
    token from the realm and retries."""
    oci, _ = MODS[mod]
    data = b"authed-blob"
    dg = registry.add_blob(data)
    client = oci.RegistryClient(oci.parse_image_ref(
        f"http://{registry.host}/m:t"))
    client.fetch_blob(dg, tmp_path / "b")
    assert (tmp_path / "b").read_bytes() == data
    assert client._token == registry.token  # noqa: SLF001


@pytest.mark.parametrize("mod", MODS)
def test_missing_blob_raises_an_http_error(registry, tmp_path, mod):
    oci, _ = MODS[mod]
    client = oci.RegistryClient(oci.parse_image_ref(
        f"http://{registry.host}/m:t"))
    with pytest.raises(Exception) as e:
        client.fetch_blob("sha256:" + "0" * 64, tmp_path / "b")
    assert "404" in str(e.value)


@pytest.mark.parametrize("mod", MODS)
def test_oci_image_extraction(registry, tmp_path, mod):
    oci, _ = MODS[mod]
    layer1 = _tar_bytes({"weights/model.safetensors": b"tensor-bytes"})
    layer2 = _tar_bytes({"config.json": b"{}"}, gz=True)
    registry.add_manifest("v1", {
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "layers": [
            {"mediaType": "application/vnd.oci.image.layer.v1.tar",
             "digest": registry.add_blob(layer1), "size": len(layer1)},
            {"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
             "digest": registry.add_blob(layer2), "size": len(layer2)},
        ],
    })
    out = oci.oci_extract_image(f"http://{registry.host}/m:v1",
                                tmp_path / "x")
    assert (out / "weights/model.safetensors").read_bytes() == \
        b"tensor-bytes"
    assert (out / "config.json").read_bytes() == b"{}"


@pytest.mark.parametrize("mod", MODS)
def test_oci_extraction_blocks_traversal(registry, tmp_path, mod):
    oci, _ = MODS[mod]
    evil = _tar_bytes({"../escape.txt": b"pwn"})
    registry.add_manifest("bad", {
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "layers": [
            {"mediaType": "application/vnd.oci.image.layer.v1.tar",
             "digest": registry.add_blob(evil), "size": len(evil)},
        ],
    })
    with pytest.raises(ValueError, match="escapes"):
        oci.oci_extract_image(f"http://{registry.host}/m:bad",
                              tmp_path / "safe")
    assert not (tmp_path / "escape.txt").exists()


@pytest.mark.parametrize("mod", MODS)
def test_manifest_index_resolution(registry, tmp_path, mod):
    """Manifest lists resolve to the linux/amd64 entry (else the first)."""
    oci, _ = MODS[mod]
    data = b"platform-blob"
    dg = registry.add_blob(data)
    child = registry.add_manifest("child", {
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "layers": [{"mediaType": "application/vnd.ollama.image.model",
                    "digest": dg, "size": len(data)}],
    })
    registry.add_manifest("multi", {
        "mediaType": "application/vnd.oci.image.index.v1+json",
        "manifests": [
            {"digest": "sha256:deadbeef",
             "platform": {"os": "windows", "architecture": "amd64"}},
            {"digest": child,
             "platform": {"os": "linux", "architecture": "amd64"}},
        ],
    })
    registry.add_manifest("first", {"manifests": [
        {"digest": child, "platform": {"os": "linux",
                                       "architecture": "arm64"}}]})
    registry.add_manifest("empty", {"manifests": []})
    for tag in ("multi", "first"):
        out = oci.ollama_fetch_model(f"http://{registry.host}/m:{tag}",
                                     tmp_path / tag)
        assert out.read_bytes() == data
    with pytest.raises(ValueError, match="empty manifest index"):
        oci.ollama_fetch_model(f"http://{registry.host}/m:empty",
                               tmp_path / "e")


@pytest.mark.parametrize("mod", MODS)
def test_downloader_routes_ollama_and_oci_schemes(registry, tmp_path, mod):
    """``download_uri`` sends ollama:// to the model layer and oci:// to
    an extraction beside the destination."""
    _, dl = MODS[mod]
    weights = b"model-via-downloader"
    dg = registry.add_blob(weights)
    registry.add_manifest("latest", {
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "layers": [{"mediaType": "application/vnd.ollama.image.model",
                    "digest": dg, "size": len(weights)}],
    })
    dest = dl.download_uri(f"ollama://http://{registry.host}/mymodel",
                           tmp_path / "w.gguf")
    assert dest.read_bytes() == weights
    layer = _tar_bytes({"a/b.txt": b"inside"})
    registry.add_manifest("img", {"layers": [
        {"mediaType": "application/vnd.oci.image.layer.v1.tar",
         "digest": registry.add_blob(layer), "size": len(layer)}]})
    dest = dl.download_uri(f"oci://http://{registry.host}/m:img",
                           tmp_path / "x" / "model")
    assert (tmp_path / "x" / "a" / "b.txt").read_bytes() == b"inside"
    assert not dest.exists()
