"""The port's model gallery against the JAX package's (``gallery/``,
``utils/downloader.py``, ``api/gallery.py``, the CLI's ``models
install|available``, gallery preload).

Every case of ``tests/test_gallery.py`` runs on both packages, over
``file://`` galleries and over a stdlib HTTP server the test starts (the
index, a definition YAML and the weight files, sha-verified, resumed from
a ``.partial`` file with a ``Range`` header). Installed configs load to
equal dicts through PyYAML and the port's reader; an index written with
anchors and merge keys, as the upstream gallery writes it, lists equal
models; the HTTP routes answer alike (job uuids aside); the CLI prints
what the JAX package prints. The port's models are dataclasses that keep
unknown fields and validate as pydantic does.
"""

import hashlib
import http.server
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import localai_tpu.gallery as jg  # noqa: E402
import localai_tpu.gallery.index_data as jindex  # noqa: E402
import localai_tpu_torch.gallery as tg  # noqa: E402
import localai_tpu_torch.gallery.index_data as tindex  # noqa: E402
from localai_tpu.cli import main as jax_cli  # noqa: E402
from localai_tpu.gallery.models import deep_merge as jmerge  # noqa: E402
from localai_tpu.gallery.service import _human as jhuman  # noqa: E402
from localai_tpu.utils import downloader as jdl  # noqa: E402
from localai_tpu_torch.cli import main as cli  # noqa: E402
from localai_tpu_torch.config.yaml_subset import safe_load  # noqa: E402
from localai_tpu_torch.gallery.models import deep_merge  # noqa: E402
from localai_tpu_torch.gallery.service import _human  # noqa: E402
from localai_tpu_torch.utils import downloader as tdl  # noqa: E402

PKGS = {"jax": jg, "port": tg}


def _dump(m) -> dict:
    return m.model_dump()


# -- fixtures ---------------------------------------------------------------


def _index(blob: Path, uri: str) -> list:
    sha = hashlib.sha256(blob.read_bytes()).hexdigest()
    return [{
        "name": "fixture-model",
        "description": "test model",
        "license": "mit",
        "files": [{"filename": "fixture-model/weights.bin", "uri": uri,
                   "sha256": sha}],
        "config_file": {"model": "debug:tiny", "context_size": 64,
                        "parameters": {"temperature": 0.2},
                        "template": {"chat": "{{.Input}}\n{{- if .X}}\n"
                                             "  yes\n{{end}}\n"},
                        "stopwords": ["<|im_end|>", "yes", "1"]},
        "overrides": {"parameters": {"top_k": 7}},
        "homepage": "an unknown field, kept",
    }]


@pytest.fixture()
def fixture_gallery(tmp_path):
    """A file:// gallery with one model whose weight file is file://."""
    blob = tmp_path / "weights.bin"
    blob.write_bytes(b"\x00" * 64)
    path = tmp_path / "index.yaml"
    path.write_text(yaml.safe_dump(_index(blob, f"file://{blob}")))
    return {k: p.Gallery(name="test", url=f"file://{path}")
            for k, p in PKGS.items()}


class _Files:
    """A stdlib HTTP server of a directory that counts Range requests."""

    def __init__(self, root: Path):
        served = self
        self.ranges: list = []

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **k):
                super().__init__(*a, directory=str(root), **k)

            def log_message(self, *a):
                pass

            def do_GET(self):
                rng = self.headers.get("Range")
                if not rng:
                    return super().do_GET()
                served.ranges.append(rng)
                data = (root / self.path.lstrip("/")).read_bytes()
                start = int(rng.split("=")[1].split("-")[0])
                if start >= len(data):
                    self.send_response(416)
                    self.end_headers()
                    return
                self.send_response(206)
                self.send_header("Content-Length", str(len(data) - start))
                self.end_headers()
                self.wfile.write(data[start:])

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def http_gallery(tmp_path):
    """The same gallery over HTTP: the index uses an anchor and merge
    keys and points at a definition YAML, which lists two weight files."""
    root = tmp_path / "www"
    (root / "w").mkdir(parents=True)
    (root / "w" / "a.bin").write_bytes(bytes(range(256)) * 4096)   # 1 MiB
    (root / "w" / "b.bin").write_bytes(b"b" * 3000)
    files = _Files(root)
    shas = {n: hashlib.sha256((root / "w" / n).read_bytes()).hexdigest()
            for n in ("a.bin", "b.bin")}
    (root / "def.yaml").write_text(yaml.safe_dump({
        "config_file": {"model": "debug:tiny", "context_size": 64,
                        "engine": {"dtype": "float32",
                                   "kv_dtype": "float32"}},
        "files": [{"filename": f"http-model/{n}",
                   "uri": f"{files.base}/w/{n}", "sha256": shas[n]}
                  for n in ("a.bin", "b.bin")],
        "overrides": {"parameters": {"temperature": 0.1}}}))
    (root / "index.yaml").write_text(
        "- &base\n"
        "  name: http-base\n"
        "  description: served over HTTP\n"
        "  license: apache-2.0\n"
        f"  url: {files.base}/def.yaml\n"
        "  tags: [llm]\n"
        "- !!merge <<: *base\n"
        "  name: http-model\n"
        "- <<: [*base, {icon: i.png, license: mit}]\n"
        "  name: http-model-2\n"
        "  tags: [llm, chat]\n")
    yield files
    files.close()


@pytest.fixture()
def models_dirs(tmp_path):
    out = {}
    for k in PKGS:
        out[k] = tmp_path / f"models-{k}"
        out[k].mkdir()
    return out


# -- the cases of tests/test_gallery.py, on both packages -------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_find_and_available(fixture_gallery, models_dirs, pkg):
    g = PKGS[pkg]
    gal = fixture_gallery[pkg]
    models = g.available_models([gal], models_dirs[pkg])
    assert models[0].name == "fixture-model"
    assert not models[0].installed
    assert all(m.gallery == "shipped" for m in models[1:])
    assert g.find_model([gal], "fixture-model") is not None
    assert g.find_model([gal], "test@fixture-model") is not None
    assert g.find_model([gal], "fixture-model@test") is not None
    assert g.find_model([gal], "nope") is None


def test_available_listings_are_equal(fixture_gallery, models_dirs):
    got = {k: [_dump(m) for m in PKGS[k].available_models(
        [fixture_gallery[k]], models_dirs[k])] for k in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][0]["homepage"] == "an unknown field, kept"


@pytest.mark.parametrize("pkg", PKGS)
def test_install_and_delete(fixture_gallery, models_dirs, pkg):
    g = PKGS[pkg]
    gal, mdir = fixture_gallery[pkg], models_dirs[pkg]
    model = g.find_model([gal], "fixture-model")
    cfg_path = g.install_model(model, mdir)
    assert cfg_path.exists()
    doc = yaml.safe_load(cfg_path.read_text())
    assert doc["name"] == "fixture-model"
    assert doc["parameters"]["temperature"] == 0.2
    assert doc["parameters"]["top_k"] == 7
    assert (mdir / "fixture-model/weights.bin").exists()
    assert g.available_models([gal], mdir)[0].installed
    assert g.delete_model("fixture-model", mdir)
    assert not cfg_path.exists()
    assert not (mdir / "fixture-model/weights.bin").exists()
    assert not (mdir / "fixture-model").exists()
    assert not g.delete_model("fixture-model", mdir)


def test_installed_configs_load_equal(fixture_gallery, models_dirs):
    paths = {k: PKGS[k].install_model(
        PKGS[k].find_model([fixture_gallery[k]], "fixture-model"),
        models_dirs[k], install_name="renamed",
        overrides={"context_size": 128, "parameters": {"seed": -1}})
        for k in PKGS}
    docs = {k: yaml.safe_load(p.read_text()) for k, p in paths.items()}
    assert docs["port"] == docs["jax"]
    assert safe_load(paths["jax"].read_text()) == docs["jax"]
    assert safe_load(paths["port"].read_text()) == docs["jax"]
    assert docs["port"]["name"] == "renamed"
    assert docs["port"]["template"]["chat"].startswith("{{.Input}}\n")
    assert docs["port"]["stopwords"] == ["<|im_end|>", "yes", "1"]


@pytest.mark.parametrize("pkg", PKGS)
def test_sha_mismatch_rejected(tmp_path, models_dirs, pkg):
    g = PKGS[pkg]
    blob = tmp_path / "w.bin"
    blob.write_bytes(b"data")
    model = g.GalleryModel(
        name="bad",
        files=[{"filename": "bad/w.bin", "uri": f"file://{blob}",
                "sha256": "0" * 64}],
    )
    with pytest.raises(ValueError, match="sha256 mismatch"):
        g.install_model(model, models_dirs[pkg])


@pytest.mark.parametrize("pkg", PKGS)
def test_path_traversal_rejected(tmp_path, models_dirs, pkg):
    g = PKGS[pkg]
    blob = tmp_path / "w.bin"
    blob.write_bytes(b"data")
    model = g.GalleryModel(
        name="evil",
        files=[{"filename": "../../etc/evil.bin", "uri": f"file://{blob}"}],
    )
    with pytest.raises(ValueError, match="escapes"):
        g.install_model(model, models_dirs[pkg])


@pytest.mark.parametrize("base,over", [
    ({"a": {"x": 1, "y": 2}, "b": 1}, {"a": {"y": 3}, "c": 4}),
    ({"a": [1, 2], "b": {"c": {"d": 1}}}, {"a": [3], "b": {"c": {"e": 2}}}),
    ({"a": {"x": 1}}, {"a": 5}),
    ({}, {"a": {"b": None}}),
])
def test_deep_merge(base, over):
    assert deep_merge(base, over) == jmerge(base, over)
    assert deep_merge(
        {"a": {"x": 1, "y": 2}, "b": 1}, {"a": {"y": 3}, "c": 4},
    ) == {"a": {"x": 1, "y": 3}, "b": 1, "c": 4}


@pytest.mark.parametrize("pkg", PKGS)
def test_embedded_library(models_dirs, pkg):
    g = PKGS[pkg]
    m = g.resolve_embedded("debug-tiny")
    assert m is not None
    path = g.install_model(m, models_dirs[pkg])
    doc = yaml.safe_load(path.read_text())
    assert doc["model"] == "debug:tiny"
    assert g.resolve_embedded("no-such-model") is None


def test_embedded_and_shipped_entries_are_the_jax_packages():
    assert {k: _dump(m) for k, m in tg.EMBEDDED_MODELS.items()} == \
        {k: _dump(m) for k, m in jg.EMBEDDED_MODELS.items()}
    assert [_dump(m) for m in tindex.shipped_index()] == \
        [_dump(m) for m in jindex.shipped_index()]


def _wait_job(svc, job_id, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = svc.status(job_id)
        if st is not None and st.processed:
            return st
        time.sleep(0.02)
    raise TimeoutError("job never finished")


@pytest.mark.parametrize("pkg", PKGS)
def test_gallery_service_jobs(fixture_gallery, models_dirs, pkg):
    g = PKGS[pkg]
    installed, deleted = [], []
    svc = g.GalleryService(str(models_dirs[pkg]), [fixture_gallery[pkg]],
                           on_installed=installed.append,
                           on_deleted=deleted.append)
    try:
        job = svc.submit(g.GalleryOp(id="", kind="apply",
                                     gallery_ref="fixture-model"))
        st = _wait_job(svc, job)
        assert st.error == "" and st.progress == 100.0
        assert st.message == "completed"
        assert installed and installed[0].name == "fixture-model.yaml"
        job2 = svc.submit(g.GalleryOp(id="", kind="delete",
                                      install_name="fixture-model"))
        st2 = _wait_job(svc, job2)
        assert st2.error == "" and st2.deletion and deleted == [
            "fixture-model"]
        job3 = svc.submit(g.GalleryOp(id="", kind="apply",
                                      gallery_ref="missing-model"))
        st3 = _wait_job(svc, job3)
        assert "missing-model" in st3.error and st3.message == "error"
        assert set(svc.all_status()) == {job, job2, job3}
    finally:
        svc.shutdown()


def test_job_statuses_are_equal(http_gallery, models_dirs):
    """The same ops through both job runners end in equal statuses, the
    progress reported in percent with the JAX package's human sizes."""
    states = {}
    for k, g in PKGS.items():
        seen = []
        gal = g.Gallery(name="h", url=f"{http_gallery.base}/index.yaml")
        svc = g.GalleryService(str(models_dirs[k]), [gal])
        try:
            ids = [svc.submit(g.GalleryOp(id="", kind="apply",
                                          gallery_ref="h@http-model")),
                   svc.submit(g.GalleryOp(id="", kind="delete",
                                          install_name="http-model")),
                   svc.submit(g.GalleryOp(id="", kind="delete",
                                          install_name="http-model"))]
            for i in ids:
                st = _wait_job(svc, i)
                seen.append(st.as_dict())
        finally:
            svc.shutdown()
        states[k] = seen
    assert states["port"] == states["jax"]
    assert states["port"][0]["file_size"] == "2.9 KiB"
    for n in (0, 1023, 1024, 5 << 20, 3 << 30, 7 << 40, 9 << 50):
        assert _human(n) == jhuman(n)


# -- over HTTP: indexes with anchors and merge keys, definitions, resume ----


def test_http_index_with_anchors_lists_equal_models(http_gallery, tmp_path):
    got = {}
    for k, g in PKGS.items():
        gal = g.Gallery(name="h", url=f"{http_gallery.base}/index.yaml")
        got[k] = [_dump(m) for m in g.load_gallery_index(gal)]
    assert got["port"] == got["jax"]
    names = [m["name"] for m in got["port"]]
    assert names == ["http-base", "http-model", "http-model-2"]
    assert got["port"][1]["url"] == got["port"][0]["url"]
    # a sequence merge: the first mapping wins (base's license)
    assert got["port"][2]["license"] == "apache-2.0"
    assert got["port"][2]["icon"] == "i.png"


def test_http_install_through_a_definition(http_gallery, models_dirs):
    seen = {k: [] for k in PKGS}
    paths = {}
    for k, g in PKGS.items():
        gal = g.Gallery(name="h", url=f"{http_gallery.base}/index.yaml")
        m = g.find_model([gal], "http-model@h")
        paths[k] = g.install_model(
            m, models_dirs[k],
            progress=lambda f, d, t, _k=k: seen[_k].append((f, d, t)))
    docs = {k: yaml.safe_load(p.read_text()) for k, p in paths.items()}
    assert docs["port"] == docs["jax"]
    assert docs["port"]["downloaded_files"] == ["http-model/a.bin",
                                                "http-model/b.bin"]
    for k in PKGS:
        assert (models_dirs[k] / "http-model/a.bin").stat().st_size == 1 << 20
    assert seen["port"][-1] == seen["jax"][-1] == (
        "http-model/b.bin", 3000, 3000)
    assert seen["port"][0][2] == 1 << 20


@pytest.mark.parametrize("mod", [jdl, tdl], ids=["jax", "port"])
def test_partial_download_resumes_with_a_range(http_gallery, tmp_path, mod):
    """A ``.partial`` left by an interrupted download resumes from its
    size with a ``Range`` header, and a sha mismatch deletes the file."""
    src = bytes(range(256)) * 4096
    dest = tmp_path / "a.bin"
    dest.with_suffix(".bin.partial").write_bytes(src[:1000])
    progress = []
    before = len(http_gallery.ranges)
    mod.download_uri(f"{http_gallery.base}/w/a.bin", dest,
                     sha256=hashlib.sha256(src).hexdigest(),
                     progress=lambda d, t: progress.append((d, t)))
    assert dest.read_bytes() == src
    assert http_gallery.ranges[before:] == ["bytes=1000-"]
    assert progress[-1] == (len(src), len(src))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        mod.download_uri(f"{http_gallery.base}/w/b.bin", tmp_path / "b",
                         sha256="0" * 64)
    assert not (tmp_path / "b").exists()


@pytest.mark.parametrize("uri", [
    "huggingface://owner/repo/file.bin", "hf://o/r/sub/dir/f.gguf@dev",
    "github:mudler/LocalAI/gallery/index.yaml@master",
    "github://o/r/x.yaml", "https://example.invalid/x", "file:///tmp/x",
    "oci://quay.io/o/r:t", "ollama://gemma:2b", "plain-name"])
def test_resolve_url_and_looks_like_url_as_the_jax_package(uri):
    assert tdl.resolve_url(uri) == jdl.resolve_url(uri)
    assert tdl.looks_like_url(uri) == jdl.looks_like_url(uri)


@pytest.mark.parametrize("uri", ["huggingface://o/r", "github:o/r"])
def test_resolve_url_refuses_short_refs(uri):
    for mod in (jdl, tdl):
        with pytest.raises(ValueError, match="needs owner/repo/file"):
            mod.resolve_url(uri)


def test_sha256_file_as_the_jax_package(tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"x" * (3 << 20))
    assert tdl.sha256_file(p) == jdl.sha256_file(p)


# -- the schema: validation as pydantic's --------------------------------


@pytest.mark.parametrize("doc", [
    {"name": "x", "files": [{"filename": "a", "uri": "b", "extra": 1}],
     "zzz": [1], "urls": ["u"]},
    {"name": "x", "installed": "yes"},
    {"name": "x", "installed": 0},
    {"name": "x", "config_file": None, "overrides": {}},
    {"name": 1}, {"name": "x", "urls": "abc"},
    {"name": "x", "overrides": {1: 2}}, {"name": "x", "config_file": [1]},
    {"name": "x", "files": [{"filename": "a"}]}, {"name": "x", "tags": None},
    {"name": "x", "description": None}, {}, [1], "name",
], ids=lambda d: json.dumps(d, default=str)[:40])
def test_model_validation_as_pydantic(doc):
    try:
        want = jg.GalleryModel.model_validate(doc).model_dump()
    except Exception:  # noqa: BLE001 — pydantic's ValidationError
        want = None
    try:
        got = tg.GalleryModel.model_validate(doc).model_dump()
    except ValueError:
        got = None
    assert got == want


def test_model_copy_and_id():
    m = tg.GalleryModel.model_validate({"name": "m", "files": [
        {"filename": "f", "uri": "u"}], "extra": {"k": 1}})
    shallow = m.model_copy(update={"gallery": "g"})
    assert shallow.id == "g@m" and m.id == "m"
    assert shallow.files is m.files
    deep = m.model_copy(deep=True)
    assert deep == m and deep.files is not m.files
    assert m.extra == {"k": 1}
    with pytest.raises(AttributeError):
        m.nothing_here  # noqa: B018


# -- the routes, the CLI and preload ---------------------------------------


@pytest.fixture()
def servers(tmp_path, http_gallery):
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager
    from test_api import _ServerThread, make_state

    out = {}
    mp, mj = tmp_path / "port-models", tmp_path / "jax-models"
    mp.mkdir()
    mj.mkdir()
    port = APIServer(ModelManager(AppConfig(
        model_path=str(mp), device="cpu",
        upload_path=str(mp) + "_uploads"), ConfigLoader(mp)),
        "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(mj))
    out = {"port": port.url, "ref": ref.base, "gallery": http_gallery.base}
    yield out
    ref.state.shutdown()
    ref.stop()
    port.shutdown()


def _call(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _until_processed(base, job):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = _call(base + job["status"])[1]
        if st["processed"]:
            return st
        time.sleep(0.02)
    raise TimeoutError(job)


def test_routes_answer_as_the_jax_server(servers):
    """The eight routes on both servers, one script: statuses and bodies
    equal, job uuids aside; an installed model is configured at once and
    a deleted one leaves ``/v1/models``."""
    gal = f"{servers['gallery']}/index.yaml"
    script = [
        ("GET", "/models/galleries", None),
        ("POST", "/models/galleries", {"name": "h", "url": gal}),
        ("POST", "/models/galleries", {"name": "h", "url": gal}),   # 409
        ("POST", "/models/galleries", {"name": "h2"}),               # 400
        ("GET", "/models/galleries", None),
        ("GET", "/models/available", None),
        ("POST", "/models/apply", {}),                               # 400
        ("GET", "/models/jobs/nope", None),                          # 404
        ("DELETE", "/models/galleries", {"name": "nope"}),           # 404
    ]
    for method, path, body in script:
        got = {k: _call(servers[k] + path, method, body)
               for k in ("port", "ref")}
        assert got["port"] == got["ref"], (method, path, got)
    jobs = {}
    for k in ("port", "ref"):
        status, job = _call(servers[k] + "/models/apply", "POST",
                            {"id": "h@http-model"})
        assert status == 200 and job["status"] == f"/models/jobs/{job['uuid']}"
        jobs[k] = _until_processed(servers[k], job)
    assert jobs["port"] == jobs["ref"]
    assert not jobs["port"]["error"]
    for k in ("port", "ref"):
        names = {m["id"] for m in _call(servers[k] + "/v1/models")[1]["data"]}
        assert "http-model" in names
    avail = {k: _call(servers[k] + "/models/available")[1]
             for k in ("port", "ref")}
    assert avail["port"] == avail["ref"]
    assert [m["installed"] for m in avail["port"]
            if m["name"] == "http-model"] == [True]
    for k in ("port", "ref"):
        # an inline definition by URL, installed under a name
        status, job = _call(servers[k] + "/models/apply", "POST", {
            "url": f"{servers['gallery']}/def.yaml", "name": "inline"})
        jobs[k] = _until_processed(servers[k], job)
    assert jobs["port"] == jobs["ref"]
    for k in ("port", "ref"):
        status, job = _call(servers[k] + "/models/delete/http-model", "POST",
                            {})
        jobs[k] = _until_processed(servers[k], job)
        names = {m["id"] for m in _call(servers[k] + "/v1/models")[1]["data"]}
        assert "http-model" not in names and "inline" in names
    assert jobs["port"] == jobs["ref"]
    all_jobs = {k: sorted(json.dumps(v, sort_keys=True) for v in _call(
        servers[k] + "/models/jobs")[1].values()) for k in ("port", "ref")}
    assert all_jobs["port"] == all_jobs["ref"] and len(all_jobs["port"]) == 3
    got = {k: _call(servers[k] + "/models/galleries", "DELETE",
                    {"name": "h"}) for k in ("port", "ref")}
    assert got["port"] == got["ref"] == (200, {"removed": "h"})


def _outputs(argv, capsys):
    out = []
    for main in (cli.main, jax_cli.main):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
        out.append((rc, capsys.readouterr().out))
    return out


def test_cli_models_available_and_install(capsys, tmp_path, http_gallery):
    galleries = json.dumps([{"name": "h",
                             "url": f"{http_gallery.base}/index.yaml"}])
    mp = tmp_path / "models"
    port, ref = _outputs(["models", "available", "--models-path", str(mp),
                          "--galleries", galleries], capsys)
    assert port == ref and port[0] == 0
    assert "  h@http-model\tserved over HTTP" in port[1]
    assert "  embedded@debug-tiny\t" in port[1]
    outs = []
    for i, main in enumerate((cli.main, jax_cli.main)):
        d = tmp_path / f"m{i}"
        assert main(["models", "install", "h@http-model", "--models-path",
                     str(d), "--galleries", galleries]) == 0
        outs.append(capsys.readouterr().out.replace(str(d), "<models>"))
    assert outs[0] == outs[1]
    assert outs[0].endswith("installed → <models>/http-model.yaml\n")
    assert yaml.safe_load((tmp_path / "m0" / "http-model.yaml").read_text()) \
        == yaml.safe_load((tmp_path / "m1" / "http-model.yaml").read_text())
    port, ref = _outputs(["models", "available", "--models-path",
                          str(tmp_path / "m0"), "--galleries", galleries],
                         capsys)
    assert port == ref and "* h@http-model" in port[1]
    # an unknown ref: both exit 2
    rcs = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["models", "install", "nope", "--models-path", str(mp)])
        rcs.append(e.value.code)
    assert rcs == [2, 2]
    capsys.readouterr()


def test_preload_installs_a_gallery_ref(tmp_path, caplog):
    """A preload name no config has installs from the embedded library
    (and registers), as the JAX package's serve does; an unknown one
    logs the JAX package's warning."""
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager

    mp = tmp_path / "models"
    mp.mkdir()
    loader = ConfigLoader(mp)
    m = ModelManager(AppConfig(model_path=str(mp), device="cpu",
                               preload_models=["debug-tiny", "nope"]),
                     loader)
    try:
        with caplog.at_level(logging.WARNING):
            m.preload()
        assert loader.exists("debug-tiny") and (mp / "debug-tiny.yaml") \
            .exists()
        assert "preload: unknown model ref 'nope'" in caplog.text
        assert m.loaded_names() == ["debug-tiny"]
    finally:
        m.shutdown()
