"""The image routes of the port's server, on the CPU, beside the JAX
package's.

One models dir with ``debug:sd-tiny`` (``backend: diffusers``) and a
chat model (no image usecase); both servers answer
``POST /v1/images/generations``
and ``GET /generated-images/{name}``. The weights differ (each package
draws its own preset), so the images are compared by size and format;
statuses and JSON keys are compared with the JAX package's: ``b64_json``
and ``url`` answers, a ``size`` that is not bucketed (odd widths), ``n``
copies with seeds ``seed + j`` (the copies differ, a repeated seed
repeats), a list of prompts, ``positive|negative``, ``file`` as raw
base64 (both) and as a data URI (the port), a bad ``size``, an unknown
model (404), a model without the image usecase (400), the path guard of
the file route (404). PIL decodes every PNG the port writes to the
pixels the port's own decoder reads, odd widths included.
"""

import base64
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
PIL = pytest.importorskip("PIL.Image")
yaml = pytest.importorskip("yaml")

from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.utils import png  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

GEN = "/v1/images/generations"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    models = root / "models"
    models.mkdir()
    docs = {"sd": {"backend": "diffusers", "model": "debug:sd-tiny",
                   "diffusers": {"steps": 2}},
            "chat": {"model": "debug:tiny"}}
    for name, doc in docs.items():
        (models / f"{name}.yaml").write_text(
            yaml.safe_dump({"name": name, **doc}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device="cpu",
                                     image_path=str(root / "port-images")),
                           loader)
    port = APIServer(manager, "127.0.0.1", 0).start()
    state = make_state(models)
    state.config.image_path = str(root / "jax-images")
    ref = _ServerThread(state)
    yield {"port": port.url, "ref": ref.base, "root": root,
           "manager": manager}
    ref.stop()
    port.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), None


def _png(b64: str) -> np.ndarray:
    data = base64.b64decode(b64)
    mine = png.decode(data)
    theirs = np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(mine, theirs)
    return mine


def test_b64_json_at_an_odd_size_on_both_servers(servers):
    body = {"model": "sd", "prompt": "a red fox|blurry", "size": "63x45",
            "response_format": "b64_json", "seed": 3}
    shapes = []
    for base in (servers["port"], servers["ref"]):
        status, out = _post(base + GEN, body)
        assert status == 200, out
        assert set(out) == {"id", "created", "data"}
        assert [set(d) for d in out["data"]] == [{"b64_json"}]
        shapes.append(_png(out["data"][0]["b64_json"]).shape)
    assert shapes == [(45, 63, 3)] * 2


def test_n_copies_take_seed_offsets(servers):
    base = servers["port"]
    body = {"model": "sd", "prompt": ["a cat", "a dog"], "n": 2, "seed": 7,
            "size": "64x64", "response_format": {"type": "b64_json"}}
    status, out = _post(base + GEN, body)
    assert status == 200 and len(out["data"]) == 4
    imgs = [_png(d["b64_json"]) for d in out["data"]]
    assert not np.array_equal(imgs[0], imgs[1])
    # copy j of a prompt is the single image at seed + j
    status, one = _post(base + GEN, {**body, "prompt": "a dog", "n": 1,
                                     "seed": 8})
    assert np.array_equal(_png(one["data"][0]["b64_json"]), imgs[3])
    _, ref = _post(servers["ref"] + GEN, body)
    assert len(ref["data"]) == 4


def test_url_answers_are_served_and_path_guarded(servers):
    for base in (servers["port"], servers["ref"]):
        status, out = _post(base + GEN, {"model": "sd", "prompt": "a cat",
                                         "size": "64x64"})
        assert status == 200
        url = out["data"][0]["url"]
        assert url.startswith(base + "/generated-images/")
        status, data, ctype = _get(url)
        assert status == 200 and ctype.startswith("image/png")
        assert PIL.open(io.BytesIO(data)).size == (64, 64)
        for bad in ("/generated-images/..%2F..%2Fmodels%2Fsd.yaml",
                    "/generated-images/missing.png"):
            assert _get(base + bad)[0] == 404
    assert len(list((servers["root"] / "port-images").glob("*.png"))) == 1


@pytest.mark.parametrize("body,status", [
    ({"model": "sd", "prompt": "x", "size": "big"}, 400),
    ({"model": "sd", "prompt": "x", "size": "4096x64"}, 400),
    ({"model": "nope", "prompt": "x"}, 404),
    ({"model": "chat", "prompt": "x"}, 400),
    ({"model": "sd", "prompt": "x", "file": "not base64 !"}, 400),
    ({"model": "sd", "prompt": "x",
      "file": base64.b64encode(b"GIF89a not really").decode()}, 400),
])
def test_errors_answer_as_the_jax_package(servers, body, status):
    assert _post(servers["port"] + GEN, body)[0] == status
    assert _post(servers["ref"] + GEN, body)[0] == status


def test_file_as_base64_and_as_a_data_uri(servers):
    rng = np.random.default_rng(1)
    init = rng.integers(0, 256, (40, 56, 3), np.uint8)
    raw = base64.b64encode(png.encode(init)).decode()
    body = {"model": "sd", "prompt": "a cat", "size": "64x64", "seed": 2,
            "response_format": "b64_json"}
    _, plain = _post(servers["port"] + GEN, body)
    outs = []
    for file in (raw, "data:image/png;base64," + raw):
        status, out = _post(servers["port"] + GEN, {**body, "file": file})
        assert status == 200
        outs.append(_png(out["data"][0]["b64_json"]))
    assert np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], _png(plain["data"][0]["b64_json"]))
    status, _ = _post(servers["ref"] + GEN, {**body, "file": raw})
    assert status == 200
    assert servers["manager"].monitor("sd")["images_generated"] >= 3


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (45, 71), (64, 33),
                                 (17, 129)])
def test_png_encoder_round_trips_through_pil(h, w):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8)
    data = png.encode(img)
    assert np.array_equal(np.asarray(PIL.open(io.BytesIO(data))), img)
    assert np.array_equal(png.decode(data), img)


def test_png_encoder_refuses_what_it_does_not_write():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3),
                                                          np.uint8)):
        with pytest.raises(ValueError):
            png.encode(bad)


def test_image_routes_are_traced_and_counted(servers):
    """The routes go through the server's request wrapper: a trace id
    comes back, and the call lands in the API-call metric by its route
    pattern (the file route's too)."""
    base = servers["port"]
    req = urllib.request.Request(
        base + GEN, data=json.dumps({"model": "sd", "prompt": "x",
                                     "size": "64x64", "step": 1}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Trace-ID": "image-trace-1"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["X-Trace-ID"] == "image-trace-1"
        url = json.loads(r.read())["data"][0]["url"]
    assert _get(url)[0] == 200
    _, metrics, _ = _get(base + "/metrics")
    text = metrics.decode()
    assert 'path="/v1/images/generations"' in text
    assert 'path="/generated-images/{name}"' in text
    status, trace, _ = _get(base + "/v1/traces/image-trace-1")
    assert status == 200 and b"/v1/images/generations" in trace
