"""The port's vector store and its ``/stores/*`` routes against the JAX
package's (``stores/store.py``, ``api/stores.py``).

A seeded random sequence of sets (upserts by key, value-only upserts),
deletes (freed rows reused from the free list's end), gets and finds
(exact ties among power-of-two multiples of one vector, ``top_k`` above
the size, a zero query, dimension mismatches, growth across power-of-two
capacities) runs on both stores, the port's on the CPU: every answer is
equal — keys, values and order, ties lower row first as ``lax.top_k``
ranks them, similarities within 1e-6. The four routes give both servers'
bodies and statuses.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from localai_tpu.stores import StoreRegistry as JRegistry  # noqa: E402
from localai_tpu.stores import VectorStore as JStore  # noqa: E402
from localai_tpu_torch.stores import StoreRegistry, VectorStore  # noqa: E402
from localai_tpu_torch.stores.store import topk_cosine  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401


def _same_find(a, b):
    assert a[0] == b[0] and a[1] == b[1]
    np.testing.assert_allclose(a[2], b[2], atol=1e-6)


def _both(fn):
    """``fn`` on both stores: equal results, or the same ValueError."""
    out = []
    for st in STORES:
        try:
            out.append(("ok", fn(st)))
        except ValueError as e:
            out.append(("err", str(e)))
    return out


STORES: list = []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_sequence_equals_the_jax_store(seed):
    global STORES
    rng = np.random.default_rng(seed)
    dim = int(rng.integers(3, 12))
    STORES = [JStore(), VectorStore(device="cpu")]
    base = rng.normal(size=dim).astype(np.float32)
    pool = [rng.normal(size=dim).astype(np.float32) for _ in range(40)]
    # exact ties: power-of-two multiples of one vector
    pool += [base * np.float32(2.0 ** j) for j in range(-2, 3)]
    queries = [base, np.zeros(dim, np.float32)] + [
        rng.normal(size=dim).astype(np.float32) for _ in range(6)]
    assert _both(lambda st: st.find(base, 3)) == [("ok", ([], [], []))] * 2
    for step in range(120):
        op = rng.choice(["set", "set", "upsert", "delete", "get", "find",
                         "bad"])
        if op in ("set", "upsert"):
            n = int(rng.integers(1, 6))
            idx = rng.integers(len(pool), size=n)
            keys = [pool[i] for i in idx]
            vals = [f"{op}{step}.{i}".encode() for i in range(n)]
            res = _both(lambda st: st.set(keys, vals))
        elif op == "delete":
            idx = rng.integers(len(pool), size=int(rng.integers(1, 4)))
            res = _both(lambda st: st.delete([pool[i] for i in idx]))
        elif op == "get":
            idx = rng.integers(len(pool), size=3)
            res = _both(lambda st: st.get([pool[i] for i in idx]))
        elif op == "find":
            q = queries[int(rng.integers(len(queries)))]
            k = int(rng.choice([1, 2, 5, 8, 100]))
            res = _both(lambda st: st.find(q, k))
            if res[0][0] == "ok":
                _same_find(res[0][1], res[1][1])
                continue
        else:   # a key of another dimension, once the first set latched it
            if STORES[0].dim is None:
                continue
            bad = rng.normal(size=dim + 1).astype(np.float32)
            res = _both(lambda st: st.set([bad], [b"x"]))
            assert res[0][0] == "err"
        assert res[0] == res[1], (step, op)
        assert len(STORES[0]) == len(STORES[1])
    # the free list and row reuse left both stores with the same rows
    assert STORES[0]._free == STORES[1]._free  # noqa: SLF001
    assert STORES[0]._cap == STORES[1]._cap  # noqa: SLF001


def test_ties_rank_lower_rows_first():
    """Keys that point the same way score the same; ``lax.top_k`` puts
    the lower row first, and so must the port (``torch.topk`` does not)."""
    stores = [JStore(), VectorStore(device="cpu")]
    keys = [[1, 0], [0, 1], [2, 0], [4, 0], [0.5, 0], [1, 1]]
    for st in stores:
        st.set(keys, [str(i).encode() for i in range(len(keys))])
        st.delete([[2, 0]])                 # row 2 freed ...
        st.set([[8, 0]], [b"reused"])       # ... and reused
    got = [st.find([1, 0], 6) for st in stores]
    _same_find(*got)
    assert got[1][1][:4] == [b"0", b"reused", b"3", b"4"]
    # the rank on its own: 512 equal scores and a few larger ones
    sims = torch.zeros(512)
    sims[[7, 300]] = 1.0
    valid = torch.ones(512, dtype=torch.bool)
    matrix = torch.eye(512)[:, :1] * 0 + sims[:, None]
    scores, rows = topk_cosine(matrix, torch.ones(512), torch.ones(1),
                               valid, 6)
    assert rows.tolist() == [7, 300, 0, 1, 2, 3]


def test_growth_value_only_upserts_and_empty_finds():
    st, ref = VectorStore(device="cpu"), JStore()
    rng = np.random.default_rng(9)
    for i in range(20):
        v = rng.normal(size=4)
        for s in (st, ref):
            s.set([v], [f"v{i}".encode()])
    q = rng.normal(size=4)
    _same_find(st.find(q, 5), ref.find(q, 5))
    assert st._cap == ref._cap == 32  # noqa: SLF001
    assert not st._dirty  # noqa: SLF001
    # a value-only upsert keeps the matrix clean
    key = st._keys[3]  # noqa: SLF001
    st.set([key], [b"new"])
    assert not st._dirty and st.find(key, 1)[1] == [b"new"]  # noqa: SLF001
    # reads against another dimension miss; they never latch it
    assert st.get([[1, 2]])[1] == [None] and st.delete([[1, 2]]) == 0
    with pytest.raises(ValueError, match="dim 3 != store dim 4"):
        st.find([1, 2, 3], 1)
    with pytest.raises(ValueError, match="same length"):
        st.set([[1, 2, 3, 4]], [])


def test_registry_on_a_device():
    for reg in (JRegistry(), StoreRegistry(device="cpu")):
        a = reg.get("a")
        assert reg.get("a") is a
        assert reg.get("b") is not a
        assert reg.drop("a")
        assert not reg.drop("a")
    assert StoreRegistry(device="cpu").get().device.type == "cpu"
    assert StoreRegistry(device="cpu").get().device_bytes() == 0


# -- the HTTP routes --------------------------------------------------------


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager
    from test_api import _ServerThread, make_state

    models = tmp_path_factory.mktemp("storesrv")
    loader = ConfigLoader(models)
    port = APIServer(ModelManager(AppConfig(
        model_path=str(models), device="cpu",
        upload_path=str(models) + "_port_uploads"), loader),
        "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield {"port": port.url, "ref": ref.base}
    ref.stop()
    port.shutdown()


def _call(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST", headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


ROUTE_CALLS = [
    ("set", {"keys": [[1, 0], [0, 1], [2, 0], [1, 1]],
             "values": ["alpha", {"b64": "YmV0YQ=="}, "gamma", "delta"]}),
    ("set", {"store": "other", "keys": [[1, 0, 0]], "values": ["x"]}),
    ("find", {"key": [1, 0.2], "topk": 3}),
    ("find", {"key": [1, 0], "top_k": 10}),      # ties, lower row first
    ("find", {"store": "other", "key": [0, 0, 1]}),
    ("get", {"keys": [[0, 1], [5, 5], [1]]}),
    ("delete", {"keys": [[0, 1], [9, 9]]}),
    ("get", {"keys": [[0, 1]]}),
    ("set", {"keys": [[3, 3]], "values": ["reuses row 1"]}),
    ("find", {"key": [1, 1], "topk": 2}),
    ("find", {"store": "empty", "key": [1, 2]}),
    ("find", {}),                                 # need key
    ("find", {"key": [1, 0], "topk": "many"}),
    ("find", {"key": [1, 0], "topk": -1}),
    ("find", {"key": [1, 0, 0]}),                 # another dimension
    ("set", {"keys": [[1, 0, 0, 0]], "values": ["x"]}),
    ("set", {"keys": [[4, 4]], "values": [{"b64": "!!"}]}),
    ("set", {"keys": [[4, 4]], "values": [7]}),
    ("delete", {}),
]


def test_routes_answer_as_the_jax_server(servers):
    for i, (route, body) in enumerate(ROUTE_CALLS):
        got = {k: _call(f"{servers[k]}/stores/{route}", body)
               for k in ("port", "ref")}
        assert got["port"] == got["ref"], (i, route, body)


def test_routes_refuse_a_bad_body_alike(servers):
    got = {k: _call(f"{servers[k]}/stores/set", b"{not json")[0]
           for k in ("port", "ref")}
    assert got == {"port": 400, "ref": 400}
