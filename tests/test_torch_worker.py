"""The port's worker against the JAX package's, call by call, on the CPU.

Both packages' ``serve_worker`` run in this process on one tiny
checkpoint (debug:tiny's weights written once in float32), each driven by
its own client through one script of calls: health and status before a
load, a predict before a load, the load, greedy predicts and streams
(frame by frame), a constrained predict, embeddings (within 1e-4),
tokenization, the metrics and telemetry payloads' keys, the modality calls
a model worker does not serve, a prefill → transfer handoff between two
workers of each package, a dropped stream that frees its slot, and the
vector-store worker's four calls. The replies, streamed frames, status
codes and details are equal.

A real port worker process (``LOCALAI_DEVICE=cpu``) is spawned by
``WorkerPool``, killed with SIGKILL and respawned; the busy/idle
watchdog's two cases run as the JAX package's tests run them.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")

from localai_tpu.worker import backend_pb2 as jpb  # noqa: E402
from localai_tpu.worker import server as jserver  # noqa: E402
from localai_tpu.worker.client import WorkerClient as JaxClient  # noqa: E402
from localai_tpu_torch.models.loader import write_llama_checkpoint  # noqa: E402
from localai_tpu_torch.models.registry import resolve_model  # noqa: E402
from localai_tpu_torch.worker import backend_pb2 as pb  # noqa: E402
from localai_tpu_torch.worker import rpc  # noqa: E402
from localai_tpu_torch.worker import server  # noqa: E402
from localai_tpu_torch.worker.client import WorkerClient  # noqa: E402
from localai_tpu_torch.worker.process import Watchdog, WorkerPool  # noqa: E402

WAIT = 120.0


def _yaml(ckpt) -> str:
    return (f"name: tiny\nmodel: {ckpt}\ncontext_size: 256\nengine:\n"
            "  dtype: float32\n  kv_dtype: float32\n  kv_block_tokens: 16\n"
            "  max_slots: 4\n")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("worker")
    tiny = resolve_model("debug:tiny", dtype="float32", device="cpu")
    return write_llama_checkpoint(root / "tiny", tiny.cfg, tiny.params)


class _Side:
    """One package's worker, client and message module."""

    def __init__(self, mod, client_cls, msgs, servicer):
        self.servicer = servicer
        self.server, port = mod.serve_worker("127.0.0.1:0",
                                             servicer=servicer, block=False)
        self.client = client_cls(f"127.0.0.1:{port}")
        self.pb = msgs

    def close(self):
        self.client.close()
        self.servicer.shutdown()
        self.server.stop(grace=None)


@pytest.fixture(scope="module")
def sides(ckpt):
    """(port, jax): two workers a package, both with the tiny model loaded
    but for the script's first calls, which run on the first pair before
    its load."""
    saved = os.environ.get("LOCALAI_DEVICE")
    os.environ["LOCALAI_DEVICE"] = "cpu"    # the port servicer's device
    made = []
    try:
        for _ in range(2):
            made.append((
                _Side(server, WorkerClient, pb, server.BackendServicer()),
                _Side(jserver, JaxClient, jpb, jserver.BackendServicer())))
        yield made
    finally:
        for port_side, jax_side in made:
            port_side.close()
            jax_side.close()
        if saved is None:
            os.environ.pop("LOCALAI_DEVICE", None)
        else:
            os.environ["LOCALAI_DEVICE"] = saved


def _reply(r) -> tuple:
    return (bytes(r.message), r.tokens, r.prompt_tokens, r.finish_reason)


def _loaded(sides, ckpt):
    for pair in sides:
        for side in pair:
            if side.client.status().state != side.pb.StatusResponse.READY:
                res = side.client.load_model(config_yaml=_yaml(ckpt))
                assert res.success and res.message == "ok", res.message
    return sides[0]


def test_health_and_status_before_load(sides):
    port, jax = sides[0]
    assert port.client.health() and jax.client.health()
    assert port.client.status().state == jax.client.status().state \
        == jpb.StatusResponse.UNINITIALIZED


def test_predict_before_load_fails_alike(sides):
    port, jax = sides[0]
    with pytest.raises(rpc.RpcError) as e:
        port.client.predict(pb.PredictOptions(prompt="x", max_tokens=2))
    with pytest.raises(grpc.RpcError) as je:
        jax.client.predict(jpb.PredictOptions(prompt="x", max_tokens=2))
    assert e.value.code().name == je.value.code().name == \
        "FAILED_PRECONDITION"
    assert e.value.details() == je.value.details()


def test_load_then_greedy_predicts_equal(sides, ckpt):
    port, jax = _loaded(sides, ckpt)
    assert port.client.status().state == jax.client.status().state \
        == jpb.StatusResponse.READY
    for prompt, n in (("hello worker", 12), ("a second prompt", 5)):
        r = port.client.predict(pb.PredictOptions(
            prompt=prompt, max_tokens=n, temperature=0.0))
        jr = jax.client.predict(jpb.PredictOptions(
            prompt=prompt, max_tokens=n, temperature=0.0))
        assert _reply(r) == _reply(jr)


def test_stream_frames_equal(sides, ckpt):
    port, jax = _loaded(sides, ckpt)
    frames = [_reply(r) for r in port.client.predict_stream(
        pb.PredictOptions(prompt="stream me", max_tokens=10,
                          temperature=0.0))]
    jframes = [_reply(r) for r in jax.client.predict_stream(
        jpb.PredictOptions(prompt="stream me", max_tokens=10,
                           temperature=0.0))]
    assert frames == jframes
    # deltas, then one final frame with the counts
    assert frames[-1][0] == b"" and frames[-1][1] == 10
    assert all(f[3] == "" for f in frames[:-1])


def test_constrained_predict_equal(sides, ckpt):
    port, jax = _loaded(sides, ckpt)
    r = port.client.predict(pb.PredictOptions(
        prompt="digits:", max_tokens=8, temperature=0.0,
        constraint_regex="[0-9]{3,6}"))
    jr = jax.client.predict(jpb.PredictOptions(
        prompt="digits:", max_tokens=8, temperature=0.0,
        constraint_regex="[0-9]{3,6}"))
    assert _reply(r) == _reply(jr)
    assert r.message.decode().isdigit()


def test_embedding_and_tokenize_equal(sides, ckpt):
    port, jax = _loaded(sides, ckpt)
    vec = np.array(port.client.embedding(text="embed this"))
    jvec = np.array(jax.client.embedding(text="embed this"))
    np.testing.assert_allclose(vec, jvec, atol=1e-4, rtol=1e-4)
    toks = list(range(10, 30))
    np.testing.assert_allclose(np.array(port.client.embedding(tokens=toks)),
                               np.array(jax.client.embedding(tokens=toks)),
                               atol=1e-4, rtol=1e-4)
    for add_bos in (False, True):
        assert port.client.tokenize("héllo", add_bos=add_bos) == \
            jax.client.tokenize("héllo", add_bos=add_bos)


def test_metrics_and_telemetry_payloads(sides, ckpt):
    port, jax = _loaded(sides, ckpt)
    m, jm = port.client.metrics(), jax.client.metrics()
    assert "recent_traces" in m and "recent_traces" in jm
    assert set(jm) <= set(m) | {"recent_traces"}
    t, jt = port.client.get_telemetry(), jax.client.get_telemetry()
    assert set(t) == set(jt)
    none = port.client.get_telemetry(limit=0, recent=0)
    jnone = jax.client.get_telemetry(limit=0, recent=0)
    assert none["traces"] == jnone["traces"] == []


@pytest.mark.parametrize("call", ["tts", "transcribe", "generate_image",
                                  "rerank", "stores_find"])
def test_modality_calls_are_unimplemented_alike(sides, call):
    port, jax = sides[0]
    args = {"tts": (("hi",), {}), "transcribe": ((), {}),
            "generate_image": (("a fox",), {}),
            "rerank": (("q", ["d"]), {}), "stores_find": (([1.0], 1), {})}
    a, kw = args[call]
    with pytest.raises(rpc.RpcError) as e:
        getattr(port.client, call)(*a, **kw)
    with pytest.raises(grpc.RpcError) as je:
        getattr(jax.client, call)(*a, **kw)
    assert e.value.code().name == je.value.code().name == "UNIMPLEMENTED"
    assert e.value.details() == je.value.details()


def test_prefill_transfer_handoff_alike(sides, ckpt):
    """PrefillPrefix on one worker, TransferPrefix into the other, of each
    package; the decode worker resumes past the transferred rows and its
    text equals the prefill worker's own greedy text."""
    _loaded(sides, ckpt)
    prompt = list(b"a prompt long enough to cross the prefix minimum " * 2)
    out = {}
    for k, msgs in ((0, pb), (1, jpb)):
        src, dst = sides[0][k].client, sides[1][k].client
        opts = dict(tokens=prompt, max_tokens=6, temperature=0.0)
        chunks = list(src.prefill_prefix(msgs.PredictOptions(**opts)))
        res = dst.transfer_prefix(iter(chunks))
        text = b"".join(r.message for r in dst.predict_stream(
            msgs.PredictOptions(**opts)))
        ref = src.predict(msgs.PredictOptions(**opts)).message
        hits = dst.metrics()["prompt_cache"]
        out[k] = (res.success, res.message, text, ref,
                  hits["hits"] >= 1, len(chunks),
                  [c.tokens for c in chunks[:1]])
    assert out[0] == out[1]
    assert out[0][0] and out[0][2] == out[0][3] and out[0][4]


def test_transfer_refuses_a_broken_stream_alike(sides, ckpt):
    port, jax = _loaded(sides, ckpt)
    with pytest.raises(rpc.RpcError) as e:
        port.client.transfer_prefix(iter([pb.PrefixChunk(seq=1, data=b"x")]))
    with pytest.raises(grpc.RpcError) as je:
        jax.client.transfer_prefix(iter([jpb.PrefixChunk(seq=1, data=b"x")]))
    assert e.value.code().name == je.value.code().name == "INVALID_ARGUMENT"
    assert e.value.details() == je.value.details()


def _active(client) -> int:
    return len(client.metrics().get("active_slots") or [])


def test_dropped_stream_frees_its_slot(sides, ckpt):
    """A client that goes away mid-stream: the worker cancels the engine
    request, so no decode slot is held to max_tokens."""
    _loaded(sides, ckpt)
    for side, msgs in ((sides[0][0], pb), (sides[0][1], jpb)):
        stream = side.client.predict_stream(msgs.PredictOptions(
            prompt="run long", max_tokens=200, temperature=0.0,
            ignore_eos=True))
        next(stream)
        assert _active(side.client) == 1
        stream.close()
        deadline = time.monotonic() + 30
        while _active(side.client) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _active(side.client) == 0


def test_store_worker_calls_equal(monkeypatch):
    monkeypatch.setenv("LOCALAI_DEVICE", "cpu")
    results = []
    for mod, cls, err in ((server, WorkerClient, rpc.RpcError),
                          (jserver, JaxClient, grpc.RpcError)):
        side = _Side(mod, cls, None, mod.StoreServicer())
        c = side.client
        try:
            keys = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.7, 0.7, 0.0]]
            out = [c.stores_set(keys, [b"a", b"b", b"c"]).success]
            got = c.stores_get([keys[1], [9.0, 9.0, 9.0]])
            out.append(([list(k.floats) for k in got.keys],
                        [v.bytes for v in got.values]))
            found = c.stores_find([1.0, 0.1, 0.0], 2)
            out.append(([v.bytes for v in found.values],
                        np.round(list(found.similarities), 5).tolist()))
            out.append(c.stores_delete([keys[0]]).success)
            out.append([v.bytes for v in c.stores_find(
                [1.0, 0.1, 0.0], 3).values])
            with pytest.raises(err) as e:
                c.stores_set([[1.0, 2.0]], [b"bad width"])
            out.append(e.value.code().name)
        finally:
            side.close()
        results.append(out)
    assert results[0] == results[1]


def test_worker_pool_spawn_and_respawn(ckpt):
    """A real port worker process: spawn, load, predict, kill -9, and the
    next ``get`` respawns a fresh one that answers the same text."""
    pool = WorkerPool()
    env = {"LOCALAI_DEVICE": "cpu"}
    try:
        client = pool.get("w1", env=env)
        assert client.health()
        assert client.load_model(config_yaml=_yaml(ckpt)).success
        opts = pb.PredictOptions(prompt="x", max_tokens=4, temperature=0.0)
        first = client.predict(opts)
        assert first.tokens == 4
        proc = pool.process("w1").proc
        proc.kill()
        proc.wait(10)
        client2 = pool.get("w1", env=env)
        assert client2 is not client and client2.health()
        assert pool.process("w1").proc.pid != proc.pid
        assert client2.load_model(config_yaml=_yaml(ckpt)).success
        assert _reply(client2.predict(opts)) == _reply(first)
        # an orderly stop reports the worker's kernel launch counts
        wp = pool.process("w1")
        wp.stop()
        rep = wp.launch_report
        assert rep["launches"]["paged_decode_attention"] == 0   # CPU
        assert rep["decode_steps"] > 0 and rep["embeddings"] == 0
    finally:
        pool.shutdown_all()
    assert pool.names() == []


def test_watchdog_kills_idle():
    wd = Watchdog(busy_timeout=0, idle_timeout=0.2, interval=0.05)
    killed = []
    wd.register("addr:1", lambda: killed.append("addr:1"))
    wd.start()
    try:
        time.sleep(0.8)
        assert killed == ["addr:1"]
    finally:
        wd.stop()


def test_watchdog_busy_timeout():
    wd = Watchdog(busy_timeout=0.2, idle_timeout=0, interval=0.05)
    killed = []
    wd.register("addr:2", lambda: killed.append("addr:2"))
    wd.mark("addr:2")  # a call in flight that never completes
    wd.start()
    try:
        time.sleep(0.8)
        assert killed == ["addr:2"]
    finally:
        wd.stop()


def test_deadline_and_unreachable_peer_statuses():
    """A call past its deadline is DEADLINE_EXCEEDED; a peer that is not
    listening is UNAVAILABLE (health() reads both as False)."""
    import socket

    quiet = socket.socket()
    quiet.bind(("127.0.0.1", 0))
    quiet.listen(1)        # accepts the connection, never answers
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))    # bound, never listening: refused
    try:
        c = WorkerClient(f"127.0.0.1:{quiet.getsockname()[1]}")
        with pytest.raises(rpc.RpcError) as e:
            c.status(timeout=0.3)
        assert e.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
        assert not c.health(timeout=0.3)
        d = WorkerClient(f"127.0.0.1:{dead.getsockname()[1]}")
        with pytest.raises(rpc.RpcError) as e:
            d.status()
        assert e.value.code() == rpc.StatusCode.UNAVAILABLE
        assert not d.health()
    finally:
        quiet.close()
        dead.close()
