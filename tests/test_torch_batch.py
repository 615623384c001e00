"""The batch lane of the PyTorch port against the JAX package, on the CPU.

Mirrors ``tests/test_batch.py`` case for case where a case applies to the
port (the assistants store that shares the registry in the JAX package
waits for ROADMAP item 22):

  * the file registry and the job store: transitions, refusals, reload
    (a directory written by either package read by the other), the
    done-set, expiry under a fake clock;
  * line validation: every refusal of the JAX package's ``parse_line``
    with the same ``custom_id`` and, except where the JAX message is
    pydantic's own wording (``PYDANTIC_WORDED``), the same message;
  * executor runs of valid, invalid, duplicate and deadline lines, each
    job's records compared record by record with the JAX executor's
    (custom_id, status_code, error.code, order; the greedy texts of the
    completed lines byte for byte), crash resume, cancel and the pause
    under SLO shedding;
  * the scheduler's two admission lanes;
  * both HTTP servers on ``/v1/files``, ``/v1/batches`` and
    ``/debug/faults``.

Both executors drain through a paged engine of ``debug:tiny`` in float32
(the JAX package's weights carried across with
``models.llama.params_from_numpy``); every wait is bounded (at most 60 s).
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("aiohttp")

import jax  # noqa: E402

from localai_tpu import faults as jfaults  # noqa: E402
from localai_tpu.batch.executor import BatchExecutor as JaxExecutor  # noqa: E402
from localai_tpu.batch.executor import parse_line as jax_parse_line  # noqa: E402
from localai_tpu.batch.store import BatchStore as JaxBatchStore  # noqa: E402
from localai_tpu.batch.store import FileRegistry as JaxFileRegistry  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.engine.scheduler import Scheduler as JaxScheduler  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu.obs import metrics as jmetrics  # noqa: E402
from localai_tpu.obs.slo import SLOTracker as JaxSLO  # noqa: E402
from localai_tpu.obs.trace import TraceStore as JaxStore  # noqa: E402
from localai_tpu.templates.cache import TemplateCache as JaxTemplates  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from localai_tpu_torch import faults  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.batch.executor import (  # noqa: E402
    BatchExecutor,
    LineError,
    parse_line,
)
from localai_tpu_torch.batch.store import BatchStore, FileRegistry  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import (  # noqa: E402
    PRIORITY_BATCH,
    GenHandle,
    GenRequest,
    Scheduler,
)
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from localai_tpu_torch.obs.engine import EngineTelemetry  # noqa: E402
from localai_tpu_torch.obs.slo import SLOTracker  # noqa: E402
from localai_tpu_torch.obs.trace import TraceStore  # noqa: E402
from localai_tpu_torch.templates.cache import TemplateCache  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_api import _ServerThread, make_state  # noqa: E402
from test_torch_llama import (  # noqa: E402
    one_torch_thread,  # noqa: F401 — autouse fixture
    write_hf_checkpoint,
)

RUNNER_KW = dict(num_slots=4, max_ctx=96, prefill_buckets=[16, 32],
                 kv_dtype="float32", paged=True, kv_block_tokens=16,
                 prefill_chunk=32)
WAIT = 60.0
CHAT = "/v1/chat/completions"
COMPLETIONS = "/v1/completions"
# input lines whose JAX refusal message is pydantic's own wording: the
# port refuses them on the same line with the same custom_id and code, in
# its own words (ROADMAP §C, intended divergence)
PYDANTIC_WORDED = {"bad-temperature", "bad-max-tokens", "bad-messages",
                   "bad-stop", "bad-stream", "bad-role"}


@pytest.fixture(scope="module")
def scheds():
    """A paged debug:tiny engine of each package, the same weights."""
    cfg_j = dataclasses.replace(J_PRESETS["tiny"], dtype="float32")
    params_j = jl.init_params(jax.random.key(0), cfg_j)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    cfg_t, device="cpu")
    port = Scheduler(ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW),
                     ByteTokenizer())
    ref = JaxScheduler(JaxRunner(cfg_j, params_j, attn_impl="xla",
                                 **RUNNER_KW), JaxByteTokenizer())
    yield {"port": port, "jax": ref}
    port.shutdown()
    ref.shutdown()


@pytest.fixture()
def upload_dir(tmp_path):
    d = tmp_path / "uploads"
    d.mkdir()
    return d


PKG = {
    "port": dict(Files=FileRegistry, Store=BatchStore, Executor=BatchExecutor,
                 Reg=tmetrics.Registry, SLO=SLOTracker, Traces=TraceStore,
                 Config=ModelConfig, Templates=TemplateCache,
                 Tok=ByteTokenizer),
    "jax": dict(Files=JaxFileRegistry, Store=JaxBatchStore,
                Executor=JaxExecutor, Reg=jmetrics.Registry, SLO=JaxSLO,
                Traces=JaxStore, Config=JaxModelConfig,
                Templates=JaxTemplates, Tok=JaxByteTokenizer),
}


def make_serving(pkg, sched, tmp_path):
    """The (serving model, model config) pair each executor resolves per
    model name."""
    P = PKG[pkg]
    mcfg = P["Config"](name="tiny")
    sm = SimpleNamespace(name="tiny", config=mcfg, tokenizer=P["Tok"](),
                         scheduler=sched, vision=None,
                         templates=P["Templates"](str(tmp_path)))
    return lambda name: (sm, mcfg)


def body(i, endpoint=CHAT, max_tokens=4, model="tiny"):
    if endpoint == CHAT:
        return {"model": model, "max_tokens": max_tokens, "temperature": 0.0,
                "messages": [{"role": "user", "content": f"line {i}"}]}
    return {"model": model, "max_tokens": max_tokens, "temperature": 0.0,
            "prompt": f"line {i}"}


def jsonl(n=5, endpoint=CHAT, max_tokens=4, extra_lines=(),
          model="tiny") -> bytes:
    lines = [json.dumps({"custom_id": f"req-{i}", "method": "POST",
                         "url": endpoint,
                         "body": body(i, endpoint, max_tokens, model)})
             for i in range(n)]
    lines.extend(extra_lines)
    return ("\n".join(lines) + "\n").encode()


def wait_for(pred, timeout=WAIT, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def run_executor(pkg, store, sched, tmp_path, **kw):
    P = PKG[pkg]
    ex = P["Executor"](
        store, make_serving(pkg, sched, tmp_path), poll_s=0.02,
        registry=kw.pop("registry", P["Reg"]()),
        slo=kw.pop("slo", P["SLO"](registry=P["Reg"](), targets={})),
        trace_store=kw.pop("trace_store", P["Traces"]()), **kw)
    ex.start()
    return ex


def run_job(pkg, scheds, root, content: bytes, endpoint=CHAT,
            status="completed", **kw) -> tuple:
    """One job of ``content`` on ``pkg``'s executor, to ``status``:
    (store, job, output records, error records)."""
    P = PKG[pkg]
    d = root / pkg
    d.mkdir(parents=True, exist_ok=True)
    reg = P["Files"](d)
    store = P["Store"](d, reg)
    f = reg.register_bytes("input.jsonl", content, "batch")
    job = store.create(endpoint=endpoint, input_file_id=f["id"])
    ex = run_executor(pkg, store, scheds[pkg], root, **kw)
    try:
        assert wait_for(lambda: store.get(job["id"])["status"] == status)
    finally:
        ex.stop()
    job = store.get(job["id"])
    return store, job, _records(store.output_path(job)), \
        _records(store.error_path(job))


def _records(path) -> list:
    try:
        return [json.loads(x) for x in path.read_text().splitlines()]
    except FileNotFoundError:
        return []


def _shape(rec: dict) -> dict:
    """A record without its fresh ids and timestamps."""
    resp = dict(rec["response"])
    resp.pop("request_id", None)
    if resp.get("status_code") == 200:
        b = dict(resp["body"])
        b.pop("id")
        b.pop("created")
        resp["body"] = b
    return {"custom_id": rec["custom_id"], "response": resp,
            "error": rec["error"], "synthetic_id": rec.get("synthetic_id")}


def _error_key(rec: dict) -> tuple:
    return (rec["custom_id"], rec["response"]["status_code"],
            rec["error"]["code"], rec.get("synthetic_id", False))


# ---------------------------------------------------------------------------
# FileRegistry (the /v1/files store)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_file_registry_purpose_and_roundtrip(pkg, upload_dir):
    reg = PKG[pkg]["Files"](upload_dir)
    f = reg.register_bytes("a.jsonl", b"hello", "batch")
    g = reg.register_bytes("b.txt", b"notes", "assistants")
    assert f["purpose"] == "batch" and f["bytes"] == 5
    assert {x["id"] for x in reg.list()} == {f["id"], g["id"]}
    assert [x["id"] for x in reg.list("batch")] == [f["id"]]
    assert reg.content_path(f["id"]).read_bytes() == b"hello"
    # duplicate filename refused; traversal-guarded basename only
    with pytest.raises(ValueError):
        reg.register_bytes("a.jsonl", b"x", "batch")
    evil = reg.register_bytes("../../evil.txt", b"x", "batch")
    assert evil["filename"] == "evil.txt"
    assert reg.delete(f["id"]) is True
    assert reg.get(f["id"]) is None
    assert not (upload_dir / "a.jsonl").exists()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_file_registry_ids_survive_reload(upload_dir, writer, reader):
    """A registry written by either package reloads in the other with its
    ids, and new ids continue past the persisted ones."""
    reg = PKG[writer]["Files"](upload_dir)
    f1 = reg.register_bytes("one.txt", b"1", "assistants")
    reg2 = PKG[reader]["Files"](upload_dir)
    f2 = reg2.register_bytes("two.txt", b"2", "assistants")
    assert f2["id"] != f1["id"]
    assert reg2.get(f1["id"]) == f1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_file_registry_rejects_reserved_names(pkg, upload_dir):
    reg = PKG[pkg]["Files"](upload_dir)
    with pytest.raises(ValueError, match="reserved"):
        reg.register_bytes("uploadedFiles.json", b"[]", "batch")
    with pytest.raises(ValueError, match="reserved"):
        reg.register_bytes("batch_jobs", b"x", "batch")


# ---------------------------------------------------------------------------
# BatchStore state machine + durability


def _transitions(pkg, upload_dir) -> list:
    P = PKG[pkg]
    store = P["Store"](upload_dir / pkg, P["Files"](upload_dir / pkg))
    job = store.create(endpoint=CHAT, input_file_id="file-1")
    out = [job["status"]]
    for to in ("completed", "in_progress", "completed", "in_progress",
               "cancelled"):
        try:
            out.append(store.transition(job["id"], to)["status"])
        except ValueError as e:
            out.append(str(e))
    j = store.get(job["id"])
    out.append([k for k in j if k.endswith("_at") and j[k] is not None])
    out.append(store.cancel(job["id"])["status"])
    out.append(store.cancel("batch_999"))
    try:
        store.transition("batch_999", "failed")
    except ValueError as e:
        out.append(str(e))
    return out


def test_batch_store_transitions_alike(upload_dir):
    got = _transitions("port", upload_dir)
    assert got == _transitions("jax", upload_dir)
    assert got[:4] == ["validating",
                       "illegal batch transition 'validating' → 'completed'",
                       "in_progress", "completed"]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_batch_store_reload_and_done_set(upload_dir, writer, reader):
    W, R = PKG[writer], PKG[reader]
    store = W["Store"](upload_dir, W["Files"](upload_dir))
    job = store.create(endpoint=COMPLETIONS, input_file_id="file-1")
    store.transition(job["id"], "in_progress")
    store.append_line(store.output_path(job),
                      {"custom_id": "req-0", "response": {}})
    store.append_line(store.error_path(job),
                      {"custom_id": "req-1", "error": {}})
    store.append_line(store.error_path(job),
                      {"custom_id": "line-3", "synthetic_id": True})
    store2 = R["Store"](upload_dir, R["Files"](upload_dir))
    j2 = store2.get(job["id"])
    assert j2["status"] == "in_progress"
    assert store2.done_custom_ids(j2) == {"req-0", "req-1", "line-3"}
    assert store2.done_custom_ids(j2, include_synthetic=False) == \
        {"req-0", "req-1"}
    j3 = store2.create(endpoint=COMPLETIONS, input_file_id="file-1")
    assert j3["id"] != job["id"]  # id counter continues past persisted


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_batch_store_expiry(pkg, upload_dir):
    P = PKG[pkg]
    store = P["Store"](upload_dir, P["Files"](upload_dir), expiry_h=1.0)
    job = store.create(endpoint=COMPLETIONS, input_file_id="f")
    now = job["created_at"]                  # a fake clock, in seconds
    assert store.expire_due(now=now + 3599) == []
    expired = store.expire_due(now=now + 3700)
    assert [j["id"] for j in expired] == [job["id"]]
    assert store.get(job["id"])["status"] == "expired"
    assert store.get(job["id"])["expired_at"] is not None
    assert store.runnable() is None


def test_batch_jobs_gauge_alike(upload_dir):
    port, ref = tmetrics.Registry(), jmetrics.Registry()
    for pkg, reg in (("port", port), ("jax", ref)):
        P = PKG[pkg]
        store = P["Store"](upload_dir / pkg, P["Files"](upload_dir / pkg))
        a = store.create(endpoint=CHAT, input_file_id="f")
        store.create(endpoint=CHAT, input_file_id="f")
        store.transition(a["id"], "in_progress")
        store.export_gauges(reg)
    assert port.batch_jobs.render() == ref.batch_jobs.render()


# ---------------------------------------------------------------------------
# line validation

LINES = [
    ("not json", None),
    (json.dumps(["list"]), None),
    (json.dumps({"body": {}}), None),
    (json.dumps({"custom_id": "a", "body": {}}), None),          # duplicate
    (json.dumps({"custom_id": "get", "method": "GET", "body": {}}), None),
    (json.dumps({"custom_id": "url", "url": "/v1/nope", "body": {}}), None),
    (json.dumps({"custom_id": "body", "url": COMPLETIONS, "body": []}),
     None),
    (json.dumps({"custom_id": "list-prompt", "url": COMPLETIONS,
                 "body": {"prompt": ["a", "b"]}}), None),
    (json.dumps({"custom_id": "bad-temperature",
                 "body": {"prompt": "x", "temperature": "hot"}}), None),
    (json.dumps({"custom_id": "bad-max-tokens",
                 "body": {"prompt": "x", "max_tokens": 4.5}}), None),
    (json.dumps({"custom_id": "bad-messages",
                 "body": {"messages": "hi"}}), None),
    (json.dumps({"custom_id": "bad-stop", "body": {"stop": ["a", 1]}}),
     None),
    (json.dumps({"custom_id": "bad-stream", "body": {"stream": "maybe"}}),
     None),
    (json.dumps({"custom_id": "bad-role",
                 "body": {"messages": [{"role": 5}]}}), None),
    # lax coercions both accept
    (json.dumps({"custom_id": "lax", "body": {
        "prompt": "x", "temperature": "0.5", "max_tokens": "4",
        "stream": "yes", "n": 2.0, "ignore_eos": 1}}), "ok"),
    (json.dumps({"custom_id": "ok", "url": COMPLETIONS,
                 "body": {"model": "m", "prompt": "x"}}), "ok"),
]


def _parse_all(parse) -> list:
    seen = {"a"}
    out = []
    for raw, _ in LINES:
        try:
            cid, req, b = parse(raw, 2, COMPLETIONS, seen)
            out.append(("ok", cid, req.model, req.stream, b))
        except ValueError as e:
            out.append(("error", getattr(e, "custom_id", ""), str(e)))
    return out


def test_parse_line_refuses_as_the_jax_package():
    got, want = _parse_all(parse_line), _parse_all(jax_parse_line)
    assert len(got) == len(want) == len(LINES)
    for (raw, expect), g, w in zip(LINES, got, want):
        assert g[:2] == w[:2], raw
        if expect == "ok":
            assert g == w, raw
        elif g[1] in PYDANTIC_WORDED:
            # same line, same id; the message names the field in words of
            # the port's own
            assert g[2].startswith("line 2: invalid request: ")
            assert w[2].startswith("line 2: invalid request: ")
        else:
            assert g == w, raw
    assert {g[1] for g in got if g[0] == "error"} >= PYDANTIC_WORDED
    with pytest.raises(LineError, match="duplicate"):
        parse_line(LINES[3][0], 2, COMPLETIONS, {"a"})


FIELDS = ("temperature", "top_p", "top_k", "max_tokens", "n", "seed",
          "stream", "echo", "ignore_eos", "model", "user", "instruction",
          "prompt", "stop", "logit_bias", "tool_choice", "response_format",
          "tools", "functions", "input", "grammar", "mode", "step",
          "messages")
VALUES = (None, True, False, 0, 1, 2, -1, 4.0, 4.5, "4", "4.0", "x", "yes",
          "maybe", " 1", "", [], ["a"], ["a", 1], [{}], {}, {"1": "2"},
          {"1": "x"}, float("nan"), float("inf"), 1e20,
          [{"role": 5}], [{"content": 5}], [{"role": "user",
                                              "content": "hi"}],
          # numeric and boolean words at the edges of pydantic's lax mode
          "4.00", "4.", ".5", "1e3", "1E3", " 4 ", "\t4\n", "1_000", "1__0",
          "+5", "-0.0", "inf", "NaN", "Infinity", "0x10", "\u0663", "tRuE",
          "off", "F", "false", "no", 1.0, 0.0, -0.0, 2.0, 2 ** 63,
          {"7": True}, {"7": "1e4"}, {"7": None})
# the fields whose value the schema coerces (numbers, booleans, the bias)
COERCED = ("temperature", "top_p", "top_k", "max_tokens", "n", "seed",
           "stream", "echo", "ignore_eos", "mode", "step", "logit_bias")


def _same(a, b) -> bool:
    """Equal values of one type (NaN equal to NaN)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("field", FIELDS)
def test_field_checks_refuse_what_the_schema_refuses(field):
    """``api.openai.request_body``, the one validator of the port's routes
    and batch lines, refuses a body exactly when the JAX package's
    pydantic schema does, field by field over a grid of values (numbers,
    numeric and boolean words, lists, objects, NaN, inf); where both
    accept, a coerced field holds pydantic's value of pydantic's type."""
    from localai_tpu.api.schema import OpenAIRequest

    from localai_tpu_torch.api.openai import APIError, request_body

    for value in VALUES:
        body = {field: value}
        try:
            want = getattr(OpenAIRequest.model_validate(body), field)
        except ValueError:
            want = refused = True
        else:
            refused = False
        try:
            got = request_body(body)[field]
        except APIError as e:
            assert refused, (field, value, e.message)
            assert e.status == 400
            assert e.message.startswith(f"invalid request: {field}: ")
            continue
        assert not refused, (field, value)
        if field in COERCED:
            assert _same(got, want), (field, value, got, want)


# ---------------------------------------------------------------------------
# executor end to end, record by record against the JAX executor


def test_batch_job_runs_to_completed(scheds, tmp_path):
    metrics = {"port": tmetrics.Registry(), "jax": jmetrics.Registry()}
    traces = {"port": TraceStore(), "jax": JaxStore()}
    got = {pkg: run_job(pkg, scheds, tmp_path, jsonl(5),
                        registry=metrics[pkg], trace_store=traces[pkg])
           for pkg in ("port", "jax")}
    for pkg, (store, job, outs, errs) in got.items():
        assert job["request_counts"] == {"total": 5, "completed": 5,
                                         "failed": 0}
        assert store.registry.get(job["output_file_id"])["purpose"] == \
            "batch_output"
        assert errs == []
        text = metrics[pkg].render()
        assert 'localai_batch_lines_total{result="completed"} 5' in text
        assert 'localai_batch_jobs{state="completed"} 1' in text
        assert "localai_batch_lane_paused 0" in text
        tr = traces[pkg].recent(limit=10, kind="batch")
        assert tr and tr[0].attrs["status"] == "completed"
        assert {s.name for s in tr[0].spans()} >= {"validate", "run"}
    port, ref = got["port"][2], got["jax"][2]
    by_id = lambda recs: sorted((_shape(r) for r in recs),  # noqa: E731
                                key=lambda r: r["custom_id"])
    # every completed line's body (texts, finish reasons, usage) equal
    assert by_id(port) == by_id(ref)
    assert all(r["response"]["body"]["object"] == "chat.completion"
               for r in port)


def test_completions_job_matches_the_jax_executor(scheds, tmp_path):
    got = {pkg: run_job(pkg, scheds, tmp_path,
                        jsonl(3, COMPLETIONS, max_tokens=6), COMPLETIONS)
           for pkg in ("port", "jax")}
    key = lambda recs: sorted((_shape(r) for r in recs),  # noqa: E731
                              key=lambda r: r["custom_id"])
    assert key(got["port"][2]) == key(got["jax"][2])
    assert got["port"][2][0]["response"]["body"]["object"] == \
        "text_completion"


EOS = ByteTokenizer.EOS
# lines whose numbers and booleans come in pydantic's lax forms, and the
# canonical twin of the first: each runs with its coerced settings
LAX = [
    ("lax-strings", {"max_tokens": "4", "temperature": "0.0", "seed": "7",
                     "top_k": "1", "n": 1.0, "ignore_eos": "false"}),
    ("canonical", {"max_tokens": 4, "temperature": 0.0, "seed": 7,
                   "top_k": 1, "n": 1, "ignore_eos": False}),
    ("lax-eos-kept", {"max_tokens": 4.0, "temperature": "0",
                      "ignore_eos": "no", "logit_bias": {str(EOS): "1e4"}}),
    ("lax-eos-ignored", {"max_tokens": "4.00", "temperature": False,
                         "ignore_eos": "yes",
                         "logit_bias": {str(EOS): "1e4"}}),
]


def test_lax_lines_run_as_the_jax_executor_runs_them(scheds, tmp_path):
    """Lax-typed lines run with their coerced settings on both executors,
    record by record equal: a string ``max_tokens`` or ``temperature``
    does not fail in the engine, and ``"ignore_eos": "no"`` keeps the EOS
    stop that ``"yes"`` lifts."""
    lines = [json.dumps({"custom_id": cid, "method": "POST", "url": CHAT,
                         "body": {"model": "tiny", **extra, "messages": [
                             {"role": "user", "content": "lax"}]}})
             for cid, extra in LAX]
    got = {pkg: run_job(pkg, scheds, tmp_path,
                        ("\n".join(lines) + "\n").encode())
           for pkg in ("port", "jax")}
    by_id = {}
    for pkg, (_, job, outs, errs) in got.items():
        assert errs == [], (pkg, errs)
        assert job["request_counts"] == {"total": 4, "completed": 4,
                                         "failed": 0}
        by_id[pkg] = {r["custom_id"]: _shape(r) for r in outs}
    assert by_id["port"] == by_id["jax"]
    recs = {cid: r["response"]["body"] for cid, r in by_id["port"].items()}
    assert recs["lax-strings"]["choices"] == recs["canonical"]["choices"]
    assert recs["lax-strings"]["usage"]["completion_tokens"] == 4
    kept = recs["lax-eos-kept"]
    assert kept["choices"][0]["finish_reason"] == "stop"
    assert kept["usage"]["completion_tokens"] < 4
    ignored = recs["lax-eos-ignored"]
    assert ignored["usage"]["completion_tokens"] == 4
    assert ignored["choices"][0]["finish_reason"] == "length"


INVALID = [
    "not json at all",
    json.dumps({"method": "POST", "url": COMPLETIONS,
                "body": {"prompt": "no custom id"}}),
    json.dumps({"custom_id": "wrong-url", "method": "POST", "url": CHAT,
                "body": {"prompt": "mismatched endpoint"}}),
    json.dumps({"custom_id": "bad-temperature", "url": COMPLETIONS,
                "body": {"model": "tiny", "prompt": "x",
                         "temperature": "hot"}}),
    json.dumps({"custom_id": "req-0", "url": COMPLETIONS,
                "body": {"prompt": "duplicate id"}}),
]


def test_batch_invalid_lines_become_error_records(scheds, tmp_path):
    got = {pkg: run_job(pkg, scheds, tmp_path,
                        jsonl(2, COMPLETIONS, extra_lines=INVALID),
                        COMPLETIONS) for pkg in ("port", "jax")}
    for pkg, (store, job, outs, errs) in got.items():
        assert job["request_counts"] == {"total": 7, "completed": 2,
                                         "failed": 5}
        assert all(e["error"]["code"] == "400" for e in errs)
        assert "wrong-url" in {e["custom_id"] for e in errs}
        assert store.registry.get(job["error_file_id"])["purpose"] == \
            "batch_output"
        # the valid req-0 line really ran (exactly once)
        assert sorted(r["custom_id"] for r in outs) == ["req-0", "req-1"]
    port, ref = got["port"][3], got["jax"][3]
    # the same records in the same order: custom_id, status, code
    assert [_error_key(r) for r in port] == [_error_key(r) for r in ref]
    for a, b in zip(port, ref):
        if a["custom_id"] not in PYDANTIC_WORDED:
            assert a["error"]["message"] == b["error"]["message"]
            assert a["response"]["body"] == b["response"]["body"]


def test_batch_all_invalid_fails(scheds, tmp_path):
    for pkg in ("port", "jax"):
        _, job, outs, errs = run_job(pkg, scheds, tmp_path,
                                     b"nope\nstill nope\n", COMPLETIONS,
                                     status="failed")
        assert job["request_counts"]["failed"] == 2 and outs == []
        assert [e["custom_id"] for e in errs] == ["line-1", "line-2"]


def test_synthetic_error_id_does_not_shadow_real_custom_id(scheds,
                                                           tmp_path):
    content = "\n".join([
        "",                # physical line 1: blank
        "not json",        # physical line 2: invalid → synthetic line-2
        json.dumps({"custom_id": "line-2", "method": "POST",
                    "url": COMPLETIONS,
                    "body": {"model": "tiny", "max_tokens": 4,
                             "temperature": 0.0, "prompt": "really run"}}),
    ]) + "\n"
    got = {pkg: run_job(pkg, scheds, tmp_path, content.encode(),
                        COMPLETIONS) for pkg in ("port", "jax")}
    for pkg, (_, job, outs, errs) in got.items():
        assert job["request_counts"] == {"total": 2, "completed": 1,
                                         "failed": 1}
        assert [r["custom_id"] for r in outs] == ["line-2"]
        assert errs[0]["custom_id"] == "line-2"
        assert errs[0]["synthetic_id"] is True
    assert _shape(got["port"][2][0]) == _shape(got["jax"][2][0])


def test_batch_line_deadline_records_timeout(scheds, tmp_path):
    line = json.dumps({
        "custom_id": "slow", "method": "POST", "url": CHAT,
        "body": {"model": "tiny", "max_tokens": 2048, "temperature": 0.0,
                 "ignore_eos": True,
                 "messages": [{"role": "user", "content": "decode on"}]}})
    got = {pkg: run_job(pkg, scheds, tmp_path, (line + "\n").encode(),
                        deadline_s=0.01) for pkg in ("port", "jax")}
    for pkg, (_, job, outs, errs) in got.items():
        assert job["request_counts"] == {"total": 1, "completed": 0,
                                         "failed": 1}
        assert [_error_key(e) for e in errs] == [("slow", 504, "504",
                                                  False)]
        assert wait_for(lambda: not scheds[pkg].busy)  # slot freed
    assert got["port"][3][0]["error"] == got["jax"][3][0]["error"]


def test_batch_crash_resume_continues_from_durable_lines(scheds, upload_dir,
                                                         tmp_path):
    """Kill mid-job (a job written by the JAX package's store), reload in
    the port: lines already in the output file are not re-run, the rest
    complete, and no custom_id appears twice."""
    reg = JaxFileRegistry(upload_dir)
    store = JaxBatchStore(upload_dir, reg)
    f = reg.register_bytes("input.jsonl", jsonl(5), "batch")
    job = store.create(endpoint=CHAT, input_file_id=f["id"])
    store.transition(job["id"], "in_progress")
    for i in range(2):
        store.append_line(store.output_path(job), {
            "id": f"pre-crash-{i}", "custom_id": f"req-{i}",
            "response": {"status_code": 200, "body": {}}, "error": None})
    store2 = BatchStore(upload_dir, FileRegistry(upload_dir))
    assert store2.get(job["id"])["status"] == "in_progress"
    ex = run_executor("port", store2, scheds["port"], tmp_path)
    try:
        assert wait_for(
            lambda: store2.get(job["id"])["status"] == "completed")
    finally:
        ex.stop()
    job = store2.get(job["id"])
    records = _records(store2.output_path(job))
    cids = [r["custom_id"] for r in records]
    assert sorted(cids) == [f"req-{i}" for i in range(5)]
    assert len(set(cids)) == 5
    assert [r["id"] for r in records[:2]] == ["pre-crash-0", "pre-crash-1"]
    assert job["request_counts"]["completed"] == 5


def test_batch_cancel_stops_job(scheds, upload_dir, tmp_path):
    reg = FileRegistry(upload_dir)
    store = BatchStore(upload_dir, reg)
    f = reg.register_bytes("input.jsonl", jsonl(50, max_tokens=64), "batch")
    job = store.create(endpoint=CHAT, input_file_id=f["id"])
    ex = run_executor("port", store, scheds["port"], tmp_path,
                      concurrency=1)
    try:
        assert wait_for(
            lambda: store.get(job["id"])["status"] == "in_progress")
        store.cancel(job["id"])
        assert wait_for(lambda: not ex.store.runnable())
    finally:
        ex.stop()
    job = store.get(job["id"])
    assert job["status"] == "cancelled" and job["cancelled_at"] is not None
    done = len(store.done_custom_ids(job))
    time.sleep(0.3)
    assert len(store.done_custom_ids(job)) == done
    assert wait_for(lambda: not scheds["port"].busy)


def test_upload_cannot_poison_batch_output(scheds, upload_dir, tmp_path):
    reg = FileRegistry(upload_dir)
    store = BatchStore(upload_dir, reg)
    forged = "\n".join(json.dumps({"custom_id": f"req-{i}",
                                   "response": {"status_code": 200,
                                                "body": {"forged": True}}})
                       for i in range(3))
    reg.register_bytes("batch_1_output.jsonl", forged.encode(), "batch")
    f = reg.register_bytes("input.jsonl", jsonl(3), "batch")
    job = store.create(endpoint=CHAT, input_file_id=f["id"])
    assert job["id"] == "batch_1"
    ex = run_executor("port", store, scheds["port"], tmp_path)
    try:
        assert wait_for(
            lambda: store.get(job["id"])["status"] == "completed")
    finally:
        ex.stop()
    job = store.get(job["id"])
    assert job["request_counts"]["completed"] == 3
    recs = _records(reg.content_path(job["output_file_id"]))
    assert all("forged" not in r["response"]["body"] for r in recs)


def test_batch_lane_pauses_under_shedding_and_recovers(scheds, upload_dir,
                                                       tmp_path):
    """While the SLO observatory sheds the model the lane pauses entirely
    (gauge 1, in-flight lines requeued, never failed); once the fast
    window slides past the burst (a fake clock) the job completes."""
    reg = FileRegistry(upload_dir)
    store = BatchStore(upload_dir, reg)
    f = reg.register_bytes("input.jsonl", jsonl(4), "batch")
    job = store.create(endpoint=CHAT, input_file_id=f["id"])
    t = {"now": 1000.0}
    slo = SLOTracker(registry=tmetrics.Registry(), clock=lambda: t["now"],
                     targets={"ttft_ms": 0.001}, burn_threshold=1.0,
                     recover_burn=1.0, min_events=3)
    for _ in range(4):  # trip shedding for the job's model
        slo.observe("tiny", ttft_ms=50.0, e2e_ms=80.0)
    assert slo.shedding("tiny")
    metrics = tmetrics.Registry()
    ex = run_executor("port", store, scheds["port"], tmp_path, slo=slo,
                      registry=metrics)
    try:
        assert wait_for(lambda: ex.paused, timeout=30)
        assert "localai_batch_lane_paused 1" in metrics.render()
        n_before = len(store.done_custom_ids(store.get(job["id"])))
        time.sleep(0.3)
        assert len(store.done_custom_ids(store.get(job["id"]))) == n_before
        assert store.get(job["id"])["status"] == "in_progress"
        t["now"] += 120.0
        assert wait_for(
            lambda: store.get(job["id"])["status"] == "completed")
    finally:
        ex.stop()
    job = store.get(job["id"])
    assert job["request_counts"] == {"total": 4, "completed": 4,
                                     "failed": 0}
    text = metrics.render()
    assert "localai_batch_lane_paused 0" in text
    assert 'localai_batch_lines_total{result="completed"} 4' in text


# ---------------------------------------------------------------------------
# SLO isolation and the two admission lanes


def test_background_requests_never_become_slo_events():
    """A batch-lane completion is no SLO event and lands in neither the
    TTFT/TPOT nor the queue-wait histogram; it still counts as a finished
    request. An interactive completion feeds both."""
    reg = tmetrics.Registry()
    tracker = SLOTracker(registry=reg, targets={"ttft_ms": 1.0})
    tel = EngineTelemetry(model="m", registry=reg, store=TraceStore(),
                          slo=tracker)

    def finish_one(priority):
        h = GenHandle(GenRequest(prompt=[1, 2], priority=priority), 0)
        tr = tel.queued(h)
        tel.admitted(tr, slot=0, queue_wait=99.0, background=priority > 0)
        tel.prefill_done(tr)
        h._emit("x", 5)
        h._emit("y", 6)
        tel.finished(tr, h, "stop")
        h._finish("stop")

    finish_one(PRIORITY_BATCH)
    assert tracker.windows("m")["1m"]["count"] == 0
    text = reg.render()
    assert 'localai_ttft_seconds_count{model="m"}' not in text
    assert 'localai_queue_wait_seconds_count{model="m"}' not in text
    assert 'localai_requests_total{finish_reason="stop",model="m"} 1' \
        in text
    finish_one(0)
    assert tracker.windows("m")["1m"]["count"] == 1
    text = reg.render()
    assert 'localai_ttft_seconds_count{model="m"} 1' in text
    assert 'localai_queue_wait_seconds_count{model="m"} 1' in text


def test_interactive_lane_is_admitted_before_the_batch_lane(scheds):
    """Two-lane admission: the interactive lane drains strictly first
    (a batch request is handed out only when no interactive one waits),
    a held batch request goes back to its own lane, the metrics count the
    batch lane's queue; on the live engine every request of both lanes
    completes and batch requests run after the interactive ones queued
    with them."""
    stopped = Scheduler(scheds["port"].runner, ByteTokenizer())
    stopped.shutdown()                 # no engine thread pops the lanes
    order = [("b0", PRIORITY_BATCH), ("i0", 0), ("b1", PRIORITY_BATCH),
             ("i1", 0)]
    handles = {name: stopped.submit(GenRequest(prompt=[1], priority=p))
               for name, p in order}
    m = stopped.metrics()
    assert (m["queue_depth"], m["batch_queue_depth"]) == (2, 2)
    popped = [stopped._next_pending() for _ in range(3)]
    assert popped == [handles["i0"], handles["i1"], handles["b0"]]
    stopped._hold(handles["b0"])       # back to its lane, never held
    assert stopped._held is None
    assert [stopped._next_pending() for _ in range(3)] == [
        handles["b1"], handles["b0"], None]
    stopped._hold(handles["i0"])       # an interactive one holds its place
    assert stopped._held is handles["i0"]
    sched = scheds["port"]
    hold = [sched.submit(GenRequest(prompt=list(b"hold"), max_new_tokens=80,
                                    temperature=0.0, ignore_eos=True))
            for _ in range(4)]
    batch = [sched.submit(GenRequest(prompt=list(b"batch"), max_new_tokens=4,
                                     temperature=0.0, priority=PRIORITY_BATCH))
             for _ in range(2)]
    inter = [sched.submit(GenRequest(prompt=list(b"chat"), max_new_tokens=4,
                                     temperature=0.0)) for _ in range(2)]
    for h in hold + batch + inter:
        h.result(WAIT)
    assert all(h.finish_reason == "length" for h in hold)
    assert all(h.finish_reason in ("stop", "length") for h in batch + inter)
    assert all(h.admit_index is not None for h in batch + inter)
    assert sched.metrics()["batch_slots"] == 0


# ---------------------------------------------------------------------------
# both HTTP servers

MODEL = "batch-tiny"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("batchsrv")
    cfg = jl.LlamaConfig(vocab_size=512, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, max_position_embeddings=512,
                         dtype="float32")
    ckpt = write_hf_checkpoint(root / "ckpt", cfg,
                               jl.init_params(jax.random.key(3), cfg))
    models = root / "models"
    models.mkdir()
    (models / f"{MODEL}.yaml").write_text(yaml.safe_dump({
        "name": MODEL, "model": str(ckpt), "context_size": 128,
        "engine": {"max_slots": 2, "kv_block_tokens": 16,
                   "prefill_chunk": 32, "dtype": "float32",
                   "kv_dtype": "float32", "spec": False}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(
        model_path=str(models), device="cpu",
        upload_path=str(root / "port_uploads")), loader),
        "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    yield {"port": port.url, "ref": ref.base}
    ref.stop()
    port.shutdown()


def _call(url, method="GET", body=None, raw=None, ctype=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": ctype or "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _upload(url, name: str, content: bytes, purpose="batch"):
    boundary = uuid.uuid4().hex
    parts = []
    if content is not None:
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
            f'filename="{name}"\r\nContent-Type: application/jsonl\r\n\r\n'
            .encode() + content + b"\r\n")
    if purpose is not None:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="purpose"\r\n\r\n{purpose}\r\n'.encode())
    raw = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return _call(url + "/v1/files", "POST", raw=raw,
                 ctype=f"multipart/form-data; boundary={boundary}")


def _batch_via_http(url: str, name: str) -> dict:
    status, f = _upload(url, name, jsonl(3, model=MODEL))
    assert status == 200, f
    f = json.loads(f)
    status, job = _call(url + "/v1/batches", "POST", {
        "endpoint": CHAT, "input_file_id": f["id"],
        "metadata": {"who": "test"}})
    assert status == 200, job
    job = json.loads(job)
    # the port answers the record as created; the JAX server serializes it
    # after waking its executor, which may have moved the job already
    assert job["status"] in ("validating", "in_progress", "completed")
    assert job["metadata"] == {"who": "test"}

    def done():
        nonlocal job
        job = json.loads(_call(url + f"/v1/batches/{job['id']}")[1])
        return job["status"] == "completed"

    created = dict(job)
    assert wait_for(done, interval=0.1)
    status, out = _call(url + f"/v1/files/{job['output_file_id']}/content")
    assert status == 200
    return {"file": f, "job": job, "created": created,
            "records": [json.loads(x) for x in out.decode().splitlines()]}


def test_files_and_batches_over_both_servers(servers):
    got = {side: _batch_via_http(servers[side], f"in-{side}.jsonl")
           for side in ("port", "ref")}
    port, ref = got["port"], got["ref"]
    assert port["created"]["status"] == "validating"
    assert set(port["file"]) == set(ref["file"])
    assert port["file"]["purpose"] == "batch"
    assert set(port["job"]) == set(ref["job"])
    assert port["job"]["request_counts"] == ref["job"]["request_counts"] == \
        {"total": 3, "completed": 3, "failed": 0}
    by_id = lambda recs: sorted((_shape(r) for r in recs),  # noqa: E731
                                key=lambda r: r["custom_id"])
    assert by_id(port["records"]) == by_id(ref["records"])
    for side in ("port", "ref"):
        url = servers[side]
        listed = json.loads(_call(url + "/v1/batches?limit=1")[1])
        assert listed["object"] == "list" and len(listed["data"]) == 1
        files = json.loads(_call(url + "/v1/files?purpose=batch_output")[1])
        assert got[side]["job"]["output_file_id"] in {
            x["id"] for x in files["data"]}
        scrape = _call(url + "/metrics")[1].decode()
        assert "localai_batch_lane_paused 0" in scrape
        assert any(x.startswith('localai_batch_jobs{state="completed"}')
                   and float(x.rsplit(" ", 1)[1]) >= 1
                   for x in scrape.splitlines()), side
        fid = got[side]["file"]["id"]
        assert json.loads(_call(url + f"/files/{fid}")[1])["id"] == fid
        status, gone = _call(url + f"/v1/files/{fid}", "DELETE")
        assert status == 200 and json.loads(gone) == {
            "id": fid, "object": "file", "deleted": True}
        assert _call(url + f"/v1/files/{fid}")[0] == 404


@pytest.mark.parametrize("case", ["no-file", "no-purpose", "bad-endpoint",
                                  "missing-input", "wrong-purpose",
                                  "bad-metadata", "unknown-batch",
                                  "cancel-unknown", "bad-limit",
                                  "zero-limit", "cancel-done"])
def test_batch_refusals_alike(servers, case):
    statuses = {}
    for side in ("port", "ref"):
        url = servers[side]
        if case == "no-file":
            s = _upload(url, "x", None)[0]
        elif case == "no-purpose":
            s = _upload(url, f"np-{side}.jsonl", b"{}\n", purpose=None)[0]
        elif case == "bad-endpoint":
            s = _call(url + "/v1/batches", "POST", {
                "endpoint": "/v1/embeddings", "input_file_id": "x"})[0]
        elif case == "missing-input":
            s = _call(url + "/v1/batches", "POST", {
                "endpoint": CHAT, "input_file_id": "file-999"})[0]
        elif case in ("wrong-purpose", "bad-metadata"):
            _, f = _upload(url, f"{case}-{side}.jsonl", b"{}\n",
                           purpose="assistants" if case == "wrong-purpose"
                           else "batch")
            s = _call(url + "/v1/batches", "POST", {
                "endpoint": CHAT, "input_file_id": json.loads(f)["id"],
                "metadata": [1] if case == "bad-metadata" else None})[0]
        elif case == "unknown-batch":
            s = _call(url + "/v1/batches/batch_999")[0]
        elif case == "cancel-unknown":
            s = _call(url + "/v1/batches/batch_999/cancel", "POST", {})[0]
        elif case == "bad-limit":
            s = _call(url + "/v1/batches?limit=x")[0]
        elif case == "zero-limit":
            s = _call(url + "/v1/batches?limit=0")[0]
        else:
            job = _batch_via_http(url, f"cd-{side}.jsonl")["job"]
            s, out = _call(url + f"/v1/batches/{job['id']}/cancel", "POST",
                           {})
            assert json.loads(out)["status"] == "completed"
        statuses[side] = s
    assert statuses["port"] == statuses["ref"], statuses


LAX_HTTP = {
    "lax-chat": (CHAT, {"max_tokens": "3", "temperature": "0",
                        "ignore_eos": "true", "seed": 7.0}),
    "lax-completion": ("/v1/completions", {
        "prompt": "hello", "max_tokens": 3.0, "temperature": "0.0",
        "echo": "no", "n": "1"}),
    "bad-temperature": (CHAT, {"max_tokens": 3, "temperature": "hot"}),
    "bad-logit-bias": ("/v1/completions", {
        "prompt": "hello", "max_tokens": 3, "logit_bias": {"5": "x"}}),
    "bad-ignore-eos": (CHAT, {"max_tokens": 3, "ignore_eos": "maybe"}),
}


@pytest.mark.parametrize("case", sorted(LAX_HTTP))
def test_interactive_routes_read_bodies_as_the_batch_lane(servers, case):
    """The chat and completion routes validate and coerce a body with the
    batch lane's validator: a lax body answers on both servers with the
    same text, a body the schema refuses is a 400 on both."""
    path, extra = LAX_HTTP[case]
    got = {}
    for side in ("port", "ref"):
        body = {"model": MODEL, **extra}
        if path == CHAT:
            body["messages"] = [{"role": "user", "content": "hello"}]
        status, raw = _call(servers[side] + path, "POST", body)
        got[side] = (status, json.loads(raw)["choices"]
                     if status == 200 else None)
    assert got["port"] == got["ref"], got
    assert got["port"][0] == (400 if case.startswith("bad-") else 200)


def test_debug_faults_over_both_servers(servers):
    """Arm, read and clear through ``/debug/faults`` on both servers: the
    same answers (the armed spec, the site table, the cleared count) and
    the same refusals."""
    spec = {"site": "decode.nan", "mode": "nan", "match": "nobody",
            "times": 1}
    try:
        for side in ("port", "ref"):
            url = servers[side] + "/debug/faults"
            s, armed = _call(url, "POST", spec)
            assert s == 200
            assert json.loads(armed)["armed"] == {
                "site": "decode.nan", "mode": "nan", "after": 0,
                "times": 1, "match": "nobody", "delay_s": 0.0, "hits": 0,
                "fired": 0}
            got = json.loads(_call(url)[1])
            assert got["active"] is True and len(got["armed"]) == 1
            for bad in ({"mode": "raise"}, {"site": "nope"},
                        {"site": "engine.drain", "bogus": 1},
                        {"site": "engine.drain", "after": -1}):
                assert _call(url, "POST", bad)[0] == 400, bad
            s, cleared = _call(url + "?site=decode.nan", "DELETE")
            assert s == 200 and json.loads(cleared) == {"cleared": 1}
            assert json.loads(_call(url)[1])["active"] is False
    finally:
        faults.clear()
        jfaults.clear()


@pytest.mark.parametrize("method,path", [
    ("GET", "/debug/faults"), ("POST", "/debug/faults"),
    ("DELETE", "/debug/faults"), ("GET", "/v1/files"),
    ("GET", "/v1/batches"), ("POST", "/v1/batches")])
def test_fault_and_batch_routes_need_the_key(tmp_path, method, path):
    """With API keys set, ``/debug/faults``, ``/v1/files`` and
    ``/v1/batches`` answer 401 without a bearer key, as every route but
    the exempt ones does on the JAX server."""
    models = tmp_path / "models"
    models.mkdir()
    srv = APIServer(ModelManager(AppConfig(
        model_path=str(models), device="cpu", api_keys=["k-one"],
        upload_path=str(tmp_path / "uploads")), ConfigLoader(models)),
        "127.0.0.1", 0).start()
    try:
        body = {} if method == "POST" else None
        assert _call(srv.url + path, method, body)[0] == 401
        req = urllib.request.Request(
            srv.url + path, method=method,
            data=None if body is None else b"{}",
            headers={"Authorization": "Bearer k-one",
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                status = r.status
        except urllib.error.HTTPError as e:
            status = e.code
        assert status != 401
    finally:
        srv.shutdown()
