"""The port's process settings, auth, CLI and model lifecycle against the
JAX package's, on the CPU.

ROADMAP §C 9 and item 20: ``AppConfig`` from one environment and one
``run`` command line on both packages; both HTTP servers from one
environment (401 without or with a wrong key, 200 with a right one,
``/readyz`` exempt, CORS headers and ``OPTIONS`` 204, an opaque 500 body,
a key added through ``api_keys.json`` admitted after the watcher's poll);
the idle and busy watchdogs, ``single_active_backend`` and
``preload_models`` of the port's model manager with sub-second timeouts;
the subcommands (``tokenize``, ``models list``, ``util scan`` /
``usecase-heuristic`` / ``checkpoint-info``, ``version``) printing what
the JAX package's print; an unported ``run`` setting refused with exit
code 2; and the request deadline (``--request-deadline-s``,
``LOCALAI_REQUEST_DEADLINE_S``) resolved as the JAX package resolves it
and cancelling a generation at its expiry with 504; ``disable_webui`` and
the federation settings from the ``run`` flags and the environment equal
the JAX package's from the environment, the ``federated`` and
``explorer`` subcommands build what the JAX package's build, and ``run
--federated`` announces the instance to its router.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")
pytest.importorskip("tokenizers")

from localai_tpu.api import server as jax_server  # noqa: E402
from localai_tpu.cli import main as jax_cli  # noqa: E402
from localai_tpu.config.loader import ConfigLoader as JaxLoader  # noqa: E402
from localai_tpu_torch.cli import main as cli  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models import manager as port_manager  # noqa: E402
from localai_tpu_torch.models.loader import write_llama_checkpoint  # noqa: E402
from localai_tpu_torch.models.registry import resolve_model  # noqa: E402
from test_api import _ServerThread  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

ENGINE = {"max_slots": 2, "kv_block_tokens": 16, "prefill_chunk": 32,
          "dtype": "float32", "kv_dtype": "float32", "spec": False}


def _yaml(name: str, model: str, **extra) -> str:
    return json.dumps({"name": name, "model": model, "context_size": 128,
                       "engine": ENGINE, **extra})


@pytest.fixture
def clean_env(monkeypatch):
    """No LOCALAI_* variable of the test process leaks into a test."""
    for k in list(os.environ):
        if k.startswith("LOCALAI_"):
            monkeypatch.delenv(k)
    return monkeypatch


@pytest.fixture
def root_logging():
    """The JAX package's ``main`` replaces the root logger's handlers:
    put them back afterwards."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


# ---------------------------------------------------------------------------
# AppConfig from one environment + command line

PORTED_FIELDS = [f for f in AppConfig.__dataclass_fields__ if f != "device"]

SETTINGS = {
    "defaults": ({}, ["run"]),
    "environment": ({
        "LOCALAI_ADDRESS": "127.0.0.9", "LOCALAI_PORT": "9099",
        "LOCALAI_MODELS_PATH": "/srv/models", "LOCALAI_CONTEXT_SIZE": "2048",
        "LOCALAI_API_KEYS": "k1,k2", "LOCALAI_CORS_ALLOW_ORIGINS": "https://a",
        "LOCALAI_CONFIG_PATH": "/srv/conf", "LOCALAI_LOAD_TO_MEMORY": "a,b",
        "LOCALAI_OPAQUE_ERRORS": "false", "LOCALAI_SINGLE_ACTIVE_BACKEND": "1",
        "LOCALAI_WATCHDOG_IDLE_TIMEOUT": "5", "LOCALAI_CORS": "false",
        "LOCALAI_PRELOAD_MODELS": "x", "LOCALAI_LOG_LEVEL": "debug",
        "LOCALAI_REQUEST_DEADLINE_S": "30"},
        ["run"]),
    "flags": ({}, [
        "run", "m1", "m2", "--address", "1.2.3.4", "--port", "9",
        "--models-path", "p", "--context-size", "128", "--api-keys", "k",
        "--no-cors", "--opaque-errors", "--single-active-backend",
        "--preload-models", "a,b", "--enable-watchdog-idle",
        "--enable-watchdog-busy", "--watchdog-idle-timeout", "0.5",
        "--watchdog-busy-timeout", "0.25", "--request-deadline-s", "45"]),
    "flags-over-environment": ({
        "LOCALAI_ADDRESS": "127.0.0.9", "LOCALAI_API_KEYS": "envkey",
        "LOCALAI_PORT": "1", "LOCALAI_OPAQUE_ERRORS": "1",
        "LOCALAI_REQUEST_DEADLINE_S": "30"},
        ["--log-level", "warn", "run", "--address", "0.0.0.1", "--api-keys",
         "flagkey", "--port", "2", "--request-deadline-s", "12.5"]),
}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_app_config_as_on_the_reference(clean_env, root_logging, name):
    """Every ported ``AppConfig`` field equal on both packages, the JAX
    package's built by its own ``main`` (its ``serve`` stubbed)."""
    env, argv = SETTINGS[name]
    for k, v in env.items():
        clean_env.setenv(k, v)
    seen = []
    clean_env.setattr(jax_server, "serve", seen.append)
    assert jax_cli.main(argv) == 0
    ref = seen[0]
    args = cli.build_parser().parse_args(argv)
    got = cli.app_config(args)
    assert {f: getattr(got, f) for f in PORTED_FIELDS} == \
        {f: getattr(ref, f) for f in PORTED_FIELDS}
    assert got.device == "cuda"


def test_device_is_read_from_the_environment(clean_env):
    clean_env.setenv("LOCALAI_DEVICE", "cpu")
    args = cli.build_parser().parse_args(["run"])
    assert cli.app_config(args).device == "cpu"
    assert AppConfig.from_env().device == "cpu"


def test_bare_device_variable_is_not_read(clean_env):
    # only LOCALAI_DEVICE moves the server off the card
    clean_env.setenv("DEVICE", "cpu")
    args = cli.build_parser().parse_args(["run"])
    assert cli.app_config(args).device == "cuda"


# the fleet and autoscale settings, compared with the JAX package's
FLEET_FIELDS = [f.name for f in dataclasses.fields(AppConfig)
                if f.name.startswith(("fleet_", "autoscale"))]


@pytest.mark.parametrize("argv,env,item", [
    # ported: worker-process fleets (the JAX package's default backend)
    (["run", "--fleet-replicas", "2"], {}, None),
    # ported: the batch lane's settings reach AppConfig as on the JAX
    # package (item None)
    (["run", "--batch-concurrency", "4", "--batch-expiry-h", "0.5"], {},
     None),
    (["run", "--batch-concurrency", "0"], {"LOCALAI_BATCH_EXPIRY_H": "2"},
     None),
    (["run", "--autoscale"], {}, None),
    (["run", "--mesh", "data=2"], {}, 19),
    # ported: --platform cpu runs on the CPU, as the JAX package's forces
    # its CPU platform (item None)
    (["run", "--platform", "cpu"], {}, None),
    (["run"], {"LOCALAI_FLEET_REPLICAS": "2"}, None),
    # ported: the model axis (item None); the other axes stay refused,
    # naming ROADMAP item 19 part 2
    (["run"], {"LOCALAI_MESH": "data=1,model=2"}, None),
    (["run"], {"LOCALAI_MESH": "data=2,model=2"}, 19),
    # refused: a platform the port does not run on, named (item: the
    # text the refusal names)
    (["run", "--platform", "tpu"], {}, "'tpu'"),
    (["run"], {"LOCALAI_PLATFORM": "tpu"}, "'tpu'"),
    # ported: fleets of every kind and their autoscaler reach AppConfig as
    # on the JAX package (item None): in-process and worker replicas,
    # remote hosts, device pinning, standby hosts
    (["run", "--fleet-backend", "inprocess", "--fleet-replicas", "2",
      "--fleet-prefill-replicas", "1", "--fleet-disagg-threshold", "256",
      "--fleet-rpc-timeout-s", "30"], {}, None),
    (["run"], {"LOCALAI_FLEET_REPLICAS": "2",
               "LOCALAI_FLEET_BACKEND": "inprocess",
               "LOCALAI_AUTOSCALE_MAX": "3"}, None),
    (["run", "--fleet-backend", "worker", "--fleet-replicas", "3"], {},
     None),
    (["run", "--fleet-backend", "inprocess", "--fleet-hosts", "h:1"], {},
     None),
    (["run"], {"LOCALAI_FLEET_HOSTS": "h:1,h:2"}, None),
    (["run", "--fleet-device-pinning"], {}, None),
    (["run", "--autoscale-standby-hosts", "h:1"], {}, None),
], ids=["fleet", "batch", "batch-0", "autoscale", "mesh", "platform",
        "env-fleet", "env-mesh", "env-mesh-data", "platform-tpu",
        "env-platform-tpu",
        "fleet-inprocess", "env-fleet-inprocess", "fleet-worker",
        "fleet-hosts", "env-fleet-hosts", "fleet-pinning",
        "autoscale-standby"])
def test_unported_run_setting_exits_2(clean_env, capsys, tmp_path, argv, env,
                                      item):
    """An unported setting exits 2 naming its ROADMAP item, a refused one
    (``item`` a string) exits 2 naming it; a ported one (``item`` None:
    the batch lane's, the platform, every fleet setting and the
    autoscaler) builds the server with the value in its AppConfig, equal
    to the JAX package's."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    if item is None:
        seen = []
        clean_env.setattr(jax_server, "serve", seen.append)
        assert jax_cli.main(argv) == 0
        server = cli.build_server(argv + [
            "--device", "cpu", "--address", "127.0.0.1", "--port", "0",
            "--models-path", str(tmp_path)])
        try:
            app = server.manager.app
            for f in ("batch_concurrency", "batch_expiry_h",
                      *FLEET_FIELDS):
                assert getattr(app, f) == getattr(seen[0], f), f
            if "--platform" in argv:
                assert seen[0].platform == "cpu" and app.device == "cpu"
            elif "--batch-concurrency" in argv:
                assert app.batch_concurrency == int(argv[2])
            elif "--autoscale" in argv:
                assert app.autoscale is True
            elif "LOCALAI_MESH" in env:
                # the mesh's axes reach AppConfig as on the JAX package;
                # nothing is spawned before a model loads
                assert app.mesh_shape == seen[0].mesh_shape == {
                    "data": 1, "model": 2}
            elif ("--fleet-prefill-replicas" in argv
                  or env.get("LOCALAI_FLEET_BACKEND") == "inprocess"):
                assert app.fleet_replicas == 2
                assert app.fleet_backend == "inprocess"
            else:
                # the setting moved its field off the default, as on the
                # JAX package (compared field by field above)
                assert any(getattr(app, f) != getattr(AppConfig(), f)
                           for f in FLEET_FIELDS), argv
                assert app.fleet_backend == seen[0].fleet_backend
        finally:
            server.shutdown()
        return
    with pytest.raises(SystemExit) as e:
        cli.build_server(argv + ["--device", "cpu", "--models-path",
                                 str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    if isinstance(item, str):
        assert f"--platform {item}" in err and "ROADMAP" not in err
    else:
        assert f"ROADMAP item {item}" in err


@pytest.mark.parametrize("argv,env,device", [
    (["run", "--platform", "cpu"], {}, "cpu"),
    (["run", "--platform", "gpu"], {}, "cuda"),
    (["run", "--platform", "CUDA"], {}, "cuda"),
    (["run", "--platform", "cpu", "--device", "cpu"], {}, "cpu"),
    (["run"], {"LOCALAI_PLATFORM": "cpu"}, "cpu"),
    (["run"], {"PLATFORM": "cpu"}, "cpu"),
    (["run", "--platform", "cuda"], {"LOCALAI_DEVICE": "cpu"},
     "contradicts"),
    (["run", "--platform", "cpu", "--device", "cuda"], {}, "contradicts"),
])
def test_platform_selects_the_device(clean_env, argv, env, device):
    """``--platform`` (and ``LOCALAI_PLATFORM`` / ``PLATFORM``) as the JAX
    package reads it: cpu is the CPU, cuda/gpu the card; one that
    contradicts ``--device`` is refused naming both."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    args = cli.build_parser().parse_args(argv)
    if device == "contradicts":
        with pytest.raises(ValueError, match="contradicts --device"):
            cli.app_config(args)
        return
    assert cli.app_config(args).device == device


@pytest.mark.parametrize("argv,env,targets,burn", [
    (["run", "--slo-ttft-p95-ms", "200"], {}, {"ttft_ms": 200.0}, 2.0),
    # JSON logs beside an SLO flag: both served
    (["--log-format", "json", "run", "--slo-ttft-p95-ms", "200",
      "--slo-burn-threshold", "3.5"], {}, {"ttft_ms": 200.0}, 3.5),
    (["run", "--slo-tpot-p95-ms", "40"],
     {"LOCALAI_SLO_E2E_P95_MS": "900", "LOCALAI_SLO_QUEUE_P95_MS": "50",
      "LOCALAI_SLO_BURN_THRESHOLD": "4"},
     {"tpot_ms": 40.0, "e2e_ms": 900.0, "queue_ms": 50.0}, 4.0),
], ids=["slo", "log-json", "env-slo"])
def test_slo_setting_reaches_the_observatory(clean_env, root_logging,
                                             tmp_path, argv, env, targets,
                                             burn):
    """An SLO flag or ``LOCALAI_SLO_*`` variable configures the
    process-wide SLO observatory's targets when the server is built, as
    on the JAX package (whose ``main`` builds the same targets)."""
    from localai_tpu.obs import slo as jax_slo
    from localai_tpu_torch.obs import slo as port_slo

    for k, v in env.items():
        clean_env.setenv(k, v)
    seen = []
    clean_env.setattr(jax_server, "serve", seen.append)
    assert jax_cli.main(argv) == 0
    server = cli.build_server(argv + ["--device", "cpu", "--address",
                                      "127.0.0.1", "--port", "0",
                                      "--models-path", str(tmp_path)])
    try:
        assert port_slo.SLO.targets == targets
        assert port_slo.SLO.burn_threshold == burn
        assert jax_slo.targets_from_config(seen[0]) == targets
        assert seen[0].slo_burn_threshold == burn
    finally:
        server.shutdown()
        port_slo.SLO.configure(targets={}, burn_threshold=2.0)


@pytest.mark.parametrize("env", [{"LOCALAI_FLEET_REPLICAS": "0"},
                                 {"LOCALAI_SLO_BURN_THRESHOLD": "2.0"},
                                 {"LOCALAI_FLEET_BACKEND": "worker"}],
                         ids=["fleet-0", "burn-default", "backend-default"])
def test_unported_variable_at_its_default_is_accepted(clean_env, tmp_path,
                                                      env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    server = cli.build_server(["run", "--device", "cpu", "--address",
                               "127.0.0.1", "--port", "0", "--models-path",
                               str(tmp_path)])
    server.shutdown()


def test_follower_is_refused_naming_item_19(capsys, tmp_path):
    """The JAX package's ``follower`` takes its flags; a follower of a
    model whose ``sharding:`` asks for an axis but ``model`` (data here)
    exits 2 naming ROADMAP item 19 part 2, before joining any group."""
    models = tmp_path / "models"
    models.mkdir()
    (models / "m.yaml").write_text(json.dumps({
        "name": "m", "model": "debug:tiny",
        "sharding": {"tensor_parallel_size": 2, "data_parallel_size": 2}}))
    with pytest.raises(SystemExit) as e:
        cli.main(["follower", "--leader", "h:1", "--model", "m",
                  "--models-path", str(models), "--coordinator", "h:2",
                  "--num-processes", "2", "--process-id", "1",
                  "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP item 19" in capsys.readouterr().err


def test_real_entry_point_refuses_with_exit_2(tmp_path):
    # a setting still refused: the data axis of a mesh (item 19 part 2)
    res = subprocess.run(
        [sys.executable, "-m", cli.__name__, "run",
         "--mesh", "data=2", "--device", "cpu", "--models-path",
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 2
    assert "ROADMAP item 19" in res.stderr


# ---------------------------------------------------------------------------
# both HTTP servers from one environment: keys, CORS, opaque errors, the
# api_keys.json watcher


@pytest.fixture(scope="module")
def keyed_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("keyed")
    models, conf = root / "models", root / "conf"
    models.mkdir()
    conf.mkdir()
    # weights drawn once and written, so both packages load the same ones
    tiny = resolve_model("debug:tiny", dtype="float32", device="cpu")
    ckpt = write_llama_checkpoint(root / "tiny", tiny.cfg, tiny.params)
    (models / "tiny.yaml").write_text(_yaml("tiny", str(ckpt)))
    # a checkpoint dir without weights: its load fails on both packages
    broken = root / "broken"
    broken.mkdir()
    (broken / "config.json").write_text(json.dumps(
        {"model_type": "llama", "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "vocab_size": 512}))
    (models / "broken.yaml").write_text(_yaml("broken", str(broken)))
    env = {"LOCALAI_API_KEYS": "k1,k2", "LOCALAI_CONFIG_PATH": str(conf),
           "LOCALAI_OPAQUE_ERRORS": "1", "LOCALAI_MODELS_PATH": str(models),
           "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "0",
           "LOCALAI_DEVICE": "cpu"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        port = cli.build_server([]).start()
        # the JAX package's settings as its own main builds them
        seen = []
        serve, jax_server.serve = jax_server.serve, seen.append
        root_log = logging.getLogger()
        handlers, level = root_log.handlers[:], root_log.level
        try:
            assert jax_cli.main(["run"]) == 0
        finally:
            jax_server.serve = serve
            root_log.handlers[:] = handlers
            root_log.setLevel(level)
        cfg = seen[0]
        cfg.upload_path = str(root / "uploads")
        loader = JaxLoader(cfg.model_path)
        loader.load_from_path(context_size=cfg.context_size)
        ref = _ServerThread(jax_server.AppState(cfg, loader))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield {"port": port.url, "ref": ref.base, "conf": conf,
           "managers": (port.manager, ref.state.manager),
           "watchers": (port.watcher, ref.state.watcher)}
    ref.stop()
    port.shutdown()


def _call(url, method="GET", body=None, key=None):
    """(status, parsed JSON body or None, headers)."""
    headers = {"Content-Type": "application/json"}
    if key is not None:
        headers["Authorization"] = f"Bearer {key}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            raw, status, h = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        raw, status, h = e.read(), e.code, e.headers
    return status, (json.loads(raw) if raw else None), h


CHAT = {"model": "tiny", "max_tokens": 4, "temperature": 0,
        "messages": [{"role": "user", "content": "hi"}]}


def _both(servers, path, **kw):
    return [_call(servers[s] + path, **kw) for s in ("port", "ref")]


@pytest.mark.parametrize("key", [None, "wrong", "k1x", "Bearer k1"],
                         ids=["none", "wrong", "longer", "twice"])
def test_chat_without_a_right_key_is_401(keyed_servers, key):
    got = _both(keyed_servers, "/v1/chat/completions", method="POST",
                body=CHAT, key=key)
    assert [g[0] for g in got] == [401, 401]
    assert got[0][1] == got[1][1] == {"error": {
        "message": "invalid or missing API key",
        "type": "authentication_error", "code": 401}}


@pytest.mark.parametrize("key", ["k1", "k2"])
def test_chat_with_a_right_key_is_answered(keyed_servers, key):
    got = _both(keyed_servers, "/v1/chat/completions", method="POST",
                body=CHAT, key=key)
    assert [g[0] for g in got] == [200, 200]
    texts = [g[1]["choices"][0]["message"]["content"] for g in got]
    assert texts[0] == texts[1]
    assert got[0][1]["usage"] == got[1][1]["usage"]


def test_readyz_is_exempt_and_models_is_not(keyed_servers):
    assert [g[0] for g in _both(keyed_servers, "/readyz")] == [200, 200]
    assert [g[0] for g in _both(keyed_servers, "/v1/models")] == [401, 401]
    got = _both(keyed_servers, "/v1/models", key="k2")
    assert [g[0] for g in got] == [200, 200]
    assert got[0][1]["data"] == got[1][1]["data"]


def test_cors_headers_and_options(keyed_servers):
    got = _both(keyed_servers, "/v1/chat/completions", method="OPTIONS")
    assert [g[0] for g in got] == [204, 204]
    for path, kw in (("/v1/chat/completions", {"method": "OPTIONS"}),
                     ("/readyz", {}), ("/v1/models", {})):
        hs = [g[2] for g in _both(keyed_servers, path, **kw)]
        for h in ("Access-Control-Allow-Origin",
                  "Access-Control-Allow-Methods",
                  "Access-Control-Allow-Headers"):
            assert hs[0][h] == hs[1][h], (path, h)
        assert hs[0]["Access-Control-Allow-Origin"] == "*"


def test_model_load_failure_500_body(keyed_servers):
    """A model whose checkpoint has no weights fails to load: both servers
    answer 500 with the same body (a load failure is reported as such
    even under ``opaque_errors``)."""
    got = _both(keyed_servers, "/v1/chat/completions", method="POST",
                body=dict(CHAT, model="broken"), key="k1")
    assert [g[0] for g in got] == [500, 500]
    assert got[0][1] == got[1][1]
    assert got[0][1]["error"]["message"].startswith("model load failed: ")


def test_opaque_500_body(keyed_servers):
    """An unexpected failure inside a request: under ``opaque_errors`` both
    servers answer 500 with a body that says only "internal error"."""
    _both(keyed_servers, "/v1/chat/completions", method="POST", body=CHAT,
          key="k1")
    sms = [m.get("tiny") for m in keyed_servers["managers"]]

    def boom(*a, **k):
        raise RuntimeError("secret detail")

    saved = [sm.tokenizer.encode for sm in sms]
    for sm in sms:
        sm.tokenizer.encode = boom
    try:
        got = _both(keyed_servers, "/v1/chat/completions", method="POST",
                    body=CHAT, key="k1")
    finally:
        for sm, enc in zip(sms, saved):
            sm.tokenizer.encode = enc
    assert [g[0] for g in got] == [500, 500]
    assert got[0][1] == got[1][1] == {"error": {
        "message": "internal error", "type": "internal_error", "code": 500}}


def test_key_from_api_keys_json_is_admitted_after_the_poll(keyed_servers):
    conf = keyed_servers["conf"]
    before = _both(keyed_servers, "/v1/models", key="k3")
    assert [g[0] for g in before] == [401, 401]
    (conf / "api_keys.json").write_text(json.dumps(["k3"]))
    try:
        for w in keyed_servers["watchers"]:
            w.poll_once()
        after = _both(keyed_servers, "/v1/models", key="k3")
        assert [g[0] for g in after] == [200, 200]
        # the startup keys stay
        assert [g[0] for g in _both(keyed_servers, "/v1/models",
                                    key="k1")] == [200, 200]
    finally:
        (conf / "api_keys.json").unlink()
        for w in keyed_servers["watchers"]:
            w.poll_once()
    assert [g[0] for g in _both(keyed_servers, "/v1/models",
                                key="k3")] == [401, 401]


def test_external_backends_json_is_refused_with_an_error(tmp_path, caplog):
    """``external_backends.json`` merges over the startup registrations
    into ``AppConfig.external_backends`` as on the JAX package (it was
    refused with an error before the port had a worker tier; the name
    stays): added, replaced, and the startup entries back once the file
    goes. A file that is not a JSON object changes nothing, logged."""
    from localai_tpu.config.app_config import AppConfig as JaxApp
    from localai_tpu.config.watcher import ConfigWatcher as JaxWatcher
    from localai_tpu.config.watcher import (
        attach_standard_handlers as jax_attach,
    )
    from localai_tpu_torch.config.watcher import (
        ConfigWatcher,
        attach_standard_handlers,
    )

    class _State:
        def __init__(self):
            self.config = JaxApp(external_backends={"boot": "h:0"})

    app = AppConfig(external_backends={"boot": "h:0"})
    jstate = _State()
    w, jw = ConfigWatcher(tmp_path), JaxWatcher(tmp_path)
    attach_standard_handlers(w, app)
    jax_attach(jw, jstate)
    f = tmp_path / "external_backends.json"
    seen = []
    for content in ('{"w": "h:1"}', '{"w": "h:2", "boot": "h:9"}',
                    '["not", "an", "object"]', None):
        if content is None:
            f.unlink()
        else:
            f.write_text(content)
            # a fresh mtime for every version of the file
            t = time.time() + len(seen)
            os.utime(f, (t, t))
        with caplog.at_level(logging.ERROR):
            w.poll_once()
            jw.poll_once()
        assert app.external_backends == jstate.config.external_backends
        seen.append(dict(app.external_backends))
    assert seen == [{"boot": "h:0", "w": "h:1"},
                    {"boot": "h:9", "w": "h:2"},
                    {"boot": "h:9", "w": "h:2"},
                    {"boot": "h:0"}]
    assert "must be a JSON object" in caplog.text


# ---------------------------------------------------------------------------
# the model manager: watchdogs, single_active_backend, preload


@pytest.fixture
def models_dir(tmp_path):
    for name in ("a", "b"):
        (tmp_path / f"{name}.yaml").write_text(_yaml(name, "debug:tiny"))
    loader = ConfigLoader(tmp_path)
    loader.load_from_path()
    return tmp_path, loader


def _wait_for(cond, timeout=10.0):
    t = time.monotonic() + timeout
    while time.monotonic() < t:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_idle_watchdog_evicts(models_dir, monkeypatch):
    monkeypatch.setattr(port_manager._Watchdog, "INTERVAL", 0.05)
    path, loader = models_dir
    m = port_manager.ModelManager(AppConfig(
        model_path=str(path), device="cpu", watchdog_idle=True,
        watchdog_idle_timeout=0.3), loader)
    try:
        m.get("a")
        assert m.loaded_names() == ["a"]
        assert _wait_for(lambda: m.loaded_names() == [])
    finally:
        m.shutdown()
    assert not m._watchdog.is_alive() or _wait_for(
        lambda: not m._watchdog.is_alive(), 2.0)


def test_busy_watchdog_cancels_a_stuck_request(models_dir, monkeypatch):
    monkeypatch.setattr(port_manager._Watchdog, "INTERVAL", 0.01)
    path, loader = models_dir
    (path / "long.yaml").write_text(json.dumps(
        {"name": "long", "model": "debug:tiny", "context_size": 512,
         "engine": ENGINE}))
    loader.load_from_path()
    m = port_manager.ModelManager(AppConfig(
        model_path=str(path), device="cpu", watchdog_busy=True,
        watchdog_busy_timeout=0.05), loader)
    try:
        sm = m.get("long")
        h = sm.scheduler.submit(GenRequest(
            prompt=[1, 2, 3], max_new_tokens=100_000, ignore_eos=True))
        h.result(timeout=60)
        assert h.finish_reason == "cancelled"
        assert len(h.token_ids) < 500
        assert m.loaded_names() == ["long"]   # busy, so never evicted
    finally:
        m.shutdown()


def test_single_active_backend_evicts_the_other_model(models_dir):
    path, loader = models_dir
    m = port_manager.ModelManager(AppConfig(
        model_path=str(path), device="cpu", single_active_backend=True),
        loader)
    try:
        a = m.get("a")
        m.get("b")
        assert m.loaded_names() == ["b"]
        assert not a.alive()
    finally:
        m.shutdown()


def test_preload_loads_at_start(models_dir, caplog):
    """A configured name loads; a gallery ref (the embedded library's
    ``debug-tiny``) installs into the models dir, registers and loads, as
    on the JAX package; an unknown ref logs that package's warning."""
    path, loader = models_dir
    m = port_manager.ModelManager(AppConfig(
        model_path=str(path), device="cpu",
        preload_models=["b", "debug-tiny", "nope"]), loader)
    try:
        with caplog.at_level(logging.WARNING):
            m.preload()
        assert m.loaded_names() == ["b", "debug-tiny"]
        assert (path / "debug-tiny.yaml").exists()
        assert "preload: unknown model ref 'nope'" in caplog.text
        assert "ROADMAP" not in caplog.text
    finally:
        m.shutdown()


# ---------------------------------------------------------------------------
# subcommands print what the JAX package's print


@pytest.fixture(scope="module")
def cli_models(tmp_path_factory):
    """A models dir with a checkpoint (the smoke's tokenizer.json, f32 and
    bf16 weights of debug:tiny), a debug model and a pickle file."""
    root = tmp_path_factory.mktemp("cli")
    models = root / "models"
    tiny = resolve_model("debug:tiny", dtype="float32", device="cpu")
    ckpt = write_llama_checkpoint(models / "ckpt", tiny.cfg, tiny.params)
    write_llama_checkpoint(root / "ckpt-bf16", tiny.cfg, tiny.params,
                           dtype="bfloat16")
    chip_smoke.write_llama3_tokenizer(ckpt)
    (models / "ck.yaml").write_text(_yaml("ck", "ckpt"))
    (models / "dbg.yaml").write_text(_yaml("dbg", "debug:tiny",
                                           embeddings=True))
    (models / "old.bin").write_bytes(b"\x80\x02")
    return root


def _outputs(argv, capsys):
    """(exit code, stdout) of both mains on one command line."""
    out = []
    for main in (cli.main, jax_cli.main):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("argv", [
    ["version"],
    ["models", "list", "--models-path", "{m}"],
    ["tokenize", "Hello <|eot_id|> wörld 123", "--model", "ck",
     "--models-path", "{m}"],
    ["tokenize", "hi", "--model", "dbg", "--models-path", "{m}"],
    ["util", "scan", "--models-path", "{m}"],
    ["util", "scan", "--models-path", "{r}/ckpt-bf16"],
    ["util", "usecase-heuristic", "dbg", "--models-path", "{m}"],
    ["util", "usecase-heuristic", "ck", "--models-path", "{m}"],
    ["util", "checkpoint-info", "{m}/ckpt", "--header"],
    ["util", "checkpoint-info", "{r}/ckpt-bf16/model.safetensors"],
], ids=["version", "models-list", "tokenize", "tokenize-debug", "scan",
        "scan-clean", "usecases-embeddings", "usecases-llm", "info-header",
        "info-bf16"])
def test_subcommand_prints_as_the_reference(cli_models, capsys, clean_env,
                                            root_logging, argv):
    argv = [a.format(m=cli_models / "models", r=cli_models) for a in argv]
    port, ref = _outputs(argv, capsys)
    assert port == ref
    assert port[1]


def test_tokenize_reads_no_weights(cli_models, capsys, clean_env,
                                   monkeypatch):
    """``tokenize`` resolves the tokenizer alone: loading weights would
    fail here."""
    import localai_tpu_torch.models.loader as loader

    def boom(*a, **k):
        raise AssertionError("weights were read")

    monkeypatch.setattr(loader, "load_llama_params", boom)
    assert cli.main(["tokenize", "hi", "--model", "ck", "--models-path",
                     str(cli_models / "models")]) == 0
    assert capsys.readouterr().out.startswith("[")


@pytest.mark.parametrize("argv", [["models", "install", "x"],
                                  ["models", "available"]])
def test_unported_subcommand_names_its_item(capsys, tmp_path, argv):
    """Ported with the gallery: both subcommands answer as the JAX
    package's — an unknown ref exits 2 naming it, the listing prints the
    shipped index and the embedded library."""
    argv = argv + ["--models-path", str(tmp_path)]
    port, ref = _outputs(argv, capsys)
    assert port == ref
    if argv[1] == "install":
        assert port[0] == 2
    else:
        assert port[0] == 0 and "embedded@debug-tiny" in port[1]


# ---------------------------------------------------------------------------
# the request deadline


@pytest.mark.parametrize("value,want", [
    (None, 600.0), (5.0, 5.0), (0.25, 0.25), (0.0, 600.0), (-3.0, 600.0),
], ids=["default", "settings", "short", "zero", "negative"])
def test_request_deadline_resolution_as_on_the_reference(clean_env, value,
                                                         want):
    """From settings, as the JAX package resolves it when its API tier has
    an AppConfig (the variable reaches both through ``from_env``)."""
    from localai_tpu.api import inference as jax_inf
    from localai_tpu.config.app_config import AppConfig as JaxAppConfig
    from localai_tpu_torch.api import inference as inf

    kw = {} if value is None else {"request_deadline_s": value}
    clean_env.setenv("LOCALAI_REQUEST_DEADLINE_S", "7.5")  # not read here
    assert inf.request_deadline_s(AppConfig(**kw)) == \
        jax_inf.request_deadline_s(JaxAppConfig(**kw)) == want


def _hold(manager, name):
    """A chat that would decode far past any sub-millisecond deadline."""
    from localai_tpu_torch.api import openai

    return openai.chat(manager, {
        "model": name, "max_tokens": 100, "temperature": 0,
        "ignore_eos": True,
        "messages": [{"role": "user", "content": "hold this slot"}]})


@pytest.mark.parametrize("via", ["settings", "flag", "environment"])
def test_request_deadline_cancels_the_generation(clean_env, tmp_path, via):
    """At expiry the request ends with 504 naming the deadline, and the
    cancelled generation leaves its slot on the next engine step, long
    before the 100 tokens it asked for."""
    from localai_tpu_torch.api.openai import APIError

    (tmp_path / "tiny.yaml").write_text(_yaml("tiny", "debug:tiny"))
    argv = ["run", "--device", "cpu", "--address", "127.0.0.1", "--port",
            "0", "--models-path", str(tmp_path)]
    if via == "flag":
        argv += ["--request-deadline-s", "0.001"]
    elif via == "environment":
        clean_env.setenv("LOCALAI_REQUEST_DEADLINE_S", "0.001")
    server = cli.build_server(argv)
    manager = server.manager
    try:
        if via == "settings":
            manager.app.request_deadline_s = 0.001
        assert manager.app.request_deadline_s == 0.001
        sm = manager.get("tiny")
        with pytest.raises(APIError) as e:
            _hold(manager, "tiny")
        assert e.value.status == 504
        assert "request deadline" in e.value.message
        assert _wait_for(lambda: not sm.busy, timeout=30)
        # a generous deadline lets the same request finish
        manager.app.request_deadline_s = 600.0
        out = _hold(manager, "tiny")
        assert out["usage"]["completion_tokens"] == 100
    finally:
        server.shutdown()


def test_request_deadline_answers_504_over_http(clean_env, tmp_path):
    (tmp_path / "tiny.yaml").write_text(_yaml("tiny", "debug:tiny"))
    clean_env.setenv("LOCALAI_REQUEST_DEADLINE_S", "0.001")
    server = cli.build_server(["run", "--device", "cpu", "--address",
                               "127.0.0.1", "--port", "0", "--models-path",
                               str(tmp_path)]).start()
    try:
        req = urllib.request.Request(
            server.url + "/v1/chat/completions", data=json.dumps({
                "model": "tiny", "max_tokens": 100, "ignore_eos": True,
                "messages": [{"role": "user", "content": "hold"}]}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=120)
        assert e.value.code == 504
        assert "deadline" in e.value.read().decode()
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# the web UI switch, the federation settings and subcommands

WEB_FED_FIELDS = ["disable_webui", "federated", "federated_router",
                  "federated_advertise", "peer_token", "swarm_routers"]
WEB_FED = {
    "webui-off": (["--disable-webui"], {"LOCALAI_DISABLE_WEBUI": "1"}),
    "federated": (["--federated", "--federated-router", "http://r:8080",
                   "--federated-advertise", "http://me:1", "--peer-token",
                   "tok"],
                  {"LOCALAI_FEDERATED": "true",
                   "LOCALAI_FEDERATED_ROUTER": "http://r:8080",
                   "LOCALAI_FEDERATED_ADVERTISE": "http://me:1",
                   "LOCALAI_PEER_TOKEN": "tok"}),
    "swarm": (["--swarm-routers", "http://a:1,http://b:2"],
              {"LOCALAI_SWARM_ROUTERS": "http://a:1,http://b:2",
               "LOCALAI_P2P": "yes"}),
    "defaults": ([], {}),
}


@pytest.mark.parametrize("name", sorted(WEB_FED))
def test_webui_and_federation_settings_as_on_the_reference(
        clean_env, root_logging, name):
    """The JAX package reads these from the environment alone: its
    ``AppConfig`` from the variables equals the port's from the same
    variables and the port's from the ``run`` flags. ``p2p`` has no flag
    on either package: the port reads it from ``LOCALAI_P2P`` as the JAX
    package does, and ``run --p2p`` is refused as an unknown flag."""
    flags, env = WEB_FED[name]
    for k, v in env.items():
        clean_env.setenv(k, v)
    seen = []
    clean_env.setattr(jax_server, "serve", seen.append)
    assert jax_cli.main(["run"]) == 0
    from_env = cli.app_config(cli.build_parser().parse_args(["run"]))
    for k in env:
        clean_env.delenv(k)
    from_flags = cli.app_config(cli.build_parser().parse_args(
        ["run", *flags]))
    for f in WEB_FED_FIELDS:
        assert getattr(from_env, f) == getattr(from_flags, f) == \
            getattr(seen[0], f), f
    assert from_env.p2p == seen[0].p2p == ("LOCALAI_P2P" in env)
    assert from_flags.p2p is False
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["run", "--p2p"])


FEDERATED_RUNS = {
    "defaults": (["federated"], {}),
    "flags": (["federated", "--peers", "a:1, b:2", "--random-worker",
               "--target-worker", "b:2", "--peer-token", "t", "--address",
               "127.0.0.1", "--port", "9"], {}),
    "environment": (["federated"], {
        "LOCALAI_PEERS": "x:1", "LOCALAI_PEER_TOKEN": "e",
        "LOCALAI_RANDOM_WORKER": "1", "LOCALAI_TARGET_WORKER": "x:1",
        "LOCALAI_PORT": "7", "LOCALAI_ADDRESS": "127.0.0.2"}),
}


@pytest.mark.parametrize("name", sorted(FEDERATED_RUNS))
def test_federated_subcommand_as_the_reference(clean_env, root_logging,
                                               name):
    """``federated`` builds the same router from the same flags and
    variables (its blocking ``serve`` replaced by a recorder)."""
    from localai_tpu.federation import FederatedServer as JaxFed
    from localai_tpu_torch.federation import FederatedServer

    argv, env = FEDERATED_RUNS[name]
    for k, v in env.items():
        clean_env.setenv(k, v)
    seen = []

    def record(self, address, port):
        seen.append({"nodes": sorted(n.snapshot()["address"]
                                     for n in self.nodes()),
                     "load_balanced": self.load_balanced,
                     "worker_target": self.worker_target,
                     "peer_token": self.peer_token,
                     "address": address, "port": port})

    clean_env.setattr(FederatedServer, "serve", record)
    clean_env.setattr(JaxFed, "serve", record)
    assert cli.main(list(argv)) == 0
    assert jax_cli.main(list(argv)) == 0
    assert len(seen) == 2 and seen[0] == seen[1]


@pytest.mark.parametrize("argv", [
    ["explorer", "--router", "http://r:1"],
    ["explorer", "--router", "http://r:1/", "--address", "127.0.0.1",
     "--port", "9", "--db", "nets.json", "--interval", "7.5",
     "--failure-threshold", "5"],
], ids=["defaults", "flags"])
def test_explorer_subcommand_as_the_reference(clean_env, root_logging, argv):
    from localai_tpu.federation import explorer as jexplorer

    seen = []

    def record(*args, **kwargs):
        seen.append((args, kwargs))

    clean_env.setattr(cli, "serve_explorer", record)
    clean_env.setattr(jexplorer, "serve_explorer", record)
    assert cli.main(list(argv)) == 0
    assert jax_cli.main(list(argv)) == 0
    assert len(seen) == 2 and seen[0] == seen[1]


def test_run_announces_to_the_federation_router(clean_env, tmp_path):
    """``run --federated --federated-router URL`` registers the instance
    with the router as it starts, with the peer token."""
    from localai_tpu_torch.federation import FederatedServer

    router = FederatedServer([], peer_token="tok",
                             health_interval=3600).start()
    server = None
    try:
        server = cli.build_server([
            "run", "--device", "cpu", "--address", "127.0.0.1", "--port",
            "0", "--models-path", str(tmp_path), "--federated",
            "--federated-router", router.url, "--federated-advertise",
            "http://127.0.0.1:9", "--peer-token", "tok"])
        deadline = time.monotonic() + 30
        while not router.nodes() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert [n.id for n in router.nodes()] == ["127.0.0.1:9"]
    finally:
        if server is not None:
            server.shutdown()
        router.shutdown()
