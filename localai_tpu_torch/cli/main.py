"""Command line of the port: ``python -m localai_tpu_torch.cli.main <command>``.

Port of ``localai_tpu/cli/main.py`` for what the port has:

  run [MODEL ...]            serve the OpenAI-compatible API (the default)
  models list                the configured models
  models available           models of the galleries, the shipped index
                             and the embedded library (``--galleries``)
  models install REF         install a gallery model, short name or URL
  tokenize TEXT --model M    token ids, through the model's tokenizer only
  util checkpoint-info PATH  tensor names, dtypes and shapes of safetensors
  util scan                  pickle-format weights under the models dir
  util usecase-heuristic M   the usecases a model config serves
  util convert GGUF [OUT]    a GGUF checkpoint → a checkpoint dir
  tts TEXT...                synthesize speech to a wav file
  transcript FILE            transcribe a wav file
  sound-generation TEXT...   generate audio from a text description
  federated                  a federation router over instances
                             (``--peers``, ``--random-worker``,
                             ``--target-worker``, ``--peer-token``)
  explorer --router URL      the discovery dashboard over routers
  worker --addr HOST:PORT    a model worker (``worker.server``) that a
                             serving instance adopts by address
                             (``--fleet-hosts``, ``external_backends``,
                             ``POST /federated/register``)
  follower --leader H:P --model M --coordinator H:P --num-processes N
           --process-id R        a follower rank of a mesh, the
                             leader's plan in ``LOCALAI_MESH``
                             (``parallel.multihost``; ``run --mesh
                             model=N``, ``seq=N``, ``seq=N,model=M`` or
                             ``pipe=N`` spawns its own on one host)
  version

``run`` takes the JAX package's flags with their defaults, each also read
from ``LOCALAI_<NAME>`` (``_env_default``), then builds the settings as
the JAX package does: ``AppConfig.from_env`` overridden by the flags.
``--device cpu`` is the port's own (the card is the default);
``--platform`` is read as the JAX package reads it: ``cpu`` runs on the
CPU, ``cuda``/``gpu`` on the card, and any other value, or one that
contradicts ``--device``, exits 2 naming it. ``--device`` is also
on ``tts``, ``transcript`` and ``sound-generation``, which take the
JAX package's flags: the JAX package runs those three on the CPU
(``JAX_PLATFORMS=cpu``), the port on the card unless asked. The SLO
flags (``--slo-ttft-p95-ms``, ``--slo-tpot-p95-ms``, ``--slo-e2e-p95-ms``,
``--slo-queue-p95-ms``, ``--slo-burn-threshold``; ``None`` = the
``LOCALAI_SLO_*`` variable stands) reach the SLO observatory through
``AppConfig``. ``--batch-concurrency`` and ``--batch-expiry-h`` reach the batch
executor through ``AppConfig``. The fleet and autoscale flags
(``--fleet-*``, ``--autoscale*``, and their ``LOCALAI_FLEET_*`` /
``LOCALAI_AUTOSCALE_*`` variables) reach the manager's fleets the same
way: worker-process replicas by default, in-process ones with
``--fleet-backend inprocess``, remote workers from ``--fleet-hosts`` and
``--autoscale-standby-hosts``. ``--disable-webui`` and the
federation flags (``--federated``, ``--federated-router``,
``--federated-advertise``, ``--peer-token``, ``--swarm-routers``) reach
``AppConfig`` over their ``LOCALAI_*`` variables (the JAX package reads
them from the environment alone; ``p2p`` has no flag on either and is read
from ``LOCALAI_P2P`` only); with ``federated``
and a router, ``build_server`` announces the instance to it. ``--mesh``
(``LOCALAI_MESH``) reaches ``AppConfig.mesh_shape``: ``model=N`` serves
each LLM tensor-parallel over N ranks, ``seq=N`` prefills long prompts
by ring attention over N ranks (with ``model=M``: N x M ranks), ``pipe=N``
splits the layers over N stages (``parallel/``); ``data`` or ``expert``
stops ``run`` with exit code 2 naming ROADMAP item 19 part 2, and
``pipe`` with another axis with the JAX package's error.
With ``LOCALAI_COORDINATOR_ADDRESS`` and ``LOCALAI_NUM_PROCESSES`` > 1
the server joins a multi-host group as its leader and opens the command
channel (``LOCALAI_MIRROR_PORT``) before any model loads.

:func:`build_server` builds the settings, the model registry, the config
watcher and the bound server from ``argv`` and the environment;
:func:`main` only serves what it built.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
from pathlib import Path
from typing import Optional, Sequence

from localai_tpu_torch import __version__
from localai_tpu_torch.api.server import APIServer
from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.loader import ConfigLoader
from localai_tpu_torch.config.model_config import USECASES
from localai_tpu_torch.config.watcher import (
    ConfigWatcher,
    attach_standard_handlers,
)
from localai_tpu_torch.federation import FederatedServer, announce
from localai_tpu_torch.federation.explorer import serve_explorer
from localai_tpu_torch.models.manager import ModelManager
from localai_tpu_torch.obs import logging as obs_logging
from localai_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def _env_default(name: str, fallback):
    for key in (f"LOCALAI_{name.upper()}", name.upper()):
        if key in os.environ:
            return os.environ[key]
    return fallback


def _env_bool(name: str, fallback: bool = False) -> bool:
    v = _env_default(name, None)
    if v is None:
        return fallback
    return str(v).lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="localai_tpu_torch",
        description="OpenAI-compatible serving on PyTorch and CUDA")
    p.add_argument("--log-level", default=_env_default("log_level", "info"),
                   choices=["error", "warn", "info", "debug", "trace"])
    p.add_argument("--log-format", default=_env_default("log_format", "text"),
                   choices=["text", "json"],
                   help="json = one structured object per line, with the "
                        "request trace id bound by the server")
    sub = p.add_subparsers(dest="command")

    run = sub.add_parser("run", help="start the API server (default)")
    run.add_argument("models", nargs="*", help="model refs to preload")
    run.add_argument("--address", default=_env_default("address", "0.0.0.0"))
    run.add_argument("--port", type=int,
                     default=int(_env_default("port", 8080)))
    run.add_argument("--models-path",
                     default=_env_default("models_path", "models"))
    run.add_argument("--context-size", type=int,
                     default=int(_env_default("context_size", 4096)))
    run.add_argument("--api-keys", default=_env_default("api_keys", ""),
                     help="comma-separated bearer keys")
    run.add_argument("--cors", action="store_true", default=True)
    run.add_argument("--no-cors", dest="cors", action="store_false")
    run.add_argument("--opaque-errors", action="store_true",
                     default=bool(_env_default("opaque_errors", "")))
    run.add_argument("--single-active-backend", action="store_true")
    run.add_argument("--preload-models", default="",
                     help="comma-separated model names to load eagerly")
    run.add_argument("--enable-watchdog-idle", action="store_true")
    run.add_argument("--enable-watchdog-busy", action="store_true")
    run.add_argument("--watchdog-idle-timeout", type=float, default=15 * 60)
    run.add_argument("--watchdog-busy-timeout", type=float, default=5 * 60)
    # SLO observatory targets (obs.slo): p95 latency bounds in ms; when
    # the error-budget burn rate exceeds --slo-burn-threshold on both the
    # 1m and 5m windows, new generation work is refused with 429
    run.add_argument("--slo-ttft-p95-ms", type=float, default=None,
                     help="p95 time-to-first-token target (ms); 0 = off")
    run.add_argument("--slo-tpot-p95-ms", type=float, default=None,
                     help="p95 time-per-output-token target (ms)")
    run.add_argument("--slo-e2e-p95-ms", type=float, default=None,
                     help="p95 end-to-end request latency target (ms)")
    run.add_argument("--slo-queue-p95-ms", type=float, default=None,
                     help="p95 queue-wait target (ms)")
    run.add_argument("--slo-burn-threshold", type=float, default=None,
                     help="error-budget burn rate that triggers shedding "
                          "(default 2.0)")
    run.add_argument("--request-deadline-s", type=float, default=None,
                     help="per-request generation deadline in seconds; "
                          "expiry cancels the generation and frees its "
                          "decode slot (default 600)")
    # the port's own: LOCALAI_DEVICE only, never a bare DEVICE variable
    # (None here: not given; run_device resolves it with --platform)
    run.add_argument("--device", default=None, choices=("cuda", "cpu"),
                     help="the card (default; LOCALAI_DEVICE), or the CPU "
                          "for small debug models and tests")
    # the JAX package's platform switch, read as it reads it: cpu runs on
    # the CPU, cuda/gpu on the card; any other platform exits 2
    run.add_argument("--platform", default=_env_default("platform", None),
                     help="cpu, or cuda/gpu (the card); as --device")
    # offline batch subsystem (batch/): background-lane settings
    run.add_argument("--batch-concurrency", type=int, default=None,
                     help="max in-flight batch lines on the scheduler's "
                          "background lane (default 2)")
    run.add_argument("--batch-expiry-h", type=float, default=None,
                     help="hours before a non-terminal batch job expires "
                          "(default 24)")
    # fleets (fleet): engine replicas behind one cache-aware router
    run.add_argument("--fleet-replicas", type=int, default=None,
                     help="serve each LLM from N engine replicas behind "
                          "one cache-aware router (0/1 = single engine)")
    run.add_argument("--fleet-prefill-replicas", type=int, default=None,
                     help="dedicated prefill replicas for disaggregated "
                          "serving: long prompts prefill here and hand "
                          "their KV prefix to a decode replica (default 0)")
    run.add_argument("--fleet-backend", default=None,
                     choices=["worker", "inprocess"],
                     help="replica shape: spawned worker processes "
                          "(default) or in-process engines")
    run.add_argument("--fleet-disagg-threshold", type=int, default=None,
                     help="prompt tokens at which a request takes the "
                          "disaggregated prefill path (default 512)")
    run.add_argument("--fleet-device-pinning", action="store_true",
                     default=_env_bool("fleet_device_pinning"),
                     help="derive each worker replica's "
                          "CUDA_VISIBLE_DEVICES slice, so --fleet-replicas "
                          "N partitions the host's cards evenly")
    run.add_argument("--fleet-hosts", default=None,
                     help="comma-separated host:port remote workers to "
                          "adopt into every fleet pool (failed remotes are "
                          "evicted and redialed on backoff, never "
                          "respawned)")
    run.add_argument("--fleet-rpc-timeout-s", type=float, default=None,
                     help="per-reply inactivity deadline on cross-"
                          "replica streams (default 120; 0 disables)")
    # elastic capacity (fleet.autoscale)
    run.add_argument("--autoscale", action="store_true",
                     default=_env_bool("autoscale"),
                     help="telemetry-driven fleet autoscaling: scale "
                          "decode replicas between --autoscale-min/max "
                          "off queue depth, SLO burn, and KV pressure; "
                          "drain-based scale-in loses no request")
    run.add_argument("--autoscale-min", type=int, default=None,
                     help="decode replica floor the autoscaler holds "
                          "(default 1)")
    run.add_argument("--autoscale-max", type=int, default=None,
                     help="decode replica ceiling for scale-out "
                          "(default 4)")
    run.add_argument("--autoscale-interval-s", type=float, default=None,
                     help="seconds between autoscale control-loop ticks "
                          "(default 5)")
    run.add_argument("--autoscale-in-idle-s", type=float, default=None,
                     help="a replica idle this long (fleet above the "
                          "floor) is drained and retired (default 120)")
    run.add_argument("--autoscale-zero-idle-s", type=float, default=None,
                     help="all replicas idle this long → scale the model "
                          "to zero; the next request boots one and waits "
                          "for it (0 = off, the default)")
    run.add_argument("--autoscale-standby-hosts", default=None,
                     help="comma-separated host:port standby workers "
                          "adopted before spawning when scaling out")
    # the web UI and the federation (None = not given: LOCALAI_* stands)
    run.add_argument("--disable-webui", action="store_true", default=None,
                     help="serve no web UI pages (/ answers JSON)")
    run.add_argument("--federated", action="store_true", default=None,
                     help="announce this instance to --federated-router")
    run.add_argument("--federated-router", default=None,
                     help="the federation router's base URL")
    run.add_argument("--federated-advertise", default=None,
                     help="the address peers reach this instance at "
                          "(default http://<hostname>:<port>)")
    run.add_argument("--peer-token", default=None,
                     help="shared secret of /federated/register")
    run.add_argument("--swarm-routers", default=None,
                     help="comma-separated routers the swarm page may "
                          "query besides --federated-router")
    # meshes (parallel/): the model, seq and pipe axes are served; data
    # and expert are refused by name (ROADMAP item 19 part 2)
    run.add_argument("--mesh", default=_env_default("mesh", None),
                     help="mesh axes, e.g. model=2, seq=2, seq=2,model=2 "
                          "or pipe=2 (or model:2); a meshed model spawns "
                          "its follower ranks on this host's cards")

    models = sub.add_parser("models", help="model management")
    models_sub = models.add_subparsers(dest="models_command")
    mlist = models_sub.add_parser("list", help="list configured models")
    mlist.add_argument("--models-path", default="models")
    minstall = models_sub.add_parser(
        "install", help="install from gallery/embedded library/URL")
    minstall.add_argument("ref", help="name, gallery@name, or URL")
    minstall.add_argument("--models-path", default="models")
    minstall.add_argument("--name", default="", help="install under this name")
    minstall.add_argument("--galleries", default="",
                          help="JSON list of {name,url} galleries")
    mavail = models_sub.add_parser(
        "available", help="list models available to install")
    mavail.add_argument("--models-path", default="models")
    mavail.add_argument("--galleries", default="")

    worker = sub.add_parser("worker", help="start a model worker")
    worker.add_argument("--addr", default="127.0.0.1:50051")
    fol = sub.add_parser(
        "follower",
        help="tensor-parallel follower rank: replicate a leader's engine "
             "calls")
    fol.add_argument("--leader", required=True,
                     help="leader's mirror channel host:port")
    fol.add_argument("--model", required=True)
    fol.add_argument("--models-path",
                     default=_env_default("models_path", "models"))
    fol.add_argument("--coordinator",
                     default=_env_default("coordinator_address", ""),
                     help="the group's TCP store host:port")
    fol.add_argument("--num-processes", type=int,
                     default=int(_env_default("num_processes", 1)))
    fol.add_argument("--process-id", type=int,
                     default=int(_env_default("process_id", 1)))
    fol.add_argument("--peer-token",
                     default=_env_default("peer_token", ""),
                     help="shared secret for the mirror channel")
    fol.add_argument("--device", default=None,
                     help="this rank's device: cuda (the default), cuda:N, "
                          "or cpu")

    tok = sub.add_parser("tokenize", help="tokenize text with a model")
    tok.add_argument("text")
    tok.add_argument("--model", required=True)
    tok.add_argument("--models-path", default="models")

    util = sub.add_parser("util", help="model utilities")
    util_sub = util.add_subparsers(dest="util_command")
    ci = util_sub.add_parser(
        "checkpoint-info",
        help="tensor names/shapes/dtypes of a safetensors checkpoint")
    ci.add_argument("path")
    ci.add_argument("--header", action="store_true",
                    help="also print config.json")
    scan = util_sub.add_parser(
        "scan", help="scan installed models for unsafe weight formats")
    scan.add_argument("--models-path",
                      default=_env_default("models_path", "models"))
    uh = util_sub.add_parser(
        "usecase-heuristic",
        help="print the usecases a model config will serve")
    uh.add_argument("name")
    uh.add_argument("--models-path",
                    default=_env_default("models_path", "models"))
    cv = util_sub.add_parser(
        "convert",
        help="convert a GGUF checkpoint (f32/f16/q8_0/q4_0/q4_1/q4_k/q6_k) "
             "to the safetensors checkpoint layout; serve the result with "
             "quantization: int4/int8 for q4/q8-class bandwidth")
    cv.add_argument("gguf", help="path to the .gguf file")
    cv.add_argument("out", nargs="?", default=None,
                    help="output dir (default: <gguf stem> next to it)")
    cv.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "float16"])

    # the audio subcommands: the JAX package's flags, and --device
    def device_flag(parser) -> None:
        parser.add_argument(
            "--device", default=os.environ.get("LOCALAI_DEVICE", "cuda"),
            choices=("cuda", "cpu"),
            help="the card (default), or the CPU")

    tts = sub.add_parser("tts", help="synthesize speech to a wav file")
    tts.add_argument("text", nargs="+")
    tts.add_argument("--model", "-m", default="")
    tts.add_argument("--voice", "-v", default="alloy")
    tts.add_argument("--language", "-l", default="")
    tts.add_argument("--output-file", "-o", default="tts.wav")
    tts.add_argument("--models-path", default=_env_default(
        "models_path", "models"))
    device_flag(tts)

    tr = sub.add_parser("transcript", help="transcribe a wav file")
    tr.add_argument("filename")
    tr.add_argument("--model", "-m", default="")
    tr.add_argument("--language", "-l", default="")
    tr.add_argument("--translate", action="store_true")
    tr.add_argument("--models-path", default=_env_default(
        "models_path", "models"))
    device_flag(tr)

    sg = sub.add_parser("sound-generation",
                        help="generate audio from a text description")
    sg.add_argument("text", nargs="+")
    sg.add_argument("--model", "-m", default="")
    sg.add_argument("--duration", "-d", type=float, default=3.0)
    sg.add_argument("--output-file", "-o", default="sound.wav")
    device_flag(sg)

    exp = sub.add_parser(
        "explorer", help="multi-network discovery dashboard over "
                         "federation routers (dial-test + eviction)")
    exp.add_argument("--address", default="0.0.0.0")
    exp.add_argument("--port", type=int, default=8085)
    exp.add_argument("--router", required=True,
                     help="federation router base URL (more can be "
                          "registered at runtime via POST /api/networks)")
    exp.add_argument("--db", default="",
                     help="JSON file persisting the tracked-network list")
    exp.add_argument("--interval", type=float, default=50.0,
                     help="seconds between dial-test sweeps")
    exp.add_argument("--failure-threshold", type=int, default=3,
                     help="consecutive failures before a network is "
                          "evicted from the database")

    fed = sub.add_parser(
        "federated", help="run a federation router over instances")
    fed.add_argument("--address", default=_env_default("address", "0.0.0.0"))
    fed.add_argument("--port", type=int,
                     default=int(_env_default("port", 8080)))
    fed.add_argument("--peers", default=_env_default("peers", ""),
                     help="comma-separated instance addresses (host:port)")
    fed.add_argument("--random-worker", action="store_true",
                     default=_env_bool("random_worker"),
                     help="random selection instead of least-used")
    fed.add_argument("--target-worker",
                     default=_env_default("target_worker", ""),
                     help="pin all traffic to one instance")
    fed.add_argument("--peer-token",
                     default=_env_default("peer_token", ""),
                     help="shared secret for /federated/register")

    sub.add_parser("version", help="print version")
    return p


def _run_audio(cmd: str, args, parser) -> int:
    """``tts``, ``transcript`` and ``sound-generation``, as the JAX
    package runs them, on ``args.device``."""
    from localai_tpu_torch.audio import read_wav, write_wav

    resolve_device(args.device)
    if cmd == "tts":
        from localai_tpu_torch.audio.tts import synthesize

        voice = args.voice
        if args.model:
            loader = ConfigLoader(args.models_path)
            loader.load_from_path()
            mcfg = loader.get(args.model)
            if mcfg is not None and mcfg.tts.voice:
                voice = mcfg.tts.voice
        samples = synthesize(" ".join(args.text), voice=voice,
                             device=args.device)
        Path(args.output_file).write_bytes(write_wav(samples))
        print(args.output_file)
        return 0
    if cmd == "sound-generation":
        from localai_tpu_torch.audio.tts import generate_sound

        samples = generate_sound(" ".join(args.text),
                                 duration=args.duration, device=args.device)
        Path(args.output_file).write_bytes(write_wav(samples))
        print(args.output_file)
        return 0
    from localai_tpu_torch.models import whisper as wh

    loader = ConfigLoader(args.models_path)
    loader.load_from_path()
    name = args.model
    if not name:
        name = next((n for n in loader.names()
                     if loader.get(n).has_usecase("transcript")), "")
    mcfg = loader.get(name) if name else None
    ref = (mcfg.model if mcfg else name) or name
    if not ref:
        parser.error("no transcription model configured; pass --model")
    if ref.startswith("debug:"):
        model = wh.debug_model(device=args.device)
    else:
        for cand in (Path(ref), Path(args.models_path) / ref):
            if (cand / "config.json").exists():
                model = wh.load_hf_whisper(cand, device=args.device)
                break
        else:
            parser.error(f"whisper model {ref!r} not found")
    audio = read_wav(Path(args.filename).read_bytes())
    result = model.transcribe(audio, language=args.language or None,
                              translate=args.translate)
    for seg in result.get("segments", []):
        print(f"[{seg['start']:7.2f}s → {seg['end']:7.2f}s] "
              f"{seg['text']}")
    print(result.get("text", ""))
    return 0


# --platform's values and the device each names
PLATFORM_DEVICES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def run_device(args) -> str:
    """The run command's device: ``--device`` (else ``LOCALAI_DEVICE``)
    and ``--platform`` (else ``LOCALAI_PLATFORM`` / ``PLATFORM``), the
    card when neither is set. Raises ValueError for a platform the port
    does not run on, or one that contradicts the device."""
    device = args.device or os.environ.get("LOCALAI_DEVICE") or None
    plat = args.platform
    if not plat:
        return device or "cuda"
    want = PLATFORM_DEVICES.get(str(plat).lower())
    if want is None:
        raise ValueError(f"--platform {plat!r}: the port runs on "
                         f"{'/'.join(PLATFORM_DEVICES)} (a CUDA card or the "
                         "CPU)")
    if device and device != want:
        raise ValueError(f"--platform {plat!r} contradicts --device "
                         f"{device!r}")
    return want


def _setup_logging(level: str, fmt: str) -> None:
    """The root logger in ``fmt`` (text, or one JSON object a line with
    the request's trace id, ``obs.logging``)."""
    obs_logging.setup(fmt, {"error": logging.ERROR,
                            "warn": logging.WARNING, "info": logging.INFO,
                            "debug": logging.DEBUG,
                            "trace": logging.DEBUG}[level])


def app_config(args) -> AppConfig:
    """The settings of ``run``: ``LOCALAI_*`` first, the flags over them
    (the JAX package's precedence)."""
    return AppConfig.from_env(
        model_path=args.models_path,
        address=args.address,
        port=args.port,
        context_size=args.context_size,
        cors=args.cors,
        api_keys=[k for k in args.api_keys.split(",") if k],
        opaque_errors=args.opaque_errors,
        single_active_backend=args.single_active_backend,
        preload_models=[m for m in args.preload_models.split(",") if m]
        + list(args.models),
        watchdog_idle=args.enable_watchdog_idle,
        watchdog_busy=args.enable_watchdog_busy,
        watchdog_idle_timeout=args.watchdog_idle_timeout,
        watchdog_busy_timeout=args.watchdog_busy_timeout,
        # None = flag not given → LOCALAI_SLO_* (from_env) stands
        slo_ttft_p95_ms=args.slo_ttft_p95_ms,
        slo_tpot_p95_ms=args.slo_tpot_p95_ms,
        slo_e2e_p95_ms=args.slo_e2e_p95_ms,
        slo_queue_p95_ms=args.slo_queue_p95_ms,
        slo_burn_threshold=args.slo_burn_threshold,
        # None = flag not given → LOCALAI_REQUEST_DEADLINE_S stands
        request_deadline_s=args.request_deadline_s,
        # None = flag not given → LOCALAI_BATCH_* stands
        batch_concurrency=args.batch_concurrency,
        batch_expiry_h=args.batch_expiry_h,
        # None = flag not given → LOCALAI_FLEET_* / LOCALAI_AUTOSCALE_*
        # stand (the JAX package's precedence)
        fleet_replicas=args.fleet_replicas,
        fleet_prefill_replicas=args.fleet_prefill_replicas,
        fleet_backend=args.fleet_backend,
        fleet_disagg_threshold=args.fleet_disagg_threshold,
        fleet_device_pinning=args.fleet_device_pinning or None,
        fleet_hosts=([h for h in args.fleet_hosts.split(",") if h]
                     if args.fleet_hosts is not None else None),
        fleet_rpc_timeout_s=args.fleet_rpc_timeout_s,
        autoscale=args.autoscale or None,
        autoscale_min=args.autoscale_min,
        autoscale_max=args.autoscale_max,
        autoscale_interval_s=args.autoscale_interval_s,
        autoscale_in_idle_s=args.autoscale_in_idle_s,
        autoscale_zero_idle_s=args.autoscale_zero_idle_s,
        autoscale_standby_hosts=(
            [h for h in args.autoscale_standby_hosts.split(",") if h]
            if args.autoscale_standby_hosts is not None else None),
        disable_webui=args.disable_webui,
        federated=args.federated,
        federated_router=args.federated_router,
        federated_advertise=args.federated_advertise,
        peer_token=args.peer_token,
        swarm_routers=args.swarm_routers,
        mesh_shape=_mesh_shape(args.mesh),
        device=run_device(args),
    )


def _mesh_shape(spec: Optional[str]) -> Optional[dict]:
    """``--mesh`` (or ``LOCALAI_MESH``) as axis sizes; ``data`` or
    ``expert`` above 1 is refused (ValueError naming ROADMAP item 19
    part 2), and ``pipe`` with another axis (the JAX runner's gate)."""
    from localai_tpu_torch.parallel import mesh as pmesh

    shape = pmesh.parse_mesh_spec(spec) if spec else None
    if shape:
        plan = pmesh.MeshPlan(**shape)
        pmesh.refuse_part2(plan, f"--mesh {spec}")
        pmesh.check_pipe(plan)
    return shape


def build_server(argv: Optional[Sequence[str]] = None) -> APIServer:
    """``run``'s server from ``argv`` (``run`` and its flags; the
    ``run`` word may be left out) and the environment: settings, the
    config registry, the model manager with its preloads, and the config
    watcher, bound to its address but not yet serving. A setting of an
    unported feature exits 2 (``SystemExit``), naming its ROADMAP item."""
    argv = list(argv if argv is not None else sys.argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.command or "run") != "run":
        parser.error("build_server serves the run command")
    if args.command is None:
        args = parser.parse_args(argv + ["run"])
    try:
        cfg = app_config(args)
    except ValueError as e:
        parser.error(str(e))
    resolve_device(cfg.device)   # no card and no --device cpu: fail now
    if cfg.coordinator_address and cfg.num_processes > 1:
        # a multi-host leader joins the group and opens the command
        # channel before any model loads (followers connect at boot)
        from localai_tpu_torch.parallel import multihost as mh

        mh.join_as_leader(cfg)
    loader = ConfigLoader(cfg.model_path)
    loader.load_from_path(context_size=cfg.context_size)
    manager = ModelManager(cfg, loader)
    watcher = ConfigWatcher(cfg.config_path)
    attach_standard_handlers(watcher, cfg)
    try:
        manager.preload()
        server = APIServer(manager, cfg.address, cfg.port)
    except BaseException:
        manager.shutdown()
        raise
    server.watcher = watcher
    watcher.start()
    if cfg.federated and cfg.federated_router:
        # join a federation: announce this instance to the router
        own = cfg.federated_advertise or (
            f"http://{socket.gethostname()}:{server.port}")
        announce(cfg.federated_router, own, cfg.peer_token)
    log.info("serving %s on %s (device %s)", loader.names(), server.url,
             cfg.device)
    return server


def _run_follower(args, parser) -> int:
    """A follower rank: load the model config, refuse an unserved mesh
    before joining anything, join the group, build this rank's engine of
    ``--model``, then replay the leader's calls until the channel closes;
    print ``FOLLOWER_REPORT {json}`` (launch counts, each model's counters,
    weight bytes and token digest) and end the process with 0. It runs on
    the card unless told ``--device cpu`` (``LOCALAI_DEVICE``), and
    raises without one."""
    from localai_tpu_torch.models import manager as mgr
    from localai_tpu_torch.models.registry import resolve_config
    from localai_tpu_torch.parallel import multihost as mh
    from localai_tpu_torch.worker.server import launch_counts

    device = args.device or os.environ.get("LOCALAI_DEVICE") or "cuda"
    resolve_device(device)
    app = AppConfig.from_env(model_path=args.models_path, device=device)
    app.mirror_port = 0
    loader = ConfigLoader(args.models_path)
    loader.load_from_path(context_size=app.context_size)

    def config(name: str):
        mcfg = loader.get(name)
        if mcfg is None:   # a YAML written since this rank started
            loader.load_from_path(context_size=app.context_size)
            mcfg = loader.get(name)
        if mcfg is None:
            raise ValueError(f"model {name!r} not found under "
                             f"{args.models_path}")
        return mcfg

    try:
        mcfg = config(args.model)
        if not app.mesh_shape and not mcfg.sharding_set():
            # the leader's plan arrives in LOCALAI_MESH (a spawned
            # group's, or set by hand), else sharding:, else the width
            app.mesh_shape = {"model": args.num_processes}
        plan = mgr.mesh_plan(mcfg, app, resolve_config(
            mcfg.model or mcfg.name, app.model_path))
        if plan is None or plan.size() != args.num_processes:
            raise ValueError(
                f"model {args.model}: a follower of a {args.num_processes}-"
                f"rank group serves a mesh of {args.num_processes} ranks, "
                f"the config asks for {plan.size() if plan else 1}")
    except ValueError as e:
        parser.error(str(e))
    if not args.coordinator:
        parser.error("follower needs --coordinator (the group's store)")
    mh.initialize(args.coordinator, args.num_processes, args.process_id,
                  device)

    def build(name: str) -> dict:
        m = config(name)
        _model, runner = mgr.build_runner(m, app)
        spec = mgr.build_spec(runner, m, app)
        out = {name: mh.FollowerEngine(runner)}
        if spec is not None and spec.drafter.name == "model":
            out[name + "#draft"] = mh.FollowerEngine(spec.drafter)
        if runner.device.type == "cuda":
            # the load's temporaries (each whole matrix drawn or read
            # before its slice was kept) go back to the card, which the
            # leader may share
            import torch

            torch.cuda.empty_cache()
        return out

    targets = build(args.model)
    print(f"follower rank {args.process_id} of {args.num_processes} "
          f"ready ({args.model}); replaying from {args.leader}", flush=True)
    follower = mh.CommandFollower(args.leader, targets,
                                  token=args.peer_token, loader=build)
    rc = 0
    try:
        follower.run_forever()
    except Exception as e:  # noqa: BLE001 — a diverged or broken replay
        print(f"follower rank {args.process_id}: {e}", file=sys.stderr)
        rc = 1
    report = {"rank": args.process_id, "launches": launch_counts(),
              "replayed": follower.replayed, "errors": follower.errors,
              "models": follower.report()}
    follower.close()
    print(f"{mh.REPORT_PREFIX}{json.dumps(report)}", flush=True)
    sys.stderr.flush()
    # exit at once: a group teardown under NCCL waits for every rank, and
    # the leader tears down after its followers are gone; a follower that
    # left the leader's state exits 1, and the leader fails its engine
    os._exit(rc)


def _models_gallery(args, parser) -> int:
    """``models available`` lists the galleries' models, the shipped
    index and the embedded library; ``models install REF`` installs one
    into ``--models-path``, printing per-file progress."""
    from localai_tpu_torch.gallery import (
        EMBEDDED_MODELS,
        Gallery,
        available_models,
        install_model,
        resolve_ref,
    )

    galleries = [Gallery(name=g["name"], url=g["url"])
                 for g in (json.loads(args.galleries)
                           if args.galleries else [])]
    if args.models_command == "available":
        for m in available_models(galleries, args.models_path):
            mark = "*" if m.installed else " "
            print(f"{mark} {m.id}\t{m.description}")
        for name, m in sorted(EMBEDDED_MODELS.items()):
            print(f"  embedded@{name}\t{m.description}")
        return 0
    ref = args.ref
    model = resolve_ref(galleries, ref, name=args.name)
    if model is None:
        parser.error(f"model {ref!r} not found in embedded library "
                     "or configured galleries")

    def progress(fn, done, total):
        pct = f"{100.0 * done / total:5.1f}%" if total else "?"
        print(f"\r{fn}: {pct}", end="", flush=True)

    path = install_model(model, args.models_path,
                         install_name=args.name or model.name,
                         progress=progress)
    print(f"\ninstalled → {path}")
    return 0


def _checkpoint_info(args, parser) -> int:
    from localai_tpu_torch.models.loader import (
        SAFETENSORS_DTYPES,
        read_safetensors_index,
    )

    names = {dt: name for name, dt in SAFETENSORS_DTYPES.items()}
    p = Path(args.path)
    files = [p] if p.is_file() else sorted(p.glob("*.safetensors"))
    if not files:
        parser.error(f"no safetensors under {p}")
    cfg_dir = p.parent if p.is_file() else p
    if args.header and (cfg_dir / "config.json").exists():
        print((cfg_dir / "config.json").read_text())
    total = 0
    for fp in files:
        index = read_safetensors_index(fp)
        for name in sorted(index):
            _path, _off, _n, dt, shape = index[name]
            n = 1
            for d in shape:
                n *= d
            total += n
            print(f"{name}\t{names[dt]}\t{list(shape)}")
    print(f"# total parameters: {total:,}")
    return 0


def _run_util(args, parser) -> int:
    if args.util_command == "checkpoint-info":
        return _checkpoint_info(args, parser)
    if args.util_command == "scan":
        # weights must be safetensors; pickle formats run code at load
        bad = [f for f in Path(args.models_path).rglob("*")
               if f.suffix in (".bin", ".pt", ".pth", ".ckpt", ".pickle",
                               ".pkl")]
        for f in bad:
            print(f"UNSAFE (pickle-format weights): {f}")
        print(f"{len(bad)} finding(s)")
        return 1 if bad else 0
    if args.util_command == "usecase-heuristic":
        loader = ConfigLoader(args.models_path)
        loader.load_from_path()
        mcfg = loader.get(args.name)
        if mcfg is None:
            parser.error(f"model {args.name!r} not found")
        for uc in USECASES:
            if (uc in mcfg.known_usecases if mcfg.known_usecases is not None
                    else uc in mcfg.usecase_heuristic()):
                print(uc)
        return 0
    if args.util_command == "convert":
        from localai_tpu_torch.utils.gguf import convert_gguf

        src = Path(args.gguf)
        if not src.is_file():
            parser.error(f"{src}: not a file")
        out = Path(args.out) if args.out else src.with_suffix("")
        convert_gguf(src, out, dtype=args.dtype)
        print(f"converted {src} -> {out}")
        return 0
    parser.error("unknown util subcommand")
    return 2


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    _setup_logging(args.log_level, args.log_format)
    cmd = args.command or "run"
    if cmd == "version":
        print(__version__)
        return 0
    if cmd == "run":
        server = build_server(argv)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        return 0
    if cmd == "models":
        if args.models_command == "list":
            loader = ConfigLoader(args.models_path)
            loader.load_from_path()
            for name in loader.names():
                print(name)
            return 0
        if args.models_command in ("install", "available"):
            return _models_gallery(args, parser)
        parser.error("unknown models subcommand")
    if cmd == "tokenize":
        from localai_tpu_torch.models.registry import resolve_tokenizer

        loader = ConfigLoader(args.models_path)
        loader.load_from_path()
        mcfg = loader.get(args.model)
        if mcfg is None:
            parser.error(f"model {args.model!r} not found")
        # tokenizer only: never read weights to encode a string
        tok = resolve_tokenizer(mcfg.model, args.models_path)
        print(tok.encode(args.text))
        return 0
    if cmd == "follower":
        return _run_follower(args, parser)
    if cmd == "worker":
        from localai_tpu_torch.worker.server import serve_worker

        serve_worker(args.addr)
        return 0
    if cmd == "util":
        return _run_util(args, parser)
    if cmd in ("tts", "transcript", "sound-generation"):
        return _run_audio(cmd, args, parser)
    if cmd == "explorer":
        serve_explorer(args.router, args.address, args.port,
                       db_path=args.db or None, interval=args.interval,
                       failure_threshold=args.failure_threshold)
        return 0
    if cmd == "federated":
        FederatedServer(
            [a.strip() for a in args.peers.split(",") if a.strip()],
            load_balanced=not args.random_worker,
            worker_target=args.target_worker,
            peer_token=args.peer_token,
        ).serve(args.address, args.port)
        return 0
    parser.error(f"unknown command {cmd!r}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
