"""Process-wide settings of the port's server.

Port of ``localai_tpu/config/app_config.py``: every field a ported
feature reads, with the JAX package's defaults, each also read from
``LOCALAI_<FIELD>`` by :meth:`AppConfig.from_env`. ``device`` is the
port's own (the card unless ``cpu`` is asked for), read from
``LOCALAI_DEVICE`` alike (``--platform`` is read into it by the CLI).
The web UI switch (``disable_webui``), the federation, worker-tier
(``external_backends``, ``worker_env``, ``parallel_requests``), fleet and
autoscale fields are the JAX package's, with its defaults. So are the
mesh fields: ``mesh_shape`` (``--mesh`` / ``LOCALAI_MESH``, parsed by
``parallel.mesh.parse_mesh_spec``) and the multi-host group's
``coordinator_address``, ``num_processes``, ``process_id``,
``mirror_port`` and ``mirror_followers`` (``parallel.multihost``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class AppConfig:
    # paths
    model_path: str = "models"      # dir of model YAMLs / checkpoints
    config_path: str = "configuration"   # api_keys.json (config.watcher)
    # where /v1/images/generations stores url-format images, served at
    # /generated-images/<name> (LOCALAI_IMAGE_PATH, as the JAX package)
    image_path: str = "generated_images"
    # generated assets: POST /backend/trace captures and the anomaly
    # profiler's default manifest dir live under it
    backend_assets_path: str = "backend-assets"
    # /v1/files uploads (uploadedFiles.json) and the batch jobs' state
    # and results (batch_jobs/) live under it
    upload_path: str = "uploaded_files"

    # server
    address: str = "0.0.0.0"
    port: int = 8080
    cors: bool = True
    cors_allow_origins: str = "*"
    api_keys: list[str] = field(default_factory=list)
    opaque_errors: bool = False
    # no web UI: its pages are not routed and ``/`` answers JSON to a
    # browser too (LOCALAI_DISABLE_WEBUI / --disable-webui)
    disable_webui: bool = False
    upload_limit_mb: int = 15       # the largest /v1/files upload

    # model management: the galleries ({name, url} each) the /models/*
    # routes and preload resolve refs in; autoload_galleries is the JAX
    # package's field, read and moving nothing there as here
    galleries: list[dict] = field(default_factory=list)
    autoload_galleries: bool = True
    preload_models: list[str] = field(default_factory=list)
    load_to_memory: list[str] = field(default_factory=list)
    context_size: int = 4096        # default when a model sets none
    # the JAX package's field, read and moving nothing there as here
    parallel_requests: bool = True
    single_active_backend: bool = False
    # worker tier (worker/): model name → address of an externally managed
    # worker (external_backends.json merges into it at run time), and the
    # extra environment of every spawned worker process (device pinning
    # fills it per fleet replica); neither is read from the environment
    external_backends: dict[str, str] = field(default_factory=dict)
    worker_env: dict[str, str] = field(default_factory=dict)

    # watchdog (evict idle models, cancel requests stuck past a timeout)
    watchdog_idle: bool = False
    watchdog_busy: bool = False
    watchdog_idle_timeout: float = 15 * 60.0
    watchdog_busy_timeout: float = 5 * 60.0

    # per-request wall-clock deadline of a non-streamed generation
    # (LOCALAI_REQUEST_DEADLINE_S / --request-deadline-s): expiry cancels
    # the generation, so its decode slot frees, and the client gets 504
    request_deadline_s: float = 600.0

    # offline batch subsystem (localai_tpu_torch.batch): max in-flight
    # batch lines the executor keeps submitted on the scheduler's
    # background lane, and how long a non-terminal job may live before it
    # expires (LOCALAI_BATCH_CONCURRENCY / LOCALAI_BATCH_EXPIRY_H; CLI
    # --batch-concurrency / --batch-expiry-h)
    batch_concurrency: int = 2
    batch_expiry_h: float = 24.0

    # SLO observatory + burn-rate load shedding (obs.slo): p95 latency
    # targets in ms (0 = no target; LOCALAI_SLO_TTFT_P95_MS, ...; CLI
    # --slo-*-p95-ms). When the fast (1m) AND slow (5m) error-budget burn
    # rates exceed slo_burn_threshold, new work is refused with 429 +
    # Retry-After until the fast window recovers
    slo_ttft_p95_ms: float = 0.0
    slo_tpot_p95_ms: float = 0.0
    slo_e2e_p95_ms: float = 0.0
    slo_queue_p95_ms: float = 0.0
    slo_burn_threshold: float = 2.0

    # fleets (fleet): serve each LLM from N data-parallel engine replicas
    # behind one facade; 0/1 = a single engine. Replicas are worker
    # processes (fleet_backend=worker, the default: crash isolation, and
    # device pinning through worker_env); fleet_backend=inprocess builds
    # N engines in this process. fleet_hosts adopts remote workers at
    # host:port (evicted and redialed on failure, never respawned);
    # fleet_device_pinning derives each worker's CUDA_VISIBLE_DEVICES
    # slice (fleet.pinning). fleet_prefill_replicas adds prefill replicas:
    # prompts >= fleet_disagg_threshold tokens prefill there and hand
    # their KV prefix to a decode replica. fleet_rpc_timeout_s bounds the
    # silence between two replies of a replica's stream (0 = none).
    # Env: LOCALAI_FLEET_REPLICAS etc.; CLI: --fleet-replicas etc.
    fleet_replicas: int = 0
    fleet_prefill_replicas: int = 0
    fleet_backend: str = "worker"
    fleet_disagg_threshold: int = 512
    fleet_hosts: list[str] = field(default_factory=list)
    fleet_rpc_timeout_s: float = 120.0
    fleet_device_pinning: bool = False

    # elastic capacity (fleet.autoscale): the closed-loop controller that
    # scales each fleet between autoscale_min and autoscale_max decode
    # replicas off queue depth / SLO burn / KV pressure, retires a
    # replica idle past autoscale_in_idle_s, and, when
    # autoscale_zero_idle_s > 0, scales a wholly idle model to zero
    # replicas and boots one for the next request. Overload thresholds and
    # cooldowns are environment-only (LOCALAI_AUTOSCALE_OUT_*,
    # LOCALAI_AUTOSCALE_{IN,OUT}_COOLDOWN_S, ...)
    autoscale: bool = False
    autoscale_min: int = 1
    autoscale_max: int = 4
    autoscale_interval_s: float = 5.0
    autoscale_in_idle_s: float = 120.0
    autoscale_zero_idle_s: float = 0.0
    autoscale_standby_hosts: list[str] = field(default_factory=list)

    # federation (federation/): with ``federated`` set, ``run`` announces
    # this instance to the router at ``federated_router`` as
    # ``federated_advertise`` (default http://<hostname>:<port>), with the
    # shared ``peer_token``; the swarm page's /swarm/nodes may query that
    # router, those of ``swarm_routers`` (comma-separated) and this
    # server's own port on loopback. ``p2p`` is the JAX package's field,
    # read from LOCALAI_P2P alone (no flag) and moving nothing there as here
    p2p: bool = False
    federated: bool = False
    federated_router: str = ""
    federated_advertise: str = ""
    peer_token: str = ""
    swarm_routers: str = ""

    # meshes (parallel/): the mesh's axis sizes (None = the manager's
    # default: model=all cards for a config that asks for none, when more
    # than one is visible), and the multi-host group this process joins
    # at start (coordinator host:port, its size and this process's rank)
    # with the leader's command channel (mirror_port; mirror_followers =
    # followers to wait for)
    mesh_shape: Optional[dict[str, int]] = None
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    mirror_port: int = 0
    mirror_followers: int = 0

    device: str = "cuda"            # "cuda" (default) or "cpu", explicitly

    @classmethod
    def from_env(cls, **overrides) -> "AppConfig":
        """Defaults, then ``LOCALAI_<FIELD>`` (int, float, bool as
        1/true/yes/on, comma list, str), then every override that is not
        None."""
        cfg = cls()
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"LOCALAI_{f.name.upper()}")
            if env is None:
                continue
            if f.type == "int":
                value = int(env)
            elif f.type == "float":
                value = float(env)
            elif f.type == "bool":
                value = env.lower() in ("1", "true", "yes", "on")
            elif f.type == "list[str]":
                value = [s for s in env.split(",") if s]
            elif f.type in ("list[dict]", "dict[str, str]",
                            "Optional[dict[str, int]]"):
                continue    # not read from the environment (as the JAX
                            # package: no LOCALAI_GALLERIES)
            else:
                value = env
            setattr(cfg, f.name, value)
        # LOCALAI_MESH takes the CLI's axis syntax ("data=2,model=4" or
        # "data:2,model:4"), read by the one parser behind --mesh
        mesh_env = os.environ.get("LOCALAI_MESH")
        if mesh_env is not None:
            from localai_tpu_torch.parallel.mesh import parse_mesh_spec

            cfg.mesh_shape = parse_mesh_spec(mesh_env)
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg

