"""Model lifecycle: config → live engine (runner + scheduler + tokenizer).

Port of ``localai_tpu/models/manager.py::build_runner`` /
``build_serving_model`` and ``ServingModel`` for one device, plus a small
thread-safe ``ModelManager`` that loads each configured model on first
use. The engine runs the paged layout unless ``engine.kv_paged`` is false
(on one device nothing else forces the contiguous one, as in the JAX
package's ``build_runner``; ``LOCALAI_KV_PAGED=0`` and ``LOCALAI_KV_DTYPE``
apply as there); ``engine.quantization`` (int8/int4) quantizes
the weights on the device, a debug preset's after it is drawn and a
checkpoint's layer by layer as it is read (the JAX package quantizes the
loaded tree: the same bytes, without a whole compute-dtype tree on the
card). Speculative decoding is on by default for paged engines
(the n-gram self-drafter) and for any engine with a ``draft_model``, as
in the JAX package. ``engine.grp_attn_n`` > 1 (self-extend) lifts the
context ceiling to ``max_position_embeddings * grp_attn_n``, takes the
contiguous layout when the config leaves the layout open, and turns
speculation off with a warning; ``prompt_cache_path`` gives the scheduler
a disk prompt KV cache (a relative path lives under the models dir).
Each serving model carries a ``TemplateCache`` over
the models dir, as the JAX package's does. The manager loads
``preload_models`` at start, evicts the other models before a load under
``single_active_backend``, and runs the JAX package's idle/busy watchdog.
As in the JAX package's ``ModelManager._load``, ``backend: worker`` runs
the engine in a spawned worker process, and a model named in
``external_backends`` in the worker at that address
(``worker.serving.WorkerServingModel`` over :meth:`ModelManager.pool`);
``backend: mamba | rwkv`` builds the recurrent-state engine
(``models/mamba_serving.py``) and
``backend: huggingface | langchain-huggingface`` the remote-API client
(``models/hf_api.py``); cross-encoders and sentence encoders
(``models/reranker.py``) load through ``get_reranker`` /
``get_embedder`` into :class:`RerankServingModel` /
:class:`EmbeddingServingModel`, and whisper and VITS voices
(``models/whisper.py``, ``audio/vits.py``) through ``get_whisper`` /
``get_vits`` into :class:`AudioServingModel`, and diffusion pipelines
(``image/``) through ``get_image`` into :class:`ImageServingModel`, with
the ``diffusers:`` section's defaults, a ``lora_adapter`` (relative to the
models dir unless absolute) and a ``control_net``. Every kind shares one
registry, so
eviction, the watchdog, ``shutdown_model`` and preload treat them alike;
a name asked for as another kind is reloaded (when idle). Every LLM
engine gets the self-healing ``faults.EngineSupervisor`` unless
``LOCALAI_SELF_HEAL=0``; an engine it marks failed reads as not alive, so
the next request reloads the model, as a dead engine thread does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Iterator, Optional

from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.loader import ConfigLoader
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.engine.promptcache import PromptKVCache
from localai_tpu_torch.engine.runner import ModelRunner
from localai_tpu_torch.engine.scheduler import Scheduler
from localai_tpu_torch.models.registry import LoadedModel, resolve_model
from localai_tpu_torch.obs.engine import EngineTelemetry
from localai_tpu_torch.templates.cache import TemplateCache

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ServingModel:
    """One loaded model: engine + tokenizer + its declarative config."""

    name: str
    config: ModelConfig
    runner: ModelRunner
    scheduler: Scheduler
    tokenizer: Any
    templates: TemplateCache          # over the models dir
    vision: Any = None                # models.vision.VisionTower, or None
    image_token_id: int = 0           # the id image placeholders expand to
    loaded_at: float = dataclasses.field(default_factory=time.monotonic)
    last_used: float = dataclasses.field(default_factory=time.monotonic)

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def alive(self) -> bool:
        """The engine thread is the health signal (dead → reload)."""
        return self.scheduler.alive()

    def engine_metrics(self) -> dict:
        return self.scheduler.metrics()

    def close(self) -> None:
        self.scheduler.shutdown()
        drop = getattr(self.runner, "drop", None)
        if drop is not None:   # a mirrored engine: the followers free it
            drop()


@dataclasses.dataclass
class _EncoderServingModel:
    """A loaded BERT-class encoder under the manager's lifecycle (watchdog,
    eviction): in-flight accounting around each call, and the encoder
    snapshot a call holds while an eviction may drop the model's own."""

    name: str
    config: ModelConfig
    encoder: Any                      # models.reranker.CrossEncoder or
                                      # SentenceEncoder
    loaded_at: float = dataclasses.field(default_factory=time.monotonic)
    last_used: float = dataclasses.field(default_factory=time.monotonic)
    _inflight: int = 0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def alive(self) -> bool:
        return self.encoder is not None

    def close(self) -> None:
        self.encoder = None   # frees the weights once in-flight calls end

    def _call(self, method: str, *args):
        enc = self.encoder    # snapshot: an eviction mid-request keeps it
        if enc is None:
            raise RuntimeError(f"model {self.name} was evicted")
        with self._lock:
            self._inflight += 1
        try:
            return getattr(enc, method)(*args)
        finally:
            with self._lock:
                self._inflight -= 1
            self.touch()


@dataclasses.dataclass
class RerankServingModel(_EncoderServingModel):
    """A cross-encoder (the JAX package's ``RerankServingModel``)."""

    scored: int = 0

    def engine_metrics(self) -> dict:
        return {"type": "rerank", "pairs_scored": self.scored}

    def score(self, query: str, documents: list[str]):
        """(scores, total input tokens)."""
        out = self._call("score_with_usage", query, documents)
        self.scored += len(documents)
        return out


@dataclasses.dataclass
class EmbeddingServingModel(_EncoderServingModel):
    """A sentence encoder (the JAX package's ``EmbeddingServingModel``)."""

    embedded: int = 0

    def engine_metrics(self) -> dict:
        return {"type": "embeddings", "texts_embedded": self.embedded}

    def embed(self, texts: list[str]):
        """(vectors, total input tokens)."""
        out = self._call("embed_with_usage", texts)
        self.embedded += len(texts)
        return out


@dataclasses.dataclass
class AudioServingModel:
    """A loaded whisper or VITS model under the manager's lifecycle
    (watchdog, eviction, ``/backend/monitor``): the JAX package's
    ``AudioServingModel``."""

    name: str
    config: ModelConfig
    model: Any                        # WhisperModel | VitsTTS
    kind: str = "whisper"             # "whisper" | "vits"
    loaded_at: float = dataclasses.field(default_factory=time.monotonic)
    last_used: float = dataclasses.field(default_factory=time.monotonic)
    _inflight: int = 0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    served: int = 0

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def alive(self) -> bool:
        return self.model is not None

    def close(self) -> None:
        self.model = None

    def engine_metrics(self) -> dict:
        return {"type": self.kind, "requests_served": self.served}

    def run(self, fn_name: str, *args, **kwargs):
        """Invoke a model method with busy accounting (watchdog-visible);
        snapshots the model so a concurrent eviction cannot drop it
        mid-request."""
        model = self.model
        if model is None:
            raise RuntimeError(f"{self.kind} model {self.name} was evicted")
        with self._lock:
            self._inflight += 1
        try:
            out = getattr(model, fn_name)(*args, **kwargs)
        finally:
            with self._lock:
                self._inflight -= 1
        self.served += 1
        self.touch()
        return out


@dataclasses.dataclass
class ImageServingModel:
    """A loaded diffusion pipeline under the manager's lifecycle
    (watchdog, eviction, ``/backend/monitor``): the JAX package's
    ``ImageServingModel``."""

    name: str
    config: ModelConfig
    pipeline: Any                     # image.pipeline.DiffusionPipeline
    loaded_at: float = dataclasses.field(default_factory=time.monotonic)
    last_used: float = dataclasses.field(default_factory=time.monotonic)
    _inflight: int = 0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    generated: int = 0
    kind: str = "image"

    def touch(self) -> None:
        self.last_used = time.monotonic()

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight > 0

    @contextlib.contextmanager
    def in_use(self) -> Iterator["ImageServingModel"]:
        """Holds the busy flag across a multi-image request, so an
        eviction sweep cannot drop the pipeline between its images."""
        with self._lock:
            self._inflight += 1
        try:
            yield self
        finally:
            with self._lock:
                self._inflight -= 1

    def alive(self) -> bool:
        return self.pipeline is not None

    def close(self) -> None:
        self.pipeline = None  # frees the weights once in-flight calls end

    def engine_metrics(self) -> dict:
        return {"type": "image", "images_generated": self.generated}

    def generate(self, *args, **kwargs):
        """Run the pipeline with busy accounting; a snapshot of the
        pipeline keeps an in-flight request going through an eviction."""
        pipe = self.pipeline
        if pipe is None:
            raise RuntimeError(f"image model {self.name} was evicted")
        with self.in_use():
            out = pipe.generate(*args, **kwargs)
        self.generated += 1
        self.touch()
        return out


def mesh_plan(mcfg: ModelConfig, app: AppConfig, cfg: Any,
              auto: bool = True) -> Any:
    """The mesh a model is served on (``parallel.mesh.MeshPlan``), or None
    for one device: the JAX package's ``build_runner`` mesh logic and its
    ``_auto_mesh``, on the ``model``, ``seq`` and ``pipe`` axes.

    ``--mesh`` / ``LOCALAI_MESH`` (``app.mesh_shape``) wins, then the
    config's ``sharding:``; ``data`` or ``expert`` above 1 is refused
    naming ROADMAP item 19 part 2, and ``pipe`` with any other axis
    raises the JAX package's error. ``pipeline_parallel_size`` builds
    ``pipe`` alone (the JAX package claims exactly that many devices);
    where the JAX package would fill the remaining devices with ``data``
    beside ``seq`` and ``model``, the port builds the asked axes alone on
    that many ranks with one warning; with fewer cards than ranks, ranks
    share cards. With no explicit topology and more than one card
    visible, the model is served ``model=tp`` with tp as wide as the q
    heads allow (``LOCALAI_MESH_AUTO=0`` turns that off; self-extend
    keeps one device, as in the JAX package); in a multi-host group
    (``coordinator_address``, ``num_processes``) a model spans the
    group's ranks. The CPU has no device count: it is meshed only when
    asked. ``auto=False`` gives the topology that was set (None where
    only the auto mesh would apply)."""
    from localai_tpu_torch.parallel import mesh as pmesh

    shard = mcfg.sharding
    want_tp = max(1, shard.tensor_parallel_size)
    want_sp = max(1, shard.sequence_parallel_size)
    want_pp = max(1, shard.pipeline_parallel_size)
    want_ep = max(1, shard.expert_parallel_size)
    want_dp = shard.data_parallel_size
    cards = pmesh.device_count() if app.device != "cpu" else 0
    if app.mesh_shape:
        plan = pmesh.MeshPlan(**app.mesh_shape)
        where = f"model {mcfg.name}: --mesh / LOCALAI_MESH"
        pmesh.refuse_part2(plan, where)
        pmesh.check_pipe(plan)
    elif (want_tp > 1 or want_sp > 1 or want_pp > 1 or want_ep > 1
          or want_dp not in (0, 1)):
        if want_pp > 1 and (want_tp > 1 or want_sp > 1 or want_ep > 1
                            or want_dp not in (0, 1)):
            # the JAX package's error: the other knobs are not dropped
            raise ValueError(
                "pipeline_parallel_size composes with no other "
                "sharding axis yet; unset tensor/sequence/expert/"
                "data_parallel_size")
        asked = {}
        if want_ep > 1:
            asked["expert_parallel_size"] = want_ep
        if want_dp not in (0, 1):
            asked["data_parallel_size"] = want_dp
        if asked:
            raise ValueError(f"model {mcfg.name}: sharding {asked} is not "
                             f"ported yet ({pmesh.PART2})")
        if want_pp > 1:
            plan = pmesh.MeshPlan(pipe=want_pp)
        else:
            plan = pmesh.MeshPlan(seq=want_sp, model=want_tp)
            if cards > plan.size():
                log.warning(
                    "model %s: the JAX package would build data=%d x %s "
                    "over %d devices; the port builds %s on %d cards "
                    "(data: %s)", mcfg.name, cards // plan.size(),
                    pmesh.spec_of(plan), cards, pmesh.spec_of(plan),
                    plan.size(), pmesh.PART2)
    elif app.coordinator_address and app.num_processes > 1:
        # a multi-host group (joined at start): the model spans its ranks
        plan = pmesh.MeshPlan(model=app.num_processes)
    else:
        if (not auto or os.environ.get("LOCALAI_MESH_AUTO", "") == "0"
                or cards < 2 or mcfg.engine.grp_attn_n > 1
                or app.mirror_port):
            return None
        tp = pmesh.default_tensor_parallel(cards, cfg.num_heads)
        if tp < 2:
            log.warning(
                "auto mesh: %d devices visible but num_heads=%d admits no "
                "tensor-parallel split; serving single-device", cards,
                cfg.num_heads)
            return None
        if cards // tp > 1:
            log.warning(
                "auto mesh: the JAX package would build data=%d x "
                "model=%d; the port uses model=%d on %d of %d cards (%s)",
                cards // tp, tp, tp, tp, cards, pmesh.PART2)
        plan = pmesh.MeshPlan(model=tp)
        log.info("auto mesh for %s: model=%d", mcfg.name, tp)
    return plan if plan.size() > 1 else None


def _mesh_for(plan: Any, app: AppConfig, mcfg: ModelConfig) -> Any:
    """This process's ``Mesh`` for a meshed model: a follower's (or a
    multi-host leader's) joined group, else the single-host group the
    leader spawns now; a leader whose followers are connected tells them
    to build the model too (``__load__``)."""
    import torch.distributed as dist

    from localai_tpu_torch.fleet.kveconomy.tiering import (
        tier_budget_from_env,
    )
    from localai_tpu_torch.parallel import mesh as pmesh
    from localai_tpu_torch.parallel import multihost as mh

    if tier_budget_from_env() > 0:
        raise ValueError(f"model {mcfg.name}: the host KV tier "
                         "(LOCALAI_KV_TIER_MB) on a tensor-parallel engine "
                         f"is not ported yet ({pmesh.PART2})")
    group = mh.current_group()
    if not (dist.is_initialized() and group is None):
        group = mh.ensure_group(app, plan, mcfg.name)
        with group.leader.call_lock:
            if group.leader.connected:
                group.leader.broadcast(mcfg.name, "__load__")
    return pmesh.build_mesh(plan)


def build_runner(mcfg: ModelConfig, app: AppConfig,
                 ) -> tuple[LoadedModel, ModelRunner]:
    """Config → (resolved model, live ModelRunner) on ``app.device``, or
    as this process's rank of the model's mesh (``mesh_plan``): its
    weight slices, cut as they load."""
    from localai_tpu_torch.models.registry import resolve_config

    mcfg.check_supported()
    eng = mcfg.engine
    ref = mcfg.model or mcfg.name
    plan = mesh_plan(mcfg, app, resolve_config(ref, app.model_path))
    mesh = _mesh_for(plan, app, mcfg) if plan is not None else None
    device = mesh.device if mesh is not None else app.device
    model = resolve_model(ref, model_path=app.model_path, dtype=eng.dtype,
                          seed=mcfg.seed or 0, device=device,
                          quantization=eng.quantization or "", mesh=mesh)
    # self-extend lifts the trained-context ceiling by the group factor
    ctx = min(mcfg.context_size or app.context_size,
              model.cfg.max_position_embeddings * max(eng.grp_attn_n, 1))
    # paged unless the config says otherwise, self-extend asks for the
    # contiguous layout, or LOCALAI_KV_PAGED=0 (an explicit per-model
    # kv_paged wins); LOCALAI_KV_DTYPE replaces a default bfloat16 KV
    # dtype, except int4 on a contiguous engine, which keeps its dtype
    # with a warning (the JAX package's build_runner)
    paged = eng.kv_paged
    if paged is None:
        # the stage chain keeps the contiguous layout (the JAX package's
        # build_runner: paged is off under 'pipe')
        paged = ((mesh is None or mesh.shape["pipe"] == 1)
                 and eng.grp_attn_n <= 1
                 and os.environ.get("LOCALAI_KV_PAGED", "") != "0")
    kv_dtype = eng.kv_dtype
    env_kv = os.environ.get("LOCALAI_KV_DTYPE", "").strip()
    if env_kv and kv_dtype == "bfloat16":
        if env_kv == "int4" and not paged:
            log.warning(
                "LOCALAI_KV_DTYPE=int4 ignored for %s: int4 KV requires "
                "the paged layout (engine is contiguous)", mcfg.name)
        else:
            kv_dtype = env_kv
    runner = ModelRunner(
        model.cfg, model.params,
        num_slots=eng.max_slots,
        max_ctx=ctx,
        prefill_buckets=eng.prefill_buckets,
        kv_dtype=kv_dtype,
        rope_freq_base=mcfg.rope_freq_base,
        rope_freq_scale=mcfg.rope_freq_scale,
        seed=mcfg.seed or 0,
        paged=paged,
        kv_block_tokens=eng.kv_block_tokens,
        kv_num_blocks=eng.kv_num_blocks,
        prefill_chunk=eng.prefill_chunk,
        ga_n=eng.grp_attn_n,
        ga_w=eng.grp_attn_w,
        attn_impl=eng.attn_impl,
        device=device,
        mesh=mesh,
        sp_threshold=eng.sp_prefill_threshold,
    )
    return model, runner


def build_spec(runner: ModelRunner, mcfg: ModelConfig, app: AppConfig):
    """Speculative decoding (localai_tpu_torch.spec), as the JAX package
    chooses it: on by default for paged engines (the n-gram self-drafter
    needs no second model) and whenever a draft_model is set, unless
    LOCALAI_SPEC=0; engine.spec true/false forces it. LOCALAI_SPEC_DRAFTER
    overrides spec_drafter; a configured draft_model upgrades the drafter
    to a co-located draft runner (on a mesh, sharded over the target's).
    Returns the SpecEngine, or None."""
    eng = mcfg.engine
    spec_want = eng.spec
    if spec_want is None:
        spec_want = ((runner.paged or bool(eng.draft_model))
                     and os.environ.get("LOCALAI_SPEC", "") != "0")
    if spec_want and eng.grp_attn_n > 1:
        log.warning(
            "%s: speculative decoding is not supported with self-extend "
            "(grp_attn_n>1); serving without it", mcfg.name)
        return None
    if not spec_want:
        return None
    from localai_tpu_torch.spec import build_spec_engine

    drafter = (os.environ.get("LOCALAI_SPEC_DRAFTER", "")
               or eng.spec_drafter or "auto")
    if drafter == "model" and not eng.draft_model:
        log.warning(
            "%s: spec_drafter=model but no draft_model configured; "
            "using the n-gram self-drafter", mcfg.name)
        drafter = "ngram"
    gamma = eng.spec_gamma
    if gamma is None and eng.draft_model:
        gamma = max(1, eng.n_draft)
    spec = build_spec_engine(runner, drafter=drafter,
                             draft_ref=eng.draft_model,
                             model_path=app.model_path, gamma=gamma,
                             dtype=eng.dtype)
    log.info("%s: speculative decoding on (%s drafter, gamma=%d, %s "
             "KV)", mcfg.name, spec.drafter.name, spec.gamma,
             "paged" if spec.paged else "contiguous")
    return spec


def build_serving_model(mcfg: ModelConfig, app: AppConfig) -> ServingModel:
    """Config → live engine: weights, runner, scheduler, tokenizer. A
    meshed model's runner (and a draft model's drafter) is mirrored to the
    follower ranks (``parallel.multihost.mirror``) once they joined."""
    t0 = time.monotonic()
    eng = mcfg.engine
    model, runner = build_runner(mcfg, app)
    spec = build_spec(runner, mcfg, app)
    meshed = runner.mesh is not None
    if meshed:
        from localai_tpu_torch.parallel import multihost as mh

        runner, spec = mh.mirror(runner, spec, mcfg.name,
                                 mh.current_group())
    prompt_cache = None
    if mcfg.prompt_cache_path and meshed:
        log.warning(
            "%s: prompt_cache_path is not supported with multi-host command "
            "mirroring (KV loads would desync followers); ignoring",
            mcfg.name)
    elif mcfg.prompt_cache_path:
        pc_path = Path(mcfg.prompt_cache_path)
        if not pc_path.is_absolute():
            pc_path = Path(app.model_path) / pc_path
        prompt_cache = PromptKVCache(pc_path,
                                     read_only=mcfg.prompt_cache_ro,
                                     min_prefix=runner.prefix_reuse_min)
        log.info("%s: prompt KV cache at %s (%s%s)", mcfg.name, pc_path,
                 "ro, " if mcfg.prompt_cache_ro else "",
                 "prompt+generation" if mcfg.prompt_cache_all
                 else "prompt only")
    scheduler = Scheduler(
        runner, model.tokenizer,
        default_max_tokens=mcfg.parameters.max_tokens or 2048,
        multi_step=eng.decode_steps_per_dispatch,
        pipeline_depth=eng.pipeline_depth,
        stream_latency_target=eng.stream_latency_ms / 1000.0,
        spec=spec,
        prompt_cache=prompt_cache,
        prompt_cache_all=mcfg.prompt_cache_all,
        telemetry=EngineTelemetry(model=mcfg.name),
    )
    # self-healing supervisor (localai_tpu_torch.faults): a watchdog stall
    # on this engine's channel escalates trace → drain with 5xx → runner
    # re-init → probe dispatch, bounded and backed off, then marks the
    # model failed (the dead-engine reload here takes over from there).
    # Speculating engines rebuild too (SpecEngine.reinit).
    # LOCALAI_SELF_HEAL=0 disables it.
    if ((spec is None or getattr(spec, "supports_rebuild", False))
            and os.environ.get("LOCALAI_SELF_HEAL", "1") != "0"):
        from localai_tpu_torch.faults import EngineSupervisor

        EngineSupervisor(scheduler)
    # vision tower: the explicit mmproj ref, or the llava checkpoint itself;
    # on the engine's device, in its dtype
    vision = None
    vt_ref = mcfg.mmproj or (str(model.model_dir)
                             if model.hf_type == "llava" else None)
    if vt_ref:
        from localai_tpu_torch.models.vision import resolve_vision_tower

        vision = resolve_vision_tower(
            vt_ref, projection_dim=model.cfg.hidden_size,
            model_path=app.model_path, seed=mcfg.seed or 0,
            dtype=eng.dtype, device=runner.device)
        log.info("loaded vision tower %s: %d patches -> D=%d", vt_ref,
                 vision.n_patches, model.cfg.hidden_size)
    log.info("loaded model %s (%s) in %.1fs on %s: slots=%d ctx=%d "
             "kv=%s %s; attention: decode=%s prefill=%s", mcfg.name,
             mcfg.model, time.monotonic() - t0, runner.device,
             eng.max_slots, runner.max_ctx,
             "paged" if runner.paged else "contiguous", runner.kv_dtype,
             runner.paged_attn_impl if runner.paged else runner.attn_impl,
             runner.attn_impl)
    return ServingModel(
        name=mcfg.name, config=mcfg, runner=runner, scheduler=scheduler,
        tokenizer=model.tokenizer, templates=TemplateCache(app.model_path),
        vision=vision,
        image_token_id=(mcfg.image_token_id
                        if mcfg.image_token_id is not None
                        else (model.image_token_id or 0)))


class ModelManager:
    """Thread-safe registry of loaded models (loaded on first use, or at
    start for ``preload_models``)."""

    def __init__(self, app: Optional[AppConfig] = None,
                 loader: Optional[ConfigLoader] = None):
        self.app = app or AppConfig()
        self.loader = loader or ConfigLoader(self.app.model_path)
        self._models: dict[str, Any] = {}   # every kind of serving model
        self._reranker_detect: dict[tuple, tuple[bool, float]] = {}
        self._lock = threading.RLock()        # guards _models
        self._load_lock = threading.Lock()    # one load at a time: a load
                                              # holds the card
        self._pool = None                     # WorkerPool, made on demand
        self._watchdog: Optional[_Watchdog] = None
        if self.app.watchdog_idle or self.app.watchdog_busy:
            self._watchdog = _Watchdog(self)
            self._watchdog.start()

    def pool(self):
        """The worker-process pool (``backend: worker``,
        ``external_backends``), made at first use."""
        with self._lock:
            if self._pool is None:
                from localai_tpu_torch.worker.process import WorkerPool

                self._pool = WorkerPool()
            return self._pool

    def loaded_names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def loaded_snapshot(self) -> dict[str, Any]:
        """name → serving model of every loaded model (a copy: the debug
        routes walk it while loads and evictions go on)."""
        with self._lock:
            return dict(self._models)

    def get(self, name: str) -> Any:
        """Load-or-get a text-generation model (a llama engine, the
        recurrent engine or a remote client); a model whose engine died is
        reloaded. Under ``single_active_backend`` the other idle models
        are evicted before a load."""
        return self._get_typed(name, self._load, "llm")

    def get_reranker(self, name: str) -> RerankServingModel:
        """Load-or-get a cross-encoder."""
        return self._get_typed(name, self._load_reranker, "rerank")

    def get_embedder(self, name: str) -> EmbeddingServingModel:
        """Load-or-get a BERT-class sentence encoder."""
        return self._get_typed(name, self._load_embedder, "embed")

    def get_whisper(self, name: str) -> AudioServingModel:
        """Load-or-get a whisper speech-to-text model."""
        return self._get_typed(name, self._load_whisper, "whisper")

    def get_vits(self, name: str) -> AudioServingModel:
        """Load-or-get a VITS voice."""
        return self._get_typed(name, self._load_vits, "vits")

    def get_image(self, name: str) -> ImageServingModel:
        """Load-or-get a diffusion pipeline."""
        return self._get_typed(name, self._load_image, "image")

    def is_embedder(self, mcfg: ModelConfig) -> bool:
        """``/v1/embeddings`` goes to the sentence encoder for
        ``backend: bert-embeddings | sentencetransformers`` (set in the
        YAML or by autodetection)."""
        return mcfg.backend in ("bert-embeddings", "sentencetransformers")

    def is_reranker(self, mcfg: ModelConfig) -> bool:
        """``/v1/rerank`` goes to the cross-encoder for ``backend:
        reranker``, or, with no backend, for a bert-class checkpoint. The
        checkpoint sniff is cached: a hit sticks, a miss expires after
        30 s (a checkpoint installed later is picked up)."""
        if mcfg.backend == "reranker":
            return True
        if mcfg.backend:
            return False
        key = (mcfg.name, mcfg.model)
        now = time.monotonic()
        with self._lock:
            hit = self._reranker_detect.get(key)
        if hit is not None:
            found, at = hit
            if found or now - at < 30.0:
                return found
        from localai_tpu_torch.models.reranker import is_reranker_checkpoint

        found = is_reranker_checkpoint(mcfg.model or mcfg.name,
                                       self.app.model_path)
        with self._lock:
            self._reranker_detect[key] = (found, now)
        return found

    def _get_typed(self, name: str, load, kind: str) -> Any:
        sm = self._cached(name, kind)
        if sm is not None:
            return sm
        with self._load_lock:
            sm = self._cached(name, kind)   # a racing load won?
            if sm is not None:
                return sm
            mcfg = self.loader.get(name)
            if mcfg is None:
                raise KeyError(name)
            if self.app.single_active_backend:
                with self._lock:
                    for other in list(self._models):
                        if not self._models[other].busy:
                            self._evict_locked(other)
            sm = load(mcfg)
            with self._lock:
                self._models[name] = sm
            return sm

    @staticmethod
    def _kind(sm: Any) -> str:
        return ("rerank" if isinstance(sm, RerankServingModel)
                else "embed" if isinstance(sm, EmbeddingServingModel)
                else sm.kind if isinstance(sm, (AudioServingModel,
                                                ImageServingModel))
                else "llm")

    def _cached(self, name: str, kind: str) -> Optional[Any]:
        """The loaded model of that name and kind, alive; a dead one, or
        an idle one of another kind, is evicted (None), a busy one of
        another kind refused."""
        with self._lock:
            sm = self._models.get(name)
            if sm is None:
                return None
            have = self._kind(sm)
            if have != kind:
                if sm.busy:
                    raise RuntimeError(
                        f"model {name!r} is busy serving as {have}")
                log.info("model %s switching to %s; reloading", name, kind)
                self._evict_locked(name)
                return None
            if not sm.alive():
                log.warning("model %s engine died; reloading", name)
                self._evict_locked(name)
                return None
            sm.touch()
            return sm

    def _load(self, mcfg: ModelConfig) -> Any:
        """The JAX package's routing of a text-generation config. With
        ``fleet_replicas`` > 1 (or remote ``fleet_hosts``) an LLM is
        served by a fleet of engine replicas behind one facade
        (``fleet``); models of ``external_backends`` and embeddings- and
        rerank-capable models keep their single-engine paths, as in the
        JAX package (the fleet facade speaks only the generation stream,
        and /v1/embeddings and /v1/rerank need the runner's ``embed``).
        ``backend: worker`` spawns a worker process for the model and an
        ``external_backends`` entry routes it to that worker; a worker
        that fails to spawn or load is an error, never an in-process
        engine."""
        app = self.app
        ext = app.external_backends.get(mcfg.name)
        if ((app.fleet_replicas > 1 or app.fleet_hosts)
                and not ext and mcfg.backend in ("", "worker")):
            if (mcfg.has_usecase("embeddings")
                    or mcfg.has_usecase("rerank")):
                log.warning(
                    "model %s: embeddings/rerank-capable models are not "
                    "fleet-served; keeping the single-engine path",
                    mcfg.name)
            else:
                from localai_tpu_torch.models.registry import resolve_config
                from localai_tpu_torch.parallel.mesh import PART2

                # a topology that was set; the auto mesh is the replica's
                # own (a pinned worker sees one card)
                if mesh_plan(mcfg, app, resolve_config(
                        mcfg.model or mcfg.name, app.model_path),
                        auto=False) is not None:
                    raise ValueError(f"model {mcfg.name}: fleet replicas "
                                     "of a tensor-parallel model are not "
                                     f"ported yet ({PART2})")
                return self._load_fleet(mcfg)
        if ext or mcfg.backend == "worker":
            from localai_tpu_torch.worker.serving import WorkerServingModel

            return WorkerServingModel(mcfg, app, self.pool(),
                                      external_address=ext or None)
        if mcfg.backend in ("huggingface", "langchain-huggingface"):
            from localai_tpu_torch.models.hf_api import HFApiServingModel

            return HFApiServingModel(mcfg, self.app)
        if mcfg.backend in ("mamba", "rwkv"):
            from localai_tpu_torch.models.mamba_serving import (
                MambaServingModel,
            )

            return MambaServingModel(mcfg, self.app)
        return build_serving_model(mcfg, self.app)

    def _load_fleet(self, mcfg: ModelConfig) -> Any:
        """A FleetServingModel: ``fleet_replicas`` decode and
        ``fleet_prefill_replicas`` prefill replicas, plus every remote
        worker of ``fleet_hosts`` (the facade adopts them). ``fleet_backend``
        picks the local replicas' shape: ``worker`` (the default) spawns
        one worker process a replica, its environment the serving
        instance's device under ``worker_env``, with a
        ``CUDA_VISIBLE_DEVICES`` slice each under
        ``fleet_device_pinning``; ``inprocess`` builds each engine here
        with :func:`build_serving_model` under its replica id as its model
        name, so its telemetry does not double-count the fleet's. The
        factory reads the model config from a holder at spawn time, so a
        hot swap's rebinding makes later spawns boot the new
        checkpoint."""
        from localai_tpu_torch.fleet import FleetServingModel
        from localai_tpu_torch.fleet.replica import (
            InProcessReplica,
            WorkerReplica,
        )
        from localai_tpu_torch.worker.process import spawn_env

        app = self.app
        cfg_ref = {"mcfg": mcfg}
        if app.fleet_backend == "inprocess":
            # in-process replicas share this process's card: none of them
            # is auto-meshed over the host's cards
            rapp = dataclasses.replace(app, mesh_shape={"model": 1})

            def factory(rid: str, role: str):
                live = cfg_ref["mcfg"]
                rcfg = dataclasses.replace(live, name=rid,
                                           model=live.model or live.name)
                return InProcessReplica(
                    rid, role, lambda: build_serving_model(rcfg, rapp))
        else:
            total = app.fleet_replicas + app.fleet_prefill_replicas

            def factory(rid: str, role: str):
                env = dict(app.worker_env or {})
                if app.fleet_device_pinning:
                    from localai_tpu_torch.fleet.pinning import (
                        pinned_worker_env,
                    )

                    # ids end in rN (decode) / pN (prefill) in pool order:
                    # prefill replicas take the slices after the decode
                    # block; runtime spawns (autoscale, hot swap) mint
                    # higher indexes, folded back into the boot partition
                    tail = rid.rsplit("/", 1)[-1]
                    idx = int(tail[1:]) + (app.fleet_replicas
                                           if tail[0] == "p" else 0)
                    env = pinned_worker_env(app.worker_env,
                                            idx % max(total, 1),
                                            max(total, 1))
                return WorkerReplica(rid, role, cfg_ref["mcfg"], app,
                                     env=spawn_env(app.device, env))

        fm = FleetServingModel(
            mcfg, app, factory,
            replicas=app.fleet_replicas,
            prefill_replicas=app.fleet_prefill_replicas,
        )
        fm.cfg_ref = cfg_ref
        if app.autoscale:
            from localai_tpu_torch.fleet.autoscale import AutoscaleController

            fm.autoscaler = AutoscaleController(fm, manager=self)
            fm.autoscaler.start()
        return fm

    def _load_reranker(self, mcfg: ModelConfig) -> RerankServingModel:
        from localai_tpu_torch.models.reranker import resolve_reranker

        t0 = time.monotonic()
        enc = resolve_reranker(mcfg.model or mcfg.name,
                               model_path=self.app.model_path,
                               seed=mcfg.seed or 0, device=self.app.device)
        log.info("loaded reranker %s in %.1fs", mcfg.name,
                 time.monotonic() - t0)
        return RerankServingModel(name=mcfg.name, config=mcfg, encoder=enc)

    def _load_embedder(self, mcfg: ModelConfig) -> EmbeddingServingModel:
        from localai_tpu_torch.models.reranker import resolve_sentence_encoder

        t0 = time.monotonic()
        enc = resolve_sentence_encoder(mcfg.model or mcfg.name,
                                       model_path=self.app.model_path,
                                       seed=mcfg.seed or 0,
                                       device=self.app.device)
        log.info("loaded sentence encoder %s in %.1fs", mcfg.name,
                 time.monotonic() - t0)
        return EmbeddingServingModel(name=mcfg.name, config=mcfg,
                                     encoder=enc)

    def _checkpoint_dir(self, ref: str, what: str) -> Path:
        """A checkpoint ref (a path, or a name under the models dir) → its
        directory with a ``config.json``."""
        for cand in (Path(ref), Path(self.app.model_path) / ref):
            if (cand / "config.json").exists():
                return cand
        raise FileNotFoundError(f"{what} model {ref!r} not found")

    def _load_whisper(self, mcfg: ModelConfig) -> AudioServingModel:
        from localai_tpu_torch.models import whisper as wh

        ref = mcfg.model or mcfg.name
        t0 = time.monotonic()
        if ref.startswith("debug:"):
            model = wh.debug_model(mcfg.seed or 0, device=self.app.device)
        else:
            model = wh.load_hf_whisper(self._checkpoint_dir(ref, "whisper"),
                                       device=self.app.device)
        log.info("loaded whisper %s in %.1fs", mcfg.name,
                 time.monotonic() - t0)
        return AudioServingModel(name=mcfg.name, config=mcfg, model=model,
                                 kind="whisper")

    def _load_vits(self, mcfg: ModelConfig) -> AudioServingModel:
        from localai_tpu_torch.audio.vits import load_hf_vits

        ref = mcfg.model or mcfg.name
        t0 = time.monotonic()
        model = load_hf_vits(self._checkpoint_dir(ref, "vits"),
                             device=self.app.device)
        log.info("loaded vits voice %s in %.1fs", mcfg.name,
                 time.monotonic() - t0)
        return AudioServingModel(name=mcfg.name, config=mcfg, model=model,
                                 kind="vits")

    def _load_image(self, mcfg: ModelConfig) -> ImageServingModel:
        """The JAX package's ``_load_image``: the ``diffusers:`` defaults,
        a LoRA merged at load, a ControlNet attached."""
        from localai_tpu_torch.image import resolve_image_model

        kwargs: dict[str, Any] = {}
        d = mcfg.diffusers
        if d.scheduler_type:
            kwargs["default_scheduler"] = d.scheduler_type
        if d.steps:
            kwargs["default_steps"] = d.steps
        if d.cfg_scale is not None:
            kwargs["default_cfg_scale"] = d.cfg_scale
        if d.clip_skip:
            kwargs["clip_skip"] = d.clip_skip
        if mcfg.lora_adapter:
            lp = Path(mcfg.lora_adapter)
            if not lp.is_absolute():
                lp = Path(self.app.model_path) / lp
            kwargs["lora_adapter"] = str(lp)
            kwargs["lora_scale"] = mcfg.lora_scale
        t0 = time.monotonic()
        pipe = resolve_image_model(mcfg.model or mcfg.name,
                                   model_path=self.app.model_path,
                                   device=self.app.device, **kwargs)
        if d.control_net:
            if not hasattr(pipe, "attach_controlnet"):
                # the JAX package fails here with an AttributeError (its
                # FluxPipeline has no attach_controlnet): an intended
                # divergence, named
                raise ValueError(
                    f"model {mcfg.name!r}: a ControlNet (diffusers."
                    "control_net) guides the UNet pipelines only; this "
                    f"is a FLUX-class model ({type(pipe).__name__})")
            pipe.attach_controlnet(d.control_net, self.app.model_path)
        log.info("loaded image model %s in %.1fs", mcfg.name,
                 time.monotonic() - t0)
        return ImageServingModel(name=mcfg.name, config=mcfg, pipeline=pipe)

    def preload(self) -> None:
        """Install, then load, as the JAX package's ``serve`` does: a
        ``preload_models`` name no config has is a model ref (an embedded
        short name, a definition URL, a ``gallery@name`` of the configured
        galleries, a shipped index name), installed into the models dir
        and registered; then ``load_to_memory`` (else ``preload_models``)
        loads. A failed install or load is logged and serving goes on."""
        from localai_tpu_torch.gallery import (
            Gallery,
            install_model,
            resolve_ref,
        )

        galleries = [Gallery(name=g.get("name", ""), url=g.get("url", ""))
                     for g in self.app.galleries]
        for name in self.app.preload_models:
            if self.loader.exists(name):
                continue
            try:
                m = resolve_ref(galleries, name)
                if m is None:
                    log.warning("preload: unknown model ref %r", name)
                    continue
                path = install_model(m, self.app.model_path,
                                     install_name="" if m.url else name)
                self.loader.load_single(
                    path, context_size=self.app.context_size)
            except Exception as e:  # noqa: BLE001
                log.warning("preload of %s failed: %s", name, e)
        for name in self.app.load_to_memory or self.app.preload_models:
            try:
                self._preload(name)
            except Exception as e:  # noqa: BLE001 — keep serving the rest
                log.warning("eager load of %s failed: %s", name, e)

    def _preload(self, name: str) -> None:
        """Load a model as the kind its config routes to: a cross-encoder,
        sentence encoder, whisper model, VITS voice or diffusion pipeline
        through its typed get, else ``get``."""
        mcfg = self.loader.get(name)
        if mcfg is not None and mcfg.backend == "whisper":
            self.get_whisper(name)
        elif mcfg is not None and mcfg.backend == "diffusers":
            self.get_image(name)
        elif mcfg is not None and mcfg.backend == "vits":
            self.get_vits(name)
        elif mcfg is not None and self.is_embedder(mcfg):
            self.get_embedder(name)
        elif mcfg is not None and self.is_reranker(mcfg):
            self.get_reranker(name)
        else:
            self.get(name)

    def _evict_locked(self, name: str) -> None:
        sm = self._models.pop(name, None)
        if sm is not None:
            sm.close()

    def shutdown_model(self, name: str, *, force: bool = False,
                       wait: float = 30.0) -> bool:
        """Stop one model, after its in-flight work unless forced."""
        deadline = time.monotonic() + wait
        while not force:
            with self._lock:
                sm = self._models.get(name)
                if sm is None:
                    return False
                if not sm.busy:
                    break
            if time.monotonic() > deadline:
                log.warning("%s still busy after %.0fs; forcing", name, wait)
                break
            time.sleep(0.1)
        with self._lock:
            if name not in self._models:
                return False
            self._evict_locked(name)
            return True

    # -- observability -----------------------------------------------------

    def metrics(self) -> dict:
        """Each loaded model's ``engine_metrics()`` (host reads)."""
        with self._lock:
            models = list(self._models.items())
        return {name: sm.engine_metrics() for name, sm in models}

    def monitor(self, name: str) -> dict:
        """One model's status (the JAX package's ``monitor``)."""
        with self._lock:
            sm = self._models.get(name)
        if sm is None:
            return {"loaded": False, "name": name}
        return {
            "loaded": True,
            "name": name,
            "busy": sm.busy,
            "age_seconds": time.monotonic() - sm.loaded_at,
            "idle_seconds": time.monotonic() - sm.last_used,
            **sm.engine_metrics(),
        }

    def shutdown(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
        with self._lock:
            models, self._models = list(self._models.values()), {}
            pool, self._pool = self._pool, None
        for sm in models:
            sm.close()
        if pool is not None:
            pool.shutdown_all()
        # the tensor-parallel group's followers exit with the channel
        from localai_tpu_torch.parallel import multihost as mh

        mh.close_group()


class _Watchdog(threading.Thread):
    """Every ``INTERVAL`` seconds: evict a model idle longer than
    ``watchdog_idle_timeout`` (``watchdog_idle``), and cancel a request
    running longer than ``watchdog_busy_timeout`` (``watchdog_busy``)."""

    INTERVAL = 5.0

    def __init__(self, manager: ModelManager):
        super().__init__(name="watchdog", daemon=True)
        self.manager = manager
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        app = self.manager.app
        while not self._halt.wait(self.INTERVAL):
            now = time.monotonic()
            with self.manager._lock:
                items = list(self.manager._models.items())
            for name, sm in items:
                if (app.watchdog_idle and not sm.busy
                        and now - sm.last_used > app.watchdog_idle_timeout):
                    log.info("watchdog: evicting idle model %s", name)
                    self.manager.shutdown_model(name, force=True)
                elif app.watchdog_busy and sm.busy:
                    self._cancel_stuck(sm)

    def _cancel_stuck(self, sm: Any) -> None:
        """Cancel a llama engine's requests older than the busy timeout;
        as in the JAX package, the other kinds are left to finish (the
        recurrent and remote ones serve one request a thread)."""
        if not isinstance(sm, ServingModel):
            return
        timeout = self.manager.app.watchdog_busy_timeout
        for handle in sm.scheduler.handles_older_than(timeout):
            log.warning("watchdog: cancelling stuck request %d (>%ds)",
                        handle.id, int(timeout))
            handle.cancel()
