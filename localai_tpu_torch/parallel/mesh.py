"""Mesh plans, axis conventions and the process group a rank joins.

Port of ``localai_tpu/parallel/mesh.py``. ``AXES``, :class:`MeshPlan`,
:func:`plan_from_sharding_config`, :func:`parse_mesh_spec` and
:func:`default_tensor_parallel` are the JAX package's. A JAX mesh is one
program over every device; on PyTorch a meshed engine is one process a
rank, so :func:`build_mesh` gives a :class:`Mesh`: the axis sizes, this
process's rank, the world size, one process group per sharded axis (the
ranks that differ only in that axis; ranks are laid out in ``AXES``
order, ``model`` fastest, as a JAX mesh lays out its devices) and this
rank's ``torch.device``.

:func:`initialize` joins the group over a TCP store
(``tcp://<coordinator>``). Rank 0 hosts the store; given port 0 it binds
a free port itself and reports it (``on_bound``, :func:`bound_port`), so
no port is picked by one process and bound by another. The transport is
a rule stated at startup, not a fallback after an error: NCCL when every
rank holds a card of its own, gloo on CUDA tensors when two ranks share a
card (NCCL refuses two ranks on one device; the ranks compare their
cards' UUIDs through the store), gloo on the CPU. A collective that fails
raises; nothing retries it on another backend.

The ``model``, ``seq`` and ``pipe`` axes are served (``seq`` with
``model``; ``pipe`` alone, as the JAX runner gates it); a plan that
shards ``data`` or ``expert`` is refused by :func:`refuse_part2`.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import logging
import math
import os
import time
import weakref
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)

AXES = ("data", "seq", "pipe", "expert", "model")
PART2 = ("ROADMAP item 19 part 2: the data and expert axes; the port "
         "serves the model, seq and pipe axes")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Validated logical mesh shape. Product must equal the device count."""

    data: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    model: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.seq, self.pipe, self.expert, self.model)

    def size(self) -> int:
        return math.prod(self.shape)


def device_count() -> int:
    """The cards this host shows (``torch.cuda.device_count()``)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def plan_from_sharding_config(
    tensor_parallel_size: int = 1,
    data_parallel_size: int = 0,
    sequence_parallel_size: int = 1,
    expert_parallel_size: int = 1,
    pipeline_parallel_size: int = 1,
    n_devices: Optional[int] = None,
) -> MeshPlan:
    """Turn ShardingConfig knobs into a concrete MeshPlan, as the JAX
    package does; ``data_parallel_size=0`` fills the devices that remain.
    ``n_devices`` defaults to this host's cards."""
    nd = n_devices if n_devices is not None else device_count()
    fixed = (tensor_parallel_size * sequence_parallel_size
             * expert_parallel_size * pipeline_parallel_size)
    if nd % fixed != 0:
        raise ValueError(
            f"device count {nd} not divisible by tp*sp*ep*pp={fixed}")
    dp = data_parallel_size or nd // fixed
    plan = MeshPlan(data=dp, seq=sequence_parallel_size,
                    pipe=pipeline_parallel_size,
                    expert=expert_parallel_size,
                    model=tensor_parallel_size)
    if plan.size() != nd:
        raise ValueError(
            f"mesh {plan.shape} (={plan.size()}) != device count {nd}")
    return plan


def parse_mesh_spec(spec: str) -> Optional[dict]:
    """``"data=2,model=4"`` (or ``data:2,model:4``) → axis dict for
    MeshPlan: the one parser behind ``--mesh`` and ``LOCALAI_MESH``.
    Unknown axes raise."""
    if not spec:
        return None
    out: dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        sep = "=" if "=" in part else ":"
        k, _, v = part.partition(sep)
        k = k.strip()
        if k not in AXES:
            raise ValueError(
                f"unknown mesh axis {k!r} in {spec!r}; have {AXES}")
        out[k] = int(v)
    return out or None


def default_tensor_parallel(n_devices: int, num_heads: int) -> int:
    """The auto-mesh TP width for one host: all visible devices when the
    q-head count allows, otherwise the widest divisor of the device count
    that splits the heads evenly; 1 when no split works."""
    for tp in range(min(n_devices, num_heads), 0, -1):
        if n_devices % tp == 0 and num_heads % tp == 0:
            return tp
    return 1


def refuse_part2(plan: MeshPlan, where: str) -> None:
    """Raise ``ValueError`` naming ROADMAP item 19 part 2 when ``plan``
    shards ``data`` or ``expert``."""
    busy = [ax for ax in ("data", "expert") if getattr(plan, ax) > 1]
    if busy:
        raise ValueError(f"{where}: mesh axes {busy} are not ported yet "
                         f"({PART2})")


def check_pipe(plan: MeshPlan) -> None:
    """The JAX runner's gate: ``pipe`` composes with no other axis."""
    busy = [ax for ax in ("data", "model", "seq", "expert")
            if getattr(plan, ax) > 1]
    if plan.pipe > 1 and busy:
        raise ValueError(f"pipeline parallelism composes with no other "
                         f"axis yet; mesh also shards {busy}")


def spec_of(plan: MeshPlan) -> str:
    """``plan`` as a ``--mesh`` value (its sharded axes; ``model=1`` for a
    plan of one)."""
    return ",".join(f"{ax}={getattr(plan, ax)}" for ax in AXES
                    if getattr(plan, ax) > 1) or "model=1"


def axis_coords(plan: MeshPlan, rank: int) -> dict[str, int]:
    """Each axis's index of ``rank`` (``AXES`` order, ``model``
    fastest)."""
    out, rest = {}, rank
    for ax, size in reversed(list(zip(AXES, plan.shape))):
        out[ax] = rest % size
        rest //= size
    return {ax: out[ax] for ax in AXES}


def axis_ranks(plan: MeshPlan, rank: int, ax: str) -> list[int]:
    """The global ranks of ``rank``'s ``ax`` group, in axis order: the
    ranks that differ from it in ``ax`` alone."""
    sizes = dict(zip(AXES, plan.shape))
    stride = math.prod(sizes[a] for a in AXES[AXES.index(ax) + 1:])
    base = rank - axis_coords(plan, rank)[ax] * stride
    return [base + i * stride for i in range(sizes[ax])]


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh: the plan, this process's rank in the
    joined group, the group's size, the ``model`` axis's process group
    (``group``: the tensor-parallel reductions' and gathers'), every
    sharded axis's (``groups``; both empty for a mesh of one, or a mesh
    built to compute specs) and this rank's device. :func:`destroy`
    empties both on every mesh :func:`build_mesh` gave, so no process
    group outlives the group it belongs to."""

    plan: MeshPlan
    rank: int = 0
    world: int = 1
    group: Any = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: str = ""
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name (the JAX ``Mesh.shape``)."""
        return dict(zip(AXES, self.plan.shape))

    @property
    def tp(self) -> int:
        return self.plan.model

    @property
    def n_devices(self) -> int:
        return self.world

    def axis_size(self, ax: str) -> int:
        return self.shape[ax]

    def axis_rank(self, ax: str) -> int:
        """This rank's index along ``ax``."""
        return axis_coords(self.plan, self.rank)[ax]

    def axis_ranks(self, ax: str) -> list[int]:
        """The global ranks of this rank's ``ax`` group, in axis order."""
        return axis_ranks(self.plan, self.rank, ax)

    @classmethod
    def abstract(cls, plan: MeshPlan, rank: int = 0) -> "Mesh":
        """A mesh with no group: for computing specs and slices (the rank
        as given), never for collectives."""
        return cls(plan, rank=rank, world=plan.size())


def build_mesh(plan: Optional[MeshPlan] = None,
               device: str | torch.device | None = None) -> Mesh:
    """This process's :class:`Mesh` over the joined group (``plan``
    defaults to ``MeshPlan(model=world)``): the plan's size must be the
    group's, and each sharded axis gets its process group (the world's own
    where the axis spans it; every rank creates every group, in one
    order). Without a joined group only a plan of one device is valid."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if plan is None:
        plan = MeshPlan(model=world)
    refuse_part2(plan, "mesh")
    check_pipe(plan)
    if plan.size() != world:
        raise ValueError(f"mesh {spec_of(plan)} needs a group of "
                         f"{plan.size()} ranks; this process's group has "
                         f"{world}")
    dev = torch.device(device if device is not None else _JOINED["device"]
                       or "cpu")
    rank = dist.get_rank() if joined else 0
    groups = dict(_axis_groups(plan, rank)) if joined else {}
    mesh = Mesh(plan, rank=rank, world=world, group=groups.get("model"),
                device=dev, backend=_JOINED["backend"], groups=groups)
    _MESHES.add(mesh)
    return mesh


def _axis_groups(plan: MeshPlan, rank: int) -> dict:
    """This rank's process group of every sharded axis of ``plan``, made
    once a plan and kept until :func:`destroy`."""
    import torch.distributed as dist

    key = plan.shape
    if key not in _JOINED["groups"]:
        mine = {}
        for ax, size in zip(AXES, plan.shape):
            if size == 1:
                continue
            if size == plan.size():
                mine[ax] = dist.group.WORLD
                continue
            # new_group is collective: every rank creates every group of
            # the axis, in rank order, and keeps its own
            seen = set()
            for r in range(plan.size()):
                ranks = axis_ranks(plan, r, ax)
                if ranks[0] in seen:
                    continue
                seen.add(ranks[0])
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[ax] = g
        _JOINED["groups"][key] = mine
    return _JOINED["groups"][key]


# what initialize() recorded about this process's group
_JOINED: dict = {"device": None, "backend": "", "port": 0, "groups": {}}
# every mesh build_mesh gave (weakly): destroy() takes their groups away
_MESHES: "weakref.WeakSet[Mesh]" = weakref.WeakSet()


def bound_port() -> int:
    """The port of the store this process hosts as rank 0 (0 before
    :func:`initialize` bound it)."""
    return _JOINED["port"]


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """A rank's device on one host: ``cpu`` stays; an unindexed ``cuda``
    takes card ``rank`` modulo the cards shown (ranks share cards when
    there are fewer cards than ranks)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = max(1, device_count())
    return torch.device("cuda", rank % n)


def timeout_s() -> float:
    """``LOCALAI_MESH_TIMEOUT_S`` (default 300): how long the ranks may
    take to join, a follower to load and connect, and a collective to
    complete."""
    try:
        return max(1.0, float(
            os.environ.get("LOCALAI_MESH_TIMEOUT_S", "") or 300))
    except ValueError:
        return 300.0


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str | torch.device = "cuda", alive=None,
               on_bound=None) -> str:
    """Join the group of ``num_processes`` ranks as ``process_id`` over a
    TCP store at ``coordinator`` (``host:port``; rank 0 hosts it), on
    ``device``; returns the backend. Rank 0 given port 0 binds a free
    port itself: ``on_bound(port)`` (optional) is called with it once the
    store listens, before the ranks gather, to start or tell the others,
    and :func:`bound_port` keeps it. ``alive`` (optional, rank 0) is
    polled while the ranks gather: it raises when a rank it started has
    died, so a dead follower fails the join at once instead of at the
    timeout (:func:`timeout_s`, which bounds the collectives too)."""
    import torch.distributed as dist

    host, _, port = coordinator.rpartition(":")
    if int(port) == 0 and process_id != 0:
        raise ValueError(f"rank {process_id} needs the store's port; "
                         f"{coordinator} names none")
    join_timeout = timeout_s()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=join_timeout),
                          wait_for_workers=False)
    if process_id == 0:
        _JOINED["port"] = store.port
        if on_bound is not None:
            on_bound(store.port)
    ident = (str(torch.cuda.get_device_properties(dev).uuid)
             if dev.type == "cuda" else f"cpu:{process_id}")
    store.set(f"localai/card/{process_id}", ident)
    keys = [f"localai/card/{r}" for r in range(num_processes)]
    deadline = time.monotonic() + join_timeout
    while not store.check(keys):
        if alive is not None:
            alive()
        if time.monotonic() > deadline:
            raise TimeoutError(f"only some of {num_processes} ranks joined "
                               f"{host or '127.0.0.1'}:{store.port} in "
                               f"{join_timeout:.0f}s")
        time.sleep(0.05)
    cards = [store.get(k).decode() for k in keys]
    if dev.type != "cuda":
        backend = "gloo"
    elif len(set(cards)) < num_processes:
        backend = "gloo"
        log.warning(
            "tensor parallelism: ranks share a card (%d ranks on %d "
            "cards); NCCL takes one rank a device, so the collectives go "
            "over gloo on CUDA tensors", num_processes, len(set(cards)))
    else:
        backend = "nccl"
    dist.init_process_group(
        backend, store=store, rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=join_timeout))
    _JOINED.update(device=str(dev), backend=backend)
    log.info("mesh group up: rank %d/%d on %s over %s",
             process_id, num_processes, dev, backend)
    return backend


def destroy() -> None:
    """Leave the group (a no-op when none was joined) and drop every
    reference this package holds to its process groups. A process group
    freed only at interpreter exit, after a peer rank has gone, can end
    the process in ``std::terminate`` (gloo), so each is freed here: the
    meshes' groups are emptied and the objects collected."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    for mesh in list(_MESHES):
        mesh.group, mesh.groups = None, {}
    _JOINED.update(device=None, backend="", port=0, groups={})
    gc.collect()
