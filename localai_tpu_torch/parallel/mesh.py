"""Mesh plans, axis conventions and the process group a rank joins.

Port of ``localai_tpu/parallel/mesh.py``. ``AXES``, :class:`MeshPlan`,
:func:`plan_from_sharding_config`, :func:`parse_mesh_spec` and
:func:`default_tensor_parallel` are the JAX package's. A JAX mesh is one
program over every device; on PyTorch a tensor-parallel engine is one
process a card, so :func:`build_mesh` gives a :class:`Mesh`: the axis
sizes, this process's rank, the world size, the ``model`` process group
and this rank's ``torch.device``.

:func:`initialize` joins the group over a TCP store
(``tcp://<coordinator>``). The transport is a rule stated at startup, not
a fallback after an error: NCCL when every rank holds a card of its own,
gloo on CUDA tensors when two ranks share a card (NCCL refuses two ranks
on one device; the ranks compare their cards' UUIDs through the store),
gloo on the CPU. A collective that fails raises; nothing retries it on
another backend.

Only the ``model`` axis is served; a plan that shards ``data``, ``seq``,
``pipe`` or ``expert`` is refused by :func:`refuse_part2`.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import time
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)

AXES = ("data", "seq", "pipe", "expert", "model")
PART2 = ("ROADMAP item 19 part 2: the data, seq, pipe and expert axes; "
         "the port serves the model axis alone")


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
    shards any axis but ``model``."""
    busy = [ax for ax in AXES[:-1] if getattr(plan, ax) > 1]
    if busy:
        raise ValueError(f"{where}: mesh axes {busy} are not ported yet "
                         f"({PART2})")


@dataclasses.dataclass
class Mesh:
    """One rank's view of a ``model``-axis mesh: the plan, this process's
    rank in the group, the group's size, the process group (None for a
    mesh of one, or a mesh built to compute specs) and this rank's
    device."""

    plan: MeshPlan
    rank: int = 0
    world: int = 1
    group: Any = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: str = ""

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

    @classmethod
    def abstract(cls, plan: MeshPlan, rank: int = 0) -> "Mesh":
        """A mesh with no group: for computing specs and slices (the rank
        as given), never for collectives."""
        return cls(plan, rank=rank, world=plan.size())


def build_mesh(plan: Optional[MeshPlan] = None,
               device: str | torch.device | None = None) -> Mesh:
    """This process's :class:`Mesh` over the joined group: the ``model``
    axis spans the group's ranks (``plan`` defaults to
    ``MeshPlan(model=world)``). Without a joined group only a plan of one
    device is valid."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if plan is None:
        plan = MeshPlan(model=world)
    refuse_part2(plan, "mesh")
    if plan.model != world:
        raise ValueError(f"mesh model={plan.model} needs a group of "
                         f"{plan.model} ranks; this process's group has "
                         f"{world}")
    dev = torch.device(device if device is not None else _JOINED["device"]
                       or "cpu")
    return Mesh(plan, rank=dist.get_rank() if joined else 0, world=world,
                group=dist.group.WORLD if joined else None, device=dev,
                backend=_JOINED["backend"])


# what initialize() recorded about this process's group
_JOINED: dict = {"device": None, "backend": ""}


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
               device: str | torch.device = "cuda", alive=None) -> str:
    """Join the group of ``num_processes`` ranks as ``process_id`` over a
    TCP store at ``coordinator`` (``host:port``; rank 0 hosts it), on
    ``device``; returns the backend. ``alive`` (optional, rank 0) is
    polled while the ranks gather: it raises when a rank it started has
    died, so a dead follower fails the join at once instead of at the
    timeout (:func:`timeout_s`, which bounds the collectives too)."""
    import torch.distributed as dist

    host, _, port = coordinator.rpartition(":")
    join_timeout = timeout_s()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=join_timeout),
                          wait_for_workers=False)
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
                               f"{coordinator} in {join_timeout:.0f}s")
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
    log.info("tensor-parallel group up: rank %d/%d on %s over %s",
             process_id, num_processes, dev, backend)
    return backend


def destroy() -> None:
    """Leave the group (a no-op when none was joined)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _JOINED.update(device=None, backend="")
