"""Deterministic fault injection + self-healing supervision.

Port of ``localai_tpu/faults``. ``faults.registry`` is the injection
registry: named points in the serving stack check it (behind a
module-global ``ACTIVE`` flag that is False in production, so a disarmed
build pays one attribute load — no env lookups, no per-dispatch
allocation) and fail on purpose when a matching :class:`FaultSpec` is
armed. ``faults.supervisor`` closes the detect→recover loop the obs
subsystem only observes: a watchdog stall on an engine channel escalates
from trace-dump to a bounded, backed-off engine rebuild, and past the
bound the model is marked failed.

Armed via ``LOCALAI_FAULT_*`` environment variables at boot
(:func:`install_from_env`) or the ``/debug/faults`` endpoint at runtime.
"""

from localai_tpu_torch.faults.registry import (  # noqa: F401
    SITES,
    FaultInjected,
    FaultSpec,
    active,
    apply,
    arm,
    clear,
    fire,
    install_from_env,
    parse_spec,
    snapshot,
)
from localai_tpu_torch.faults.supervisor import EngineSupervisor  # noqa: F401
