"""Multi-GPU serving on ``torch.distributed``: one process a rank.

``mesh`` (plans, the group a process joins, one process group per
axis), ``sharding`` (which slice of which tensor a rank keeps),
``overlap`` (the row-parallel reduction, the vocab-parallel embedding and
the point-to-point hops), ``ring`` (sequence-parallel prefill by ring
attention), ``pipeline`` (layer stages) and ``multihost`` (the leader's
command mirroring, the followers that replay it, and the spawned
single-host group). The ``model``, ``seq`` and ``pipe`` axes are served;
``data`` and ``expert`` are refused by name (ROADMAP item 19 part 2).
"""
