"""Tensor parallelism on ``torch.distributed``: one process a rank.

``mesh`` (plans, the group a process joins), ``sharding`` (which slice of
which tensor a rank keeps), ``overlap`` (the row-parallel reduction and
the vocab-parallel embedding) and ``multihost`` (the leader's command
mirroring, the followers that replay it, and the spawned single-host
group). Only the ``model`` axis is served; ``data``, ``seq``, ``pipe`` and
``expert`` are refused by name (ROADMAP item 19 part 2).
"""
