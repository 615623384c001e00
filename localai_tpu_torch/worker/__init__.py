"""The worker tier's transport-free parts (``serving``: the request
options, the stream-fed handle and its reader; ``server``: options →
engine request). Fleets run them over in-process replicas; the worker
process, its client and the gRPC servicers wait for the port's own
transport (ROADMAP item 23, part 2)."""
