"""Command mirroring: one leader, follower ranks that replay its calls.

Port of ``localai_tpu/parallel/multihost.py``. A tensor-parallel engine on
PyTorch is one process a rank, each holding its weight slices, and every
rank must run the SAME forwards in the SAME order so that their
collectives line up. Requests reach only the leader (rank 0), so the
leader re-broadcasts every engine call that changes state or dispatches a
program over a TCP command channel (:class:`MirroredRunner`), and each
follower replays it on its own runner (:class:`CommandFollower`). The
wire is the JAX package's: a 4-byte big-endian length, then a JSON object
``{"model", "m", "a", "k"}`` with numpy arrays as base64 ``.npy``
(:func:`_pack`, :func:`_encode_arg`), after a peer-token handshake. Two
control calls extend it: ``__load__`` (build model ``model`` from the
follower's models dir, when the leader loads a meshed model the follower
was not started with) and ``__drop__`` (free it). After each mirrored
call the leader sends ``__outcome__``: the name of the exception its own
call raised, or "". A follower whose replay ended otherwise (it raised
where the leader did not, or the reverse, or another error) has left the
leader's state: it raises and exits, and the leader, which has lost a
rank, fails the engine. Where the follower's replay raised, it waits for
the leader's outcome at most ``min(30 s, LOCALAI_MESH_TIMEOUT_S)``: a
leader that did not raise waits in a collective for this rank.

Every rank samples from the same gathered logits with the same per-slot
generators, so the followers' tokens equal the leader's: both sides fold
each call's sampled tokens into a digest (:class:`TokenDigest`), and a
follower's stop report carries its digest beside its launch counts. The
leader keeps a call lock: a call is broadcast and run locally under it,
so the HTTP threads' ``embed`` never interleaves its collectives with the
engine thread's.

On one host the leader spawns the other ranks of the mesh itself
(:func:`ensure_group`): ``cli.main follower`` processes with the serving
instance's models dir and the mesh plan (``LOCALAI_MESH``), each
``LOCALAI_DEVICE`` its rank's card (as a worker's,
``worker.process.spawn_env``), started once the leader's store listens
on the port it bound (so no other process can take the port between
its choice and its use), and it waits until every rank has joined the
group and the channel. A process serves one group, keyed by its mesh
plan: a model that asks for another plan, even of the same width, is
refused naming both. A follower that fails to start,
load or join fails the load; a follower lost later fails the engine (the
next call raises). When the channel closes, a follower prints its
``FOLLOWER_REPORT {json}`` line (its launch counts and, a model, its
counters, weight bytes and token digest) and exits 0 at once, freeing
its card memory (it does not wait in a group teardown that NCCL would
hold until every rank tore down).
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import logging
import os
import secrets
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from localai_tpu_torch.parallel import mesh as pmesh

log = logging.getLogger(__name__)

REPORT_PREFIX = "FOLLOWER_REPORT "


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str | torch.device = "cuda", **kw) -> str:
    """Join the tensor-parallel group (``mesh.initialize``): rank
    ``process_id`` of ``num_processes`` over ``tcp://<coordinator>``."""
    return pmesh.initialize(coordinator, num_processes, process_id,
                            device, **kw)


# ---------------------------------------------------------------------------
# command channel


def _pack(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode()
    return struct.pack(">I", len(body)) + body


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("command channel closed")
        buf += chunk
    return buf


def _encode_arg(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray) or (
        hasattr(v, "__array__") and not isinstance(v, (int, float, bool))
        and not isinstance(v, (list, tuple, str, dict))
    ):
        bio = io.BytesIO()
        np.save(bio, np.asarray(v), allow_pickle=False)
        return {"__np__": base64.b64encode(bio.getvalue()).decode()}
    return v


def _decode_arg(v: Any) -> Any:
    if isinstance(v, dict) and "__np__" in v:
        return np.load(io.BytesIO(base64.b64decode(v["__np__"])),
                       allow_pickle=False)
    return v


OUTCOME = "__outcome__"


def _frame(model: str, method: str, args, kwargs) -> bytes:
    return _pack({
        "model": model,
        "m": method,
        "a": [_encode_arg(a) for a in args],
        "k": {k: _encode_arg(v) for k, v in kwargs.items()},
    })


class CommandLeader:
    """Accepts follower connections and broadcasts every command in issue
    order; joining takes the group's ``token``. ``call_lock`` serializes
    the mirrored calls of every model on this channel (broadcast, then the
    local call)."""

    def __init__(self, port: int = 0, expected: int = 0, token: str = "",
                 host: str = "0.0.0.0"):
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.call_lock = threading.RLock()
        self.token = token
        self.expected = expected
        # set (a message) when the group lost a rank: every later call fails
        self.dead = ""
        self._accepting = threading.Thread(
            target=self._accept_loop, daemon=True, name="mh-accept")
        self._accepting.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._admit, args=(conn, addr),
                             daemon=True, name="mh-handshake").start()

    def _admit(self, conn: socket.socket, addr) -> None:
        try:
            self._handshake(conn)
        except Exception as e:  # noqa: BLE001 — reject, keep serving
            log.warning("multihost: rejected connection from %s (%s)",
                        addr, e)
            conn.close()
            return
        with self._lock:
            self._conns.append(conn)
            n = len(self._conns)
        log.info("multihost: follower %s joined (%d connected)", addr, n)

    def _handshake(self, conn: socket.socket) -> None:
        import hmac

        conn.settimeout(10.0)
        (length,) = struct.unpack(">I", _read_exact(conn, 4))
        if length > 4096:
            raise ValueError("oversized handshake")
        hello = json.loads(_read_exact(conn, length))
        offered = str(hello.get("token", ""))
        if self.token and not hmac.compare_digest(offered, self.token):
            conn.sendall(_pack({"ok": False, "error": "bad token"}))
            raise PermissionError("bad peer token")
        conn.sendall(_pack({"ok": True}))
        conn.settimeout(None)

    @property
    def connected(self) -> int:
        with self._lock:
            return len(self._conns)

    def wait_for(self, n: int, timeout: float = 120.0,
                 alive: Optional[Callable[[], None]] = None) -> None:
        """Block until ``n`` followers joined; ``alive`` (optional) raises
        when a follower this process started has died."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.connected >= n:
                return
            if alive is not None:
                alive()
            time.sleep(0.05)
        raise TimeoutError(f"only {self.connected} followers joined")

    def broadcast(self, model: str, method: str, *args, **kwargs) -> None:
        if self.dead:
            raise RuntimeError(f"tensor-parallel group lost a rank "
                               f"({self.dead}); reload the model")
        msg = _frame(model, method, args, kwargs)
        with self._lock:
            dead = []
            for conn in self._conns:
                try:
                    conn.sendall(msg)
                except OSError as e:
                    log.error("multihost: follower lost (%s)", e)
                    dead.append(conn)
            for conn in dead:
                self._conns.remove(conn)
            if dead and self.expected:
                self.dead = "a follower's channel closed"
                raise RuntimeError(
                    "multihost follower disconnected; restart the group")

    def close(self) -> None:
        self._srv.close()
        with self._lock:
            for conn in self._conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()
            self._conns.clear()


class TokenDigest:
    """A running SHA-256 over the sampled tokens of mirrored calls, in
    call order: ints, arrays, and asynchronous results (folded once they
    are on the host, in order; :meth:`hexdigest` waits for the rest)."""

    def __init__(self):
        self._h = hashlib.sha256()
        self._pending: list = []
        self.results = 0
        self._lock = threading.Lock()

    def add(self, out: Any) -> None:
        if out is None or isinstance(out, (float, str, bool)):
            return
        if not isinstance(out, (int, np.integer, np.ndarray)) and \
                not hasattr(out, "ready"):
            return
        with self._lock:
            self._pending.append(out)
            self._fold(block=False)

    def _fold(self, block: bool) -> None:
        while self._pending:
            head = self._pending[0]
            if not block and hasattr(head, "ready") and not head.ready():
                return
            self._pending.pop(0)
            a = np.asarray(head, dtype=np.int64).reshape(-1)
            self._h.update(a.tobytes())
            self.results += 1

    def hexdigest(self) -> str:
        with self._lock:
            self._fold(block=True)
            return self._h.hexdigest()


class CommandFollower:
    """Connects to the leader and replays commands onto its targets (keyed
    by model name) until the channel closes. ``loader(name)`` builds a
    target for ``__load__``."""

    def __init__(self, leader: str, targets: dict[str, Any],
                 connect_timeout: float = 120.0, token: str = "",
                 loader: Optional[Callable[[str], dict]] = None):
        host, _, port = leader.rpartition(":")
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=10.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(1.0)
        self._sock.sendall(_pack({"token": token}))
        (length,) = struct.unpack(">I", _read_exact(self._sock, 4))
        verdict = json.loads(_read_exact(self._sock, length))
        if not verdict.get("ok"):
            self._sock.close()
            raise PermissionError(
                f"leader rejected follower: {verdict.get('error')}")
        self._sock.settimeout(None)
        self.targets = targets
        self.loader = loader
        self.replayed = 0
        # replays that raised as the leader's call did
        self.errors = 0
        # (call, exception type or "") of the last replay, until the
        # leader's outcome of it arrives
        self._last: Optional[tuple[str, str]] = None
        # the replay reports of dropped targets (report() of the rest)
        self.reports: dict[str, dict] = {}

    def report(self) -> dict:
        """Every target's replay report, dropped ones included."""
        return {**self.reports,
                **{k: t.report() for k, t in self.targets.items()}}

    def run_forever(self) -> None:
        try:
            while True:
                self.step()
        except ConnectionError:
            log.info("multihost: leader channel closed; follower exiting")

    def _read(self) -> dict:
        (length,) = struct.unpack(">I", _read_exact(self._sock, 4))
        return json.loads(_read_exact(self._sock, length))

    def step(self) -> None:
        """Apply exactly one mirrored command (or check the leader's
        outcome of the last one)."""
        msg = self._read()
        name, method = msg["model"], msg["m"]
        if method == OUTCOME:
            self._check_outcome(msg)
            return
        if method == "__load__":
            if name not in self.targets:
                if self.loader is None:
                    raise RuntimeError(f"follower cannot load {name!r}")
                try:
                    self.targets.update(self.loader(name))
                except Exception as e:  # noqa: BLE001 — as the leader's
                    # load of the same config fails the same way
                    self.errors += 1
                    log.warning("multihost: loading %s failed: %s", name, e)
            return
        if method == "__drop__":
            for key in [k for k in self.targets
                        if k == name or k.startswith(name + "#")]:
                target = self.targets.pop(key)
                self.reports[key] = target.report()
                target.close()
            return
        target = self.targets.get(name)
        if target is None:
            # every rank must run every program or collectives desync
            raise RuntimeError(
                f"follower has no replica of model {name!r}")
        args = [_decode_arg(a) for a in msg["a"]]
        kwargs = {k: _decode_arg(v) for k, v in msg["k"].items()}
        self.replayed += 1
        self._last = (f"{name}.{method}", "")
        try:
            getattr(target, method)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — held to the leader's
            self._last = (f"{name}.{method}", type(e).__name__)
            log.warning("multihost: replayed %s.%s raised %r", name,
                        method, e)
            # the leader's outcome must come now: a leader whose call did
            # not raise waits in a collective for this rank
            self._sock.settimeout(min(30.0, pmesh.timeout_s()))
            try:
                nxt = self._read()
            except TimeoutError:
                raise RuntimeError(
                    f"replayed {name}.{method} raised {e!r} on this rank "
                    "and the leader did not report the same: the ranks "
                    "diverged") from e
            finally:
                self._sock.settimeout(None)
            if nxt.get("m") != OUTCOME:
                raise RuntimeError(
                    f"replayed {name}.{method} raised {e!r} on this rank "
                    "and the leader went on: the ranks diverged") from e
            self._check_outcome(nxt)
            self.errors += 1

    def _check_outcome(self, msg: dict) -> None:
        """Hold the last replay's outcome to the leader's: the same
        exception type, or none on both."""
        want = msg["a"][0] if msg.get("a") else ""
        call, got = self._last or ("", "")
        self._last = None
        if got != want:
            raise RuntimeError(
                f"replayed {call or msg['model']} "
                f"{'raised ' + got if got else 'returned'} on this rank but "
                f"{'raised ' + want if want else 'returned'} on the leader: "
                "the ranks diverged")

    def close(self) -> None:
        self._sock.close()


_leader_singleton: Optional[CommandLeader] = None
_leader_lock = threading.Lock()


def get_leader(port: int, expected: int = 0,
               token: str = "") -> CommandLeader:
    """Process-wide command channel (every mirrored model shares it; the
    model name in each message routes the replay)."""
    global _leader_singleton
    with _leader_lock:
        if _leader_singleton is None:
            _leader_singleton = CommandLeader(port, expected=expected,
                                              token=token)
        return _leader_singleton


# methods whose device effects must replay on every rank: every call
# through which the scheduler and the spec engine change state or
# dispatch a program (the leader's return values never cross the channel)
MIRRORED = (
    "admit", "step", "step_n", "step_async", "step_n_async",
    "step_frozen_n", "set_bias", "release", "acquire_slot", "embed",
    "begin_admit", "verify_async", "reinit", "load_block", "load_prefix",
    "prompt_logits",
)
# the PagedAdmission calls (routed by slot on the follower)
ADMISSION = ("step_chunk", "abort")
# a draft model's drafter (spec.drafter.ModelDrafter), mirrored as
# "<model>#draft"
DRAFT_MIRRORED = ("propose", "admit", "resync", "acquire_slot", "release",
                  "reinit")
# results folded into the token digest
_TOKEN_RESULTS = ("admit", "step", "step_n", "step_async", "step_n_async",
                  "step_frozen_n", "verify_async", "step_chunk")


class MirroredRunner:
    """Leader-side proxy: broadcast each mirrored call to the followers,
    then apply it locally, under the channel's call lock. Reads pass
    through. ``begin_admit``'s admission comes back wrapped so that its
    ``step_chunk`` and ``abort`` are mirrored too."""

    def __init__(self, runner: Any, leader: CommandLeader, model: str,
                 methods: tuple = MIRRORED):
        self._runner = runner
        self._leader = leader
        self._model = model
        self._methods = methods
        self.digest = TokenDigest()
        self.calls = 0

    def __getattr__(self, name: str):
        attr = getattr(self._runner, name)
        if name not in self._methods or not callable(attr):
            return attr

        def call(*args, **kwargs):
            return self._call(name, attr, args, kwargs)

        return call

    def _call(self, name: str, fn, args, kwargs):
        with self._leader.call_lock:
            self._leader.broadcast(self._model, name, *args, **kwargs)
            self.calls += 1
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                self._outcome(type(e).__name__)
                raise
            self._outcome("")
            if name == "begin_admit" and out is not None:
                out = _MirroredAdmission(out, self)
            if name in _TOKEN_RESULTS:
                self.digest.add(out)
            return out

    def _outcome(self, raised: str) -> None:
        """Tell the followers how the local call ended (``OUTCOME``); a
        channel already failed is left to the next call's broadcast."""
        try:
            self._leader.broadcast(self._model, OUTCOME, raised)
        except RuntimeError as e:
            log.error("multihost: %s", e)

    def drop(self) -> None:
        """Tell the followers to free this model (``__drop__``; nothing to
        tell once the group lost a rank)."""
        with self._leader.call_lock:
            if self._leader.connected and not self._leader.dead:
                self._leader.broadcast(self._model, "__drop__")


class _MirroredAdmission:
    """A leader admission whose chunk dispatches and abort are mirrored
    (the follower routes them to its admission of the same slot)."""

    def __init__(self, adm: Any, mirror: MirroredRunner):
        self._adm = adm
        self._mirror = mirror

    def __getattr__(self, name: str):
        return getattr(self._adm, name)

    def step_chunk(self):
        return self._mirror._call("step_chunk", _no_slot(self._adm.step_chunk),
                                  (self._adm.slot,), {})

    def abort(self):
        return self._mirror._call("abort", _no_slot(self._adm.abort),
                                  (self._adm.slot,), {})


def _no_slot(fn):
    """The local admission call: the wire carries the slot, the
    admission's own method takes none."""
    return lambda *_a, **_k: fn()


class FollowerEngine:
    """A follower's replay target around one runner (or drafter): every
    call passes through; ``begin_admit`` keeps the admission by slot for
    the ``step_chunk`` / ``abort`` that follow; sampled tokens fold into
    the digest."""

    def __init__(self, target: Any):
        self.target = target
        self.digest = TokenDigest()
        self.calls: dict[str, int] = {}
        self._admissions: dict[int, Any] = {}

    def __getattr__(self, name: str):
        attr = getattr(self.target, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            out = attr(*args, **kwargs)
            if name == "begin_admit" and out is not None:
                self._admissions[int(args[0])] = out
            if name in _TOKEN_RESULTS:
                self.digest.add(out)
            return out

        return call

    def report(self) -> dict:
        """The replay's counters: calls by method, the runner's dispatch
        counters and mesh transfers (calls, ms), the token digest."""
        out: dict = {"calls": dict(self.calls),
                     "digest": self.digest.hexdigest(),
                     "results": self.digest.results}
        runner = getattr(self.target, "runner", self.target)
        for k in ("decode_steps", "verify_windows", "prefill_chunks",
                  "fresh_prefills", "frozen_dispatches", "sp_prefills",
                  "last_prefill_path"):
            if hasattr(runner, k):
                out[k] = getattr(runner, k)
        if hasattr(runner, "params"):
            out["weight_bytes"] = _tree_bytes(runner.params)
        out["transfers"] = {
            k: {"calls": t.calls, "ms": t.seconds * 1e3}
            for k, t in getattr(runner, "transfers", {}).items()}
        return out

    def step_chunk(self, slot: int):
        self.calls["step_chunk"] = self.calls.get("step_chunk", 0) + 1
        adm = self._admissions[int(slot)]
        out = adm.step_chunk()
        if adm.done:
            self._admissions.pop(int(slot), None)
        self.digest.add(out)
        return out

    def abort(self, slot: int) -> None:
        self.calls["abort"] = self.calls.get("abort", 0) + 1
        adm = self._admissions.pop(int(slot), None)
        if adm is not None:
            adm.abort()

    def close(self) -> None:
        self.target = None


def _tree_bytes(tree: Any) -> int:
    """Bytes of a parameter tree's tensors (quantized leaves: q and
    scale)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return _tree_bytes(tree.q) + _tree_bytes(tree.scale)
    return 0


# ---------------------------------------------------------------------------
# the spawned single-host group


class FollowerProcess:
    """One spawned follower rank: ``cli.main follower`` with the spawn
    environment of a worker, its output tailed into this log; the line
    ``FOLLOWER_REPORT {json}`` it prints as it exits is kept as
    :attr:`report`."""

    def __init__(self, rank: int, argv: list[str], env: dict):
        self.rank = rank
        full = dict(os.environ)
        full.update({k: str(v) for k, v in env.items()})
        # the package the leader runs, whatever the working directory
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        full["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, full.get("PYTHONPATH", "")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "localai_tpu_torch.cli.main", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=full,
            text=True, bufsize=1)
        self.report: Optional[dict] = None
        self.tail: list[str] = []
        self._thread = threading.Thread(target=self._tail, daemon=True,
                                        name=f"follower-log-{rank}")
        self._thread.start()

    def _tail(self) -> None:
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            if line.startswith(REPORT_PREFIX):
                self.report = json.loads(line[len(REPORT_PREFIX):])
                continue
            self.tail = (self.tail + [line.rstrip()])[-20:]
            log.info("[rank %d] %s", self.rank, line.rstrip())

    @property
    def pid(self) -> int:
        return self.proc.pid

    def check(self) -> None:
        rc = self.proc.poll()
        if rc is not None:
            raise RuntimeError(
                f"tensor-parallel follower rank {self.rank} exited rc={rc}: "
                + " | ".join(self.tail[-5:]))

    def stop(self, grace: float = 60.0) -> None:
        """Wait for the orderly exit the closed channel asks for, then
        terminate, then kill."""
        try:
            self.proc.wait(grace)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                self.proc.wait(10.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10.0)
        self._thread.join(10.0)


class Group:
    """This process's mesh group as its leader sees it: the plan (None for
    a group joined by hand until its first model gives one), the width,
    the command channel, the followers it spawned (none when the ranks
    were started by hand) and their stop reports."""

    def __init__(self, plan: Any, world: int, leader: CommandLeader,
                 followers: list[FollowerProcess], spawned: bool):
        self.plan = plan
        self.world = world
        self.leader = leader
        self.followers = followers
        self.spawned = spawned
        self.reports: list[dict] = []
        self._stop = threading.Event()
        if followers:
            threading.Thread(target=self._watch, daemon=True,
                             name="tp-group-watch").start()

    def alive(self) -> None:
        for f in self.followers:
            f.check()

    def _watch(self) -> None:
        while not self._stop.wait(0.5):
            if self._watch_once():
                return

    def _watch_once(self) -> bool:
        """Mark the channel dead when a spawned follower has exited."""
        for f in self.followers:
            if f.proc.poll() is not None and not self._stop.is_set():
                self.leader.dead = (f"follower rank {f.rank} exited "
                                    f"rc={f.proc.returncode}")
                log.error("mesh group: %s", self.leader.dead)
                return True
        return False

    def wait_joined(self, timeout: float) -> None:
        self.leader.wait_for(self.world - 1, timeout, alive=self.alive)

    def close(self) -> list[dict]:
        """Close the channel (each follower prints its report and exits),
        reap the spawned followers, leave the group."""
        self._stop.set()
        self.leader.close()
        for f in self.followers:
            f.stop()
            if f.report is not None:
                self.reports.append({"rank": f.rank, **f.report})
        pmesh.destroy()
        REPORTS.extend(self.reports)
        return self.reports


# every closed group's follower reports, in order (the smoke reads them)
REPORTS: list[dict] = []
_group: Optional[Group] = None
_group_lock = threading.Lock()


def current_group() -> Optional[Group]:
    return _group


def join_as_leader(app: Any) -> Group:
    """Multi-host serving (``serve``): join the group as rank 0 at
    ``app.coordinator_address`` and open the command channel on
    ``app.mirror_port`` before any model loads; the followers are
    started by hand (``follower``)."""
    global _group
    with _group_lock:
        if _group is None:
            dev = pmesh.rank_device(app.device, app.process_id)
            initialize(app.coordinator_address, app.num_processes,
                       app.process_id, dev)
            leader = get_leader(app.mirror_port, app.mirror_followers,
                                token=app.peer_token)
            _group = Group(None, app.num_processes, leader, [],
                           spawned=False)
        return _group


def ensure_group(app: Any, plan: Any, model: str) -> Group:
    """The group this leader serves a meshed model of ``plan``
    (``mesh.MeshPlan``) on: the joined one (whose plan must be ``plan``),
    else a single-host group spawned now — ``plan.size() - 1`` follower
    ranks of ``model`` on this host's cards (ranks share cards when there
    are fewer), started once this rank's store listens on the port it
    bound, each joining the group and then the channel. A spawned group
    that lost a rank is closed and spawned anew (its engines failed with
    it)."""
    global _group
    from localai_tpu_torch.worker.process import spawn_env

    width = plan.size()
    with _group_lock:
        if _group is not None and _group.spawned and _group.leader.dead:
            # a spawned group that lost a rank is spawned anew
            log.warning("mesh group: respawning the group (%s)",
                        _group.leader.dead)
            dead, _group = _group, None
            dead.close()
        if _group is not None:
            if _group.plan is None and _group.world == width:
                _group.plan = plan    # a group joined by hand: its first
            if _group.plan != plan:
                have = (pmesh.spec_of(_group.plan) if _group.plan
                        else f"model={_group.world}")
                raise ValueError(
                    f"model {model!r} asks for mesh {pmesh.spec_of(plan)}, "
                    f"but this process serves the group of mesh {have} "
                    f"({_group.world} ranks)")
            return _group
        token = app.peer_token or secrets.token_hex(16)
        leader = CommandLeader(0, expected=width - 1, token=token,
                               host="127.0.0.1")
        followers: list[FollowerProcess] = []

        def spawn(port: int) -> None:
            for r in range(1, width):
                dev = pmesh.rank_device(app.device, r)
                argv = ["follower", "--leader",
                        f"127.0.0.1:{leader.port}", "--model", model,
                        "--models-path", str(app.model_path),
                        "--coordinator", f"127.0.0.1:{port}",
                        "--num-processes", str(width),
                        "--process-id", str(r), "--peer-token", token,
                        "--device", str(dev)]
                env = spawn_env(str(dev), app.worker_env)
                env["LOCALAI_DEVICE"] = str(dev)
                env["LOCALAI_MESH"] = pmesh.spec_of(plan)
                followers.append(FollowerProcess(r, argv, env))

        def alive() -> None:
            for f in followers:
                f.check()

        try:
            initialize("127.0.0.1:0", width, 0,
                       pmesh.rank_device(app.device, 0), alive=alive,
                       on_bound=spawn)
        except BaseException:
            leader.close()
            for f in followers:
                f.proc.kill()
                f.stop(5.0)
            raise
        _group = Group(plan, width, leader, followers, spawned=True)
        return _group


def close_group() -> list[dict]:
    """Close this process's group, if any (its followers exit, each with
    its report); returns the reports."""
    global _group
    with _group_lock:
        group, _group = _group, None
    return group.close() if group is not None else []


def mirror(runner: Any, spec: Any, model: str, group: Group,
           timeout: Optional[float] = None) -> tuple[Any, Any]:
    """Wrap a leader's runner (and a draft model's drafter) for mirroring,
    after every follower has joined the channel; ``(runner, spec)``."""
    group.wait_joined(pmesh.timeout_s() if timeout is None else timeout)
    mirrored = MirroredRunner(runner, group.leader, model)
    if spec is not None:
        spec.target = mirrored
        drafter = spec.drafter
        if getattr(drafter, "name", "") == "model":
            spec.drafter = MirroredRunner(drafter, group.leader,
                                          model + "#draft", DRAFT_MIRRORED)
    return mirrored, spec
