"""Worker process lifecycle: spawn, health-gate, respawn, watchdog.

Port of ``localai_tpu/worker/process.py``:

  * :class:`WorkerProcess` spawns ``python -m localai_tpu_torch.worker.
    server --addr 127.0.0.1:0``, waits for its ``WORKER_READY port=<n>``
    line, tails the rest of its output into this process's log and gates
    it on a health call; ``stop`` asks it to end (SIGTERM), then kills it
    after a grace. A worker's orderly stop ends with one
    ``WORKER_LAUNCHES {json}`` line, its kernel wrappers' launch counts
    beside its engine's step counters, which the tail keeps as
    :attr:`WorkerProcess.launch_report`;
  * :class:`Watchdog` kills workers busy or idle past a timeout;
  * :class:`WorkerPool` maps names to workers, respawns a stale one on
    access, and registers external workers by address
    (``external_backends``).

A worker process runs on the card unless its environment says
``LOCALAI_DEVICE=cpu``; pinning it to devices is ``fleet.pinning``'s
``CUDA_VISIBLE_DEVICES`` in its spawn environment.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from localai_tpu_torch.worker.client import WorkerClient

log = logging.getLogger(__name__)

READY_PREFIX = "WORKER_READY port="
LAUNCHES_PREFIX = "WORKER_LAUNCHES "


def spawn_env(device: str, extra: Optional[dict] = None) -> dict:
    """A worker's spawn-environment additions: the serving instance's
    device (a worker runs where its parent was told to run, the card
    unless ``cpu``), then ``extra`` (``worker_env``, a pinning slice)
    over it."""
    return {"LOCALAI_DEVICE": device, **(extra or {})}


class WorkerProcess:
    """One spawned worker and its client handle."""

    def __init__(self, name: str, *, env: Optional[dict] = None,
                 health_attempts: int = 60, health_interval: float = 1.0,
                 parallel: bool = True, watchdog: "Watchdog | None" = None):
        self.name = name
        self.proc: Optional[subprocess.Popen] = None
        self.client: Optional[WorkerClient] = None
        self.port = 0
        self._env = env or {}
        self._health_attempts = health_attempts
        self._health_interval = health_interval
        self._parallel = parallel
        self._watchdog = watchdog
        self._log_thread: Optional[threading.Thread] = None
        # the kernel launch counts the worker printed at its orderly stop
        self.launch_report: Optional[dict] = None

    def start(self) -> WorkerClient:
        env = dict(os.environ)
        env.update(self._env)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "localai_tpu_torch.worker.server",
             "--addr", "127.0.0.1:0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, bufsize=1,
        )
        # the tail thread scans for WORKER_READY and forwards the rest into
        # this log; waiting on an event keeps startup bounded even if the
        # child hangs silently before binding
        self._ready_evt = threading.Event()
        self._ready_port = 0
        self._log_thread = threading.Thread(
            target=self._tail_log, daemon=True,
            name=f"worker-log-{self.name}",
        )
        self._log_thread.start()
        timeout = self._health_attempts * self._health_interval
        if not self._ready_evt.wait(timeout) or not self._ready_port:
            rc = self.proc.poll()
            self.stop()
            raise RuntimeError(
                f"worker {self.name} never reported a port"
                + (f" (exited rc={rc})" if rc is not None else "")
            )
        self.port = self._ready_port

        client = WorkerClient(f"127.0.0.1:{self.port}",
                              parallel=self._parallel,
                              watchdog=self._watchdog)
        for _ in range(self._health_attempts):
            if client.health(timeout=2.0):
                self.client = client
                return client
            if self.proc.poll() is not None:
                break
            time.sleep(self._health_interval)
        self.stop()
        raise RuntimeError(f"worker {self.name} failed health check")

    def _tail_log(self) -> None:
        assert self.proc is not None and self.proc.stdout is not None
        for line in self.proc.stdout:
            if line.startswith(READY_PREFIX):
                self._ready_port = int(line.strip().split("=", 1)[1])
                self._ready_evt.set()
                continue
            if line.startswith(LAUNCHES_PREFIX):
                self.launch_report = json.loads(line[len(LAUNCHES_PREFIX):])
            log.info("[%s] %s", self.name, line.rstrip())
        self._ready_evt.set()  # EOF: unblock a waiting start()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def healthy(self) -> bool:
        return self.alive and self.client is not None and self.client.health()

    def stop(self, grace: float = 5.0) -> None:
        if self.client is not None:
            self.client.close()
            self.client = None
        proc, self.proc = self.proc, None
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(grace)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5.0)
        if proc is not None and self._log_thread is not None:
            # the tail reads to the worker's last line (its launch report)
            self._log_thread.join(5.0)


class Watchdog:
    """Busy/idle watchdog over worker addresses.

    ``mark``/``unmark`` are called by WorkerClient around every call; the
    loop kills workers busy longer than ``busy_timeout`` (a hung engine) or
    idle longer than ``idle_timeout`` (a memory hog)."""

    def __init__(self, *, busy_timeout: float = 300.0,
                 idle_timeout: float = 900.0, interval: float = 5.0):
        self.busy_timeout = busy_timeout
        self.idle_timeout = idle_timeout
        self.interval = interval
        self._busy_since: dict[str, float] = {}
        self._busy_count: dict[str, int] = {}
        self._idle_since: dict[str, float] = {}
        self._kill: dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, address: str, kill_fn) -> None:
        with self._lock:
            self._kill[address] = kill_fn
            self._idle_since[address] = time.monotonic()

    def unregister(self, address: str) -> None:
        with self._lock:
            self._kill.pop(address, None)
            self._busy_since.pop(address, None)
            self._busy_count.pop(address, None)
            self._idle_since.pop(address, None)

    def mark(self, address: str) -> None:
        """Refcounted: a worker serving N overlapping calls stays busy
        until the last one finishes."""
        with self._lock:
            n = self._busy_count.get(address, 0)
            self._busy_count[address] = n + 1
            if n == 0:
                self._busy_since[address] = time.monotonic()
            self._idle_since.pop(address, None)

    def unmark(self, address: str) -> None:
        with self._lock:
            n = self._busy_count.get(address, 0) - 1
            if n > 0:
                self._busy_count[address] = n
                return
            self._busy_count.pop(address, None)
            self._busy_since.pop(address, None)
            self._idle_since[address] = time.monotonic()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="worker-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval * 2)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            doomed: list[str] = []
            with self._lock:
                if self.busy_timeout:
                    doomed += [a for a, t in self._busy_since.items()
                               if now - t > self.busy_timeout]
                if self.idle_timeout:
                    doomed += [a for a, t in self._idle_since.items()
                               if now - t > self.idle_timeout]
                kills = [(a, self._kill.get(a)) for a in doomed]
            for addr, kill in kills:
                if kill is None:
                    continue
                log.warning("watchdog killing worker at %s", addr)
                try:
                    kill()
                finally:
                    self.unregister(addr)


class WorkerPool:
    """name → worker, with health-check-and-respawn on access and
    external-worker registration."""

    def __init__(self, *, watchdog: Optional[Watchdog] = None):
        self._workers: dict[str, WorkerProcess] = {}
        self._external: dict[str, WorkerClient] = {}
        self._lock = threading.Lock()          # guards the maps only
        self._name_locks: dict[str, threading.Lock] = {}
        self._watchdog = watchdog

    def _name_lock(self, name: str) -> threading.Lock:
        with self._lock:
            lk = self._name_locks.get(name)
            if lk is None:
                lk = self._name_locks[name] = threading.Lock()
            return lk

    def register_external(self, name: str, address: str) -> WorkerClient:
        """An externally managed worker speaking the same contract.
        Idempotent: the same name and address reuse the client."""
        with self._lock:
            ext = self._external.get(name)
            if ext is not None and ext.address == address:
                return ext
        client = WorkerClient(address, watchdog=self._watchdog)
        with self._lock:
            self._external[name] = client
        # the displaced client (an address change) is not closed: another
        # thread may be mid-stream on it
        return client

    def get(self, name: str, *, env: Optional[dict] = None) -> WorkerClient:
        # per-name lock: a cold spawn of one model (a process and a model
        # load, tens of seconds) must not serialise lookups of others
        with self._name_lock(name):
            with self._lock:
                ext = self._external.get(name)
                if ext is not None:
                    return ext
                wp = self._workers.get(name)
            if wp is not None:
                if wp.healthy():
                    return wp.client  # type: ignore[return-value]
                log.warning("worker %s unhealthy; respawning", name)
                with self._lock:
                    self._drop_locked(name)
            wp = WorkerProcess(name, env=env, watchdog=self._watchdog)
            client = wp.start()
            if self._watchdog is not None:
                self._watchdog.register(client.address, wp.stop)
            with self._lock:
                self._workers[name] = wp
            return client

    def process(self, name: str) -> Optional[WorkerProcess]:
        """The spawned worker of ``name``, if any (liveness polls, tests)."""
        with self._lock:
            return self._workers.get(name)

    def _drop_locked(self, name: str) -> None:
        wp = self._workers.pop(name, None)
        if wp is not None:
            if self._watchdog is not None and wp.client is not None:
                self._watchdog.unregister(wp.client.address)
            wp.stop()

    def shutdown(self, name: str) -> bool:
        with self._lock:
            if name in self._workers:
                self._drop_locked(name)
                return True
            ext = self._external.pop(name, None)
        if ext is not None:
            ext.close()
            return True
        return False

    def shutdown_all(self) -> None:
        with self._lock:
            for name in list(self._workers):
                self._drop_locked(name)
            for client in self._external.values():
                client.close()
            self._external.clear()

    def names(self) -> list[str]:
        with self._lock:
            return sorted(set(self._workers) | set(self._external))
