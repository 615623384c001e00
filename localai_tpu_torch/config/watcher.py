"""Dynamic configuration: files of the config dir applied while serving.

Port of ``localai_tpu/config/watcher.py``: a polling thread diffs the
mtimes of registered files and runs each file's handler when it changes
(with the file's bytes) or disappears (with None). ``api_keys.json`` (a
JSON array of keys) adds keys to the ones the server started with;
removing it restores them. ``external_backends.json`` (a JSON object,
model name → ``host:port`` of an externally managed port worker) merges
over the registrations the server started with into
``AppConfig.external_backends``; the manager routes those models to
their worker.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Callable, Optional

log = logging.getLogger(__name__)

Handler = Callable[[Optional[bytes]], None]


class ConfigWatcher:
    """Polls a directory of dynamic config files and fires a handler when
    one changes (or disappears: the handler gets None)."""

    def __init__(self, config_dir: str | Path, interval: float = 1.0):
        self.dir = Path(config_dir)
        self.interval = interval
        self._handlers: dict[str, Handler] = {}
        self._mtimes: dict[str, Optional[float]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, filename: str, handler: Handler) -> None:
        """Attach a handler for one file; it also runs now, so a file that
        exists at boot applies at boot."""
        self._handlers[filename] = handler
        self._mtimes[filename] = None
        self._apply(filename)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="config-watcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval + 2.0)
            self._thread = None

    def poll_once(self) -> None:
        """One poll cycle (for tests, and for applying synchronously)."""
        for name in list(self._handlers):
            self._apply(name)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must not die
                log.exception("config watcher poll failed")

    def _apply(self, name: str) -> None:
        path = self.dir / name
        try:
            mtime: Optional[float] = path.stat().st_mtime
        except OSError:
            mtime = None
        if mtime == self._mtimes.get(name):
            return
        data: Optional[bytes] = None
        if mtime is not None:
            try:
                data = path.read_bytes()
            except OSError as e:
                # the mtime is not recorded: the next poll retries
                log.warning("cannot read %s: %s", path, e)
                return
        self._mtimes[name] = mtime
        try:
            self._handlers[name](data)
            log.info("dynamic config %s %s", name,
                     "applied" if data is not None else "cleared")
        except Exception:  # noqa: BLE001 — a bad file is not a dead watcher
            log.exception("handler for %s failed", name)


def attach_standard_handlers(watcher: ConfigWatcher, app) -> None:
    """``api_keys.json`` onto ``app.api_keys`` (added to the startup
    keys), ``external_backends.json`` onto ``app.external_backends`` (over
    the startup registrations)."""
    startup_keys = list(app.api_keys)
    startup_backends = dict(app.external_backends)

    def on_api_keys(data: Optional[bytes]) -> None:
        dynamic: list[str] = []
        if data:
            parsed = json.loads(data)
            if not isinstance(parsed, list):
                raise ValueError("api_keys.json must be a JSON array")
            dynamic = [str(k) for k in parsed if k]
        app.api_keys = startup_keys + [
            k for k in dynamic if k not in startup_keys]

    def on_external_backends(data: Optional[bytes]) -> None:
        dynamic: dict[str, str] = {}
        if data:
            parsed = json.loads(data)
            if not isinstance(parsed, dict):
                raise ValueError(
                    "external_backends.json must be a JSON object")
            dynamic = {str(k): str(v) for k, v in parsed.items()}
        merged = dict(startup_backends)
        merged.update(dynamic)
        app.external_backends = merged

    watcher.register("api_keys.json", on_api_keys)
    watcher.register("external_backends.json", on_external_backends)
