"""HTTP server for the port, on the standard library's ThreadingHTTPServer.

Routes (the JAX package's aiohttp server has many more), each OpenAI one
also under the JAX package's unversioned alias:
  * POST /v1/chat/completions, /chat/completions  (plain JSON, or SSE with
    ``"stream": true``)
  * POST /v1/completions, /completions
  * POST /v1/edits, /edits
  * POST /v1/embeddings, /embeddings
  * POST /v1/rerank, /rerank
  * GET  /v1/models, /models  (``?filter=<regex>``)
  * GET  /readyz
One thread per connection; each request blocks its own thread on the
scheduler handle while the engine thread batches all of them.

Around every route, as the JAX package's middlewares do: bearer-key auth
against ``AppConfig.api_keys`` (constant-time comparison; the paths of
``AUTH_EXEMPT`` are open; a 401 otherwise), CORS headers and ``OPTIONS``
answered 204 while ``cors`` is on, and, under ``opaque_errors``, 500
bodies that say only "internal error".
"""

from __future__ import annotations

import json
import logging
import secrets
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from localai_tpu_torch.api import jina
from localai_tpu_torch.api import openai as oa
from localai_tpu_torch.models.manager import ModelManager

log = logging.getLogger(__name__)

_POST = {"/v1/chat/completions": oa.chat, "/chat/completions": oa.chat,
         "/v1/completions": oa.completions, "/completions": oa.completions,
         "/v1/edits": oa.edits, "/edits": oa.edits,
         "/v1/embeddings": oa.embeddings, "/embeddings": oa.embeddings,
         "/v1/rerank": jina.rerank, "/rerank": jina.rerank}
_GET = {"/v1/models": oa.list_models, "/models": oa.list_models,
        "/readyz": lambda manager, query: oa.readyz(manager)}
# paths reachable without an API key (the JAX package's AUTH_EXEMPT; the
# web UI's own exemptions come with the UI, ROADMAP item 22)
AUTH_EXEMPT = {"/", "/healthz", "/readyz", "/version", "/swagger",
               "/swagger/doc.json"}


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"

    def log_message(self, fmt, *args):  # route access logs to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def end_headers(self) -> None:
        app = self.server.manager.app
        if app.cors:
            self.send_header("Access-Control-Allow-Origin",
                             app.cors_allow_origins or "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, DELETE, OPTIONS")
            self.send_header("Access-Control-Allow-Headers",
                             "Authorization, Content-Type")
        super().end_headers()

    def _json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str,
               kind: str = "invalid_request_error") -> None:
        self._json(status, {"error": {"message": message, "type": kind,
                                      "code": status}})

    def _admitted(self, path: str) -> bool:
        """Key auth: no keys configured, an exempt path, or a bearer
        token equal to one of the keys; otherwise answer 401."""
        keys = self.server.manager.app.api_keys
        if not keys or path in AUTH_EXEMPT:
            return True
        token = self.headers.get("Authorization", "").removeprefix(
            "Bearer ").strip()
        if token and any(secrets.compare_digest(token, k) for k in keys):
            return True
        self._error(401, "invalid or missing API key",
                    "authentication_error")
        return False

    def _internal_error(self, e: Exception) -> None:
        log.exception("request failed")
        opaque = self.server.manager.app.opaque_errors
        self._error(500, "internal error" if opaque
                    else f"{type(e).__name__}: {e}", "internal_error")

    def do_OPTIONS(self):  # noqa: N802 — http.server's naming
        if self.server.manager.app.cors:
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self.end_headers()
        elif self._admitted(self.path.split("?", 1)[0]):
            self._error(405, "method not allowed")

    def do_GET(self):  # noqa: N802
        path, _, qs = self.path.partition("?")
        if not self._admitted(path):
            return
        fn = _GET.get(path)
        if fn is None:
            return self._error(404, f"no route {self.path}")
        query = {k: v[-1] for k, v in urllib.parse.parse_qs(qs).items()}
        try:
            out = fn(self.server.manager, query)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            return self._internal_error(e)
        self._json(200, out)

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if not self._admitted(path):
            return
        fn = _POST.get(path)
        if fn is None:
            return self._error(404, f"no route {self.path}")
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            return self._error(400, f"invalid JSON body: {e}")
        try:
            out = fn(self.server.manager, body)
        except oa.APIError as e:
            return self._error(e.status, e.message)
        except (ValueError, TypeError) as e:
            return self._error(400, str(e))
        except Exception as e:  # noqa: BLE001 — report, keep serving
            return self._internal_error(e)
        if isinstance(out, dict):
            return self._json(200, out)
        # SSE: HTTP/1.0 semantics — the stream ends when the connection
        # closes, so no length or chunking is needed
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Accel-Buffering", "no")
        self.end_headers()
        try:
            for frame in out:
                self.wfile.write(frame)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            out.close()  # cancels the generation


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, manager: ModelManager):
        super().__init__(addr, _Handler)
        self.manager = manager


class APIServer:
    """The port's OpenAI-compatible server over one ModelManager. Port 0
    binds a free port (read ``.port`` after construction)."""

    def __init__(self, manager: ModelManager, address: str = "127.0.0.1",
                 port: int = 8080):
        self.manager = manager
        self._httpd = _HTTPServer((address, port), manager)
        self.address, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        self.watcher = None     # a config.watcher.ConfigWatcher, if any

    @property
    def url(self) -> str:
        return f"http://{self.address}:{self.port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop accepting requests, the config watcher, then every
        engine."""
        if self.watcher is not None:
            self.watcher.stop()
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()
        self.manager.shutdown()
