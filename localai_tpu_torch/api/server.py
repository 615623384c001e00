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
"""

from __future__ import annotations

import json
import logging
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


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"

    def log_message(self, fmt, *args):  # route access logs to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str) -> None:
        self._json(status, {"error": {"message": message,
                                      "type": "invalid_request_error",
                                      "code": status}})

    def do_GET(self):  # noqa: N802 — http.server's naming
        path, _, qs = self.path.partition("?")
        fn = _GET.get(path)
        if fn is None:
            return self._error(404, f"no route {self.path}")
        query = {k: v[-1] for k, v in urllib.parse.parse_qs(qs).items()}
        self._json(200, fn(self.server.manager, query))

    def do_POST(self):  # noqa: N802
        fn = _POST.get(self.path.split("?", 1)[0])
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
            log.exception("request failed")
            return self._error(500, str(e))
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
        """Stop accepting requests, then stop every engine."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()
        self.manager.shutdown()
