"""HTTP server for the port, on the standard library's ThreadingHTTPServer.

Routes (the JAX package's aiohttp server has more), each OpenAI one also
under the JAX package's unversioned alias:
  * POST /v1/chat/completions, /chat/completions  (plain JSON, or SSE with
    ``"stream": true``)
  * POST /v1/completions, /completions
  * POST /v1/edits, /edits
  * POST /v1/embeddings, /embeddings
  * POST /v1/rerank, /rerank
  * POST /v1/tokenize, /tokenize, /backend/monitor, /backend/shutdown
  * POST /v1/audio/transcriptions (multipart/form-data), /v1/audio/speech,
    /tts, /v1/text-to-speech/{voice_id}, /v1/sound-generation,
    /sound-generation (``api.audio``; ``audio/wav`` bodies)
  * POST /v1/images/generations, GET /generated-images/{name}
    (``api.images``; PNG)
  * GET  /v1/models, /models  (``?filter=<regex>``)
  * GET  /, /healthz, /readyz, /version, /metrics, /system,
    /backend/metrics, /v1/slo, /v1/usage; POST /backend/trace
  * GET  /v1/fleet; POST /v1/fleet/{model}/swap, /federated/register
    (``api.localai``; the fleets of ``fleet``)
  * GET  /v1/traces, /v1/traces/{trace_id}, /debug/timeline/{request_id}
  * GET  /debug/devices, /debug/programs, /debug/stacks, /debug/flight,
    /debug/fleet/flight, /debug/anatomy, /debug/profiles, /debug/history,
    /debug/history/{series}, /debug/kv; GET/POST/DELETE /debug/faults
    (``api.debug``)
  * GET  /v1/files, /v1/files/{file_id}, /v1/files/{file_id}/content;
    POST /v1/files (multipart/form-data); DELETE /v1/files/{file_id};
    GET/POST /v1/assistants; GET/POST/DELETE
    /v1/assistants/{assistant_id}; GET/POST
    /v1/assistants/{assistant_id}/files; GET/DELETE
    /v1/assistants/{assistant_id}/files/{file_id} (``api.assistants``,
    each also unversioned)
  * POST /v1/batches, /v1/batches/{batch_id}/cancel; GET /v1/batches,
    /v1/batches/{batch_id} (``api.batches``)
  * POST /stores/set, /stores/get, /stores/delete, /stores/find
    (``api.stores``; the vector stores on the app's device)
  * POST /models/apply, /models/delete/{name}; GET /models/available,
    /models/jobs, /models/jobs/{uuid}; GET/POST/DELETE /models/galleries
    (``api.gallery``; DELETE takes a JSON body, as on the JAX package)
  * GET  /swagger, /swagger/doc.json (``api.openapi``: the OpenAPI
    document of this table)
  * GET  the web UI's pages (``api.ui``): /browse, /chat/[model],
    /text2image/[model], /tts/[model], /talk/[model], /swarm,
    /swarm/nodes, /slo, /fleet, /usage, /batches, and / for a browser
    (``Accept: text/html``); none of them under ``disable_webui``
One thread per connection; each request blocks its own thread on the
scheduler handle while the engine thread batches all of them. A request
body is read up to ``MAX_BODY_BYTES`` (64 MiB, the JAX package's
``client_max_size``); a longer one is a 413.

Around every route, as the JAX package's middlewares do: a trace id for
the request (``X-Trace-ID`` or ``X-Correlation-ID``, else a new one),
bound to the handler's thread for the JSON logs and answered in an
``X-Trace-ID`` header; an HTTP span in the trace store (not for the
scrape and trace paths of ``TRACE_SKIP``); ``localai_api_call_seconds``
by the matched route's pattern; bearer-key auth against
``AppConfig.api_keys`` (constant-time comparison; the paths of
``AUTH_EXEMPT`` are open; a 401 otherwise), which also stamps the
request's usage-ledger tenant (``obs.ledger.derive_tenant`` of the key,
``anonymous`` without one — never the raw key; a GET of a web UI page
is open while the UI is on); CORS headers and
``OPTIONS`` answered 204 while ``cors`` is on; and, under
``opaque_errors``, 500 bodies that say only "internal error". An error
answer carries its ``APIError``'s headers (a shed 429's ``Retry-After``).

At construction the server arms the ``LOCALAI_FAULT_*`` fault specs,
configures the process-wide SLO observatory from the settings
(``slo_*``), restores the metrics history from ``LOCALAI_HISTORY_DIR``,
arms the anomaly profiler when ``LOCALAI_PROFILE_ON_ANOMALY=1`` and opens
the file registry and batch job store under ``upload_path``
(``api.batches.BatchState``; the batch executor starts at the first job,
or at once when a job survived a restart), as the JAX package's server
does. Shutdown stops the executor before the engines.
"""

from __future__ import annotations

import json
import logging
import re
import secrets
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from localai_tpu_torch import faults
from localai_tpu_torch.api import assistants, audio, batches, debug, images
from localai_tpu_torch.api import gallery as gallery_api
from localai_tpu_torch.api import inference as inf
from localai_tpu_torch.api import jina
from localai_tpu_torch.api import stores as stores_api
from localai_tpu_torch.api import localai as la
from localai_tpu_torch.api import openai as oa
from localai_tpu_torch.api import openapi, traces, ui
from localai_tpu_torch.models.manager import ModelManager
from localai_tpu_torch.obs import history as obs_history
from localai_tpu_torch.obs import ledger as obs_ledger
from localai_tpu_torch.obs import logging as obs_logging
from localai_tpu_torch.obs import profiler as obs_profiler
from localai_tpu_torch.obs import slo as obs_slo
from localai_tpu_torch.obs import trace as obs_trace
from localai_tpu_torch.obs.metrics import REGISTRY
from localai_tpu_torch.stores import StoreRegistry

log = logging.getLogger(__name__)

_POST = {"/v1/chat/completions": oa.chat, "/chat/completions": oa.chat,
         "/v1/completions": oa.completions, "/completions": oa.completions,
         "/v1/edits": oa.edits, "/edits": oa.edits,
         "/v1/embeddings": oa.embeddings, "/embeddings": oa.embeddings,
         "/v1/rerank": jina.rerank, "/rerank": jina.rerank,
         "/v1/tokenize": la.tokenize, "/tokenize": la.tokenize,
         "/backend/monitor": la.backend_monitor,
         "/backend/shutdown": la.backend_shutdown,
         "/backend/trace": la.backend_trace,
         "/federated/register": la.fleet_register,
         "/v1/audio/transcriptions": audio.transcriptions,
         "/v1/audio/speech": audio.speech, "/tts": audio.speech,
         "/v1/sound-generation": audio.sound_generation,
         "/sound-generation": audio.sound_generation,
         "/v1/images/generations": images.generations,
         **assistants.POST, **assistants.UPLOAD, **batches.POST,
         **debug.POST, **stores_api.POST, **gallery_api.POST}
# POST routes whose body is multipart/form-data (the handler takes the
# parsed fields), not JSON
_MULTIPART = {"/v1/audio/transcriptions", *assistants.UPLOAD}
# POST routes whose handler also takes the request's base URL (url answers)
_BASE_URL = {"/v1/images/generations"}
# POST routes guarded by the peer token: the handler takes the request's
# Authorization header, and the body as parsed (None when it is not JSON),
# so a wrong token is a 401 before anything of the body is judged
_PEER_AUTH = {"/federated/register", "/v1/fleet/{model}/swap"}
MAX_BODY_BYTES = 64 << 20
_GET = {"/v1/models": oa.list_models, "/models": oa.list_models,
        "/readyz": lambda manager, query: oa.readyz(manager),
        "/healthz": la.healthz, "/version": la.version,
        "/metrics": la.metrics, "/system": la.system,
        "/backend/metrics": la.engine_metrics,
        "/v1/slo": la.slo_report, "/v1/usage": la.usage,
        "/v1/fleet": la.fleet_status,
        "/v1/traces": traces.list_traces, **debug.GET, **assistants.GET,
        **batches.GET, **gallery_api.GET, **openapi.GET}
_DELETE = {**debug.DELETE, **gallery_api.DELETE_BODY}


def _param_routes(routes) -> list:
    """Routes with path parameters: (pattern, compiled, handler)."""
    return [(pattern, re.compile("^" + re.sub(r"\{\w+\}", "([^/]+)",
                                              pattern) + "$"), fn)
            for pattern, fn in routes]


_GET_PARAM = _param_routes((
    ("/v1/traces/{trace_id}", traces.trace_detail),
    ("/debug/timeline/{request_id}", traces.timeline),
    ("/generated-images/{name}", images.serve_generated),
    *debug.GET_PARAM, *assistants.GET_PARAM, *batches.GET_PARAM,
    *gallery_api.GET_PARAM))
_POST_PARAM = _param_routes((
    ("/v1/text-to-speech/{voice_id}", audio.elevenlabs_tts),
    ("/v1/fleet/{model}/swap", la.fleet_swap),
    *assistants.POST_PARAM, *batches.POST_PARAM, *gallery_api.POST_PARAM))
_DELETE_PARAM = _param_routes(assistants.DELETE_PARAM)
# paths reachable without an API key (the JAX package's AUTH_EXEMPT; the
# web UI's pages have their own exemption, ui.UI_PREFIXES / UI_EXACT)
AUTH_EXEMPT = {"/", "/healthz", "/readyz", "/version", "/swagger",
               "/swagger/doc.json"}
# observability/probe paths whose HTTP spans are scrape noise: they get a
# trace id but are not recorded (the JAX package's lists)
TRACE_SKIP = {"/metrics", "/healthz", "/readyz", "/v1/traces", "/v1/slo",
              "/debug/devices", "/debug/programs", "/debug/stacks",
              "/debug/flight", "/debug/fleet/flight", "/debug/profiles",
              "/debug/kv", "/debug/faults"}
TRACE_SKIP_PREFIXES = ("/debug/timeline/", "/v1/traces/")


def welcome(manager, query) -> dict:
    """GET /: the JAX package's JSON welcome (a browser gets the web UI's
    home, ``ui.home``, unless ``disable_webui``)."""
    return {"message": "LocalAI-TPU", "models": manager.loader.names(),
            "endpoints": sorted({p for _, p, _ in route_table(manager.app)})}


_GET["/"] = welcome
# the GET routes with the web UI's pages
_GET_WEBUI = {**_GET, **ui.GET}
_GET_PARAM_WEBUI = _GET_PARAM + _param_routes(ui.GET_PARAM)


def _tables(method: str, webui: bool) -> tuple:
    """(exact paths, parameter routes) a request of ``method`` may match."""
    if method == "GET":
        return ((_GET_WEBUI, _GET_PARAM_WEBUI) if webui
                else (_GET, _GET_PARAM))
    return ({"POST": _POST, "DELETE": _DELETE}.get(method, {}),
            {"POST": _POST_PARAM, "DELETE": _DELETE_PARAM}.get(method, []))


def route_table(app) -> list:
    """(method, path pattern, handler) of every route the server matches
    under the settings ``app`` (the welcome's endpoints and the OpenAPI
    document read it)."""
    out = []
    for method in ("GET", "POST", "DELETE"):
        exact, params = _tables(method, not app.disable_webui)
        out += [(method, p, fn) for p, fn in exact.items()]
        out += [(method, p, fn) for p, _, fn in params]
    return out


def _route(method: str, path: str, webui: bool = True):
    """(canonical path, handler, path parameters) of a request, or None:
    the canonical path is the route's pattern, never the raw URL."""
    table, params = _tables(method, webui)
    if path in table:
        return path, table[path], ()
    for pattern, rx, fn in params:
        m = rx.match(path)
        if m:
            return pattern, fn, tuple(urllib.parse.unquote(g)
                                      for g in m.groups())
    return None


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"
    _trace_id = ""      # set per request by _traced
    _status = 500

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
        if self._trace_id:
            self.send_header("X-Trace-ID", self._trace_id)
        super().end_headers()

    def send_response(self, code, message=None) -> None:
        self._status = code
        super().send_response(code, message)

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, payload: dict) -> None:
        self._send(status, json.dumps(payload).encode("utf-8"),
                   "application/json")

    def _error(self, status: int, message: str,
               kind: str = "invalid_request_error",
               headers: dict | None = None) -> None:
        body = json.dumps({"error": {"message": message, "type": kind,
                                     "code": status}}).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _api_error(self, e: "oa.APIError") -> None:
        self._error(e.status, e.message, headers=e.headers)

    def _admitted(self, path: str):
        """Key auth: no keys configured, an exempt path, or a bearer
        token equal to one of the keys; otherwise answer 401. The
        admitted request's ledger tenant (``derive_tenant`` of its key,
        ``anonymous`` without one), or None after the 401."""
        app = self.server.manager.app
        keys = app.api_keys
        if not keys or path in AUTH_EXEMPT:
            return obs_ledger.ANONYMOUS
        if (self.command == "GET" and not app.disable_webui
                and (path.startswith(ui.UI_PREFIXES) or path in ui.UI_EXACT)):
            return obs_ledger.ANONYMOUS     # a page: its data needs the key
        token = self.headers.get("Authorization", "").removeprefix(
            "Bearer ").strip()
        if token and any(secrets.compare_digest(token, k) for k in keys):
            return obs_ledger.derive_tenant(token)
        self._error(401, "invalid or missing API key",
                    "authentication_error")
        return None

    def _internal_error(self, e: Exception) -> None:
        log.exception("request failed")
        opaque = self.server.manager.app.opaque_errors
        self._error(500, "internal error" if opaque
                    else f"{type(e).__name__}: {e}", "internal_error")

    def _traced(self, serve, preflight: bool = False) -> None:
        """The JAX package's trace and metrics middlewares around one
        request: the trace id is bound to this thread (each connection
        has a thread and so a context of its own) for the JSON logs and
        the engine's spans; an admitted request's time lands in
        ``localai_api_call_seconds`` under its route's pattern; the HTTP
        span is recorded unless the path is scrape noise. A CORS
        ``preflight`` is answered before auth and the route metrics, as
        the JAX package's CORS middleware answers it."""
        path = self.path.split("?", 1)[0]
        self._trace_id = tid = (self.headers.get("X-Trace-ID")
                                or self.headers.get("X-Correlation-ID")
                                or obs_trace.new_trace_id())
        self._status = 500
        route = _route(self.command, path,
                       not self.server.manager.app.disable_webui)
        canonical = route[0] if route else "(unmatched)"
        log_token = obs_logging.bind_trace_id(tid)
        cid_token = inf.bind_correlation_id(
            self.headers.get("X-Correlation-ID", ""))
        t0 = time.monotonic()
        try:
            if preflight:
                serve(path, route)
            elif (tenant := self._admitted(path)) is not None:
                tenant_token = obs_ledger.set_current_tenant(tenant)
                try:
                    serve(path, route)
                finally:
                    obs_ledger.reset_current_tenant(tenant_token)
                    REGISTRY.api_call.observe(
                        time.monotonic() - t0, method=self.command,
                        path=canonical)
        finally:
            inf.unbind_correlation_id(cid_token)
            obs_logging.unbind_trace_id(log_token)
            if (path not in TRACE_SKIP
                    and not path.startswith(TRACE_SKIP_PREFIXES)):
                tr = obs_trace.RequestTrace(
                    tid, f"http-{id(self):x}", kind="http",
                    method=self.command, path=canonical,
                    status=self._status)
                tr.t0 = t0
                span = tr.begin("http", method=self.command, path=canonical,
                                status=self._status)
                span.t0 = t0  # the span covers the whole handler
                tr.end("http")
                obs_trace.STORE.record(tr)

    def _reply(self, out) -> None:
        """A handler's answer: a dict as JSON, a str as plain text
        (OpenMetrics, a text transcript), a (content type, bytes) pair as
        that body, a (status, dict) pair as JSON with that status, else an
        iterator of SSE frames."""
        if isinstance(out, dict):
            return self._json(200, out)
        if isinstance(out, str):
            return self._send(200, out.encode("utf-8"),
                              "text/plain; charset=utf-8")
        if isinstance(out, tuple):
            if isinstance(out[0], int):
                return self._json(*out)
            ctype, body = out
            return self._send(200, body, ctype)
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

    def do_OPTIONS(self):  # noqa: N802 — http.server's naming
        if self.server.manager.app.cors:
            def preflight(path, route):
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

            return self._traced(preflight, preflight=True)
        self._traced(lambda path, route: self._error(405,
                                                     "method not allowed"))

    def do_GET(self):  # noqa: N802
        self._traced(self._serve_query)

    def do_DELETE(self):  # noqa: N802
        self._traced(self._serve_query)

    def _serve_query(self, path, route) -> None:
        """A GET or DELETE: the handler takes the query string's
        parameters (the last value of each) and the path parameters."""
        if route is None:
            return self._error(404, f"no route {self.path}")
        canonical, fn, params = route
        if (canonical == "/" and not self.server.manager.app.disable_webui
                and ui.wants_html(self.headers)):
            fn = ui.home
        qs = self.path.partition("?")[2]
        query = {k: v[-1] for k, v in urllib.parse.parse_qs(qs).items()}
        if self.command == "DELETE" and canonical in gallery_api.DELETE_BODY:
            # the JAX package's DELETE with a JSON body
            try:
                n = int(self.headers.get("Content-Length") or 0)
                query = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(query, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError:
                return self._error(400, "invalid JSON body")
        try:
            out = fn(self.server.manager, query, *params)
        except oa.APIError as e:
            return self._api_error(e)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            return self._internal_error(e)
        self._reply(out)

    def do_POST(self):  # noqa: N802
        def serve(path, route):
            if route is None:
                return self._error(404, f"no route {self.path}")
            canonical, fn, params = route
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                return self._error(400, "invalid Content-Length")
            if n > MAX_BODY_BYTES:
                return self._error(413, f"request body of {n} bytes is "
                                        f"over {MAX_BODY_BYTES}")
            raw = self.rfile.read(n)
            try:
                kw = {}
                if canonical in _MULTIPART:
                    if canonical in assistants.UPLOAD:
                        kw["filenames"] = {}
                    body = audio.parse_multipart(
                        self.headers.get("Content-Type", ""), raw,
                        kw.get("filenames"))
                elif canonical in _PEER_AUTH:
                    try:
                        body = json.loads(raw or b"{}")
                    except ValueError:
                        body = None
                    kw["authorization"] = self.headers.get(
                        "Authorization", "")
                elif canonical in assistants.JSON_ANY:
                    try:
                        body = json.loads(raw)
                    except ValueError:
                        return self._error(400, assistants.PARSE_ERROR)
                else:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
            except oa.APIError as e:
                return self._error(e.status, e.message)
            except ValueError as e:
                return self._error(400, f"invalid JSON body: {e}")
            if canonical in _BASE_URL:
                host = self.headers.get("Host") or "{}:{}".format(
                    *self.server.server_address[:2])
                kw["base_url"] = f"http://{host}"
            try:
                out = fn(self.server.manager, body, *params, **kw)
            except oa.APIError as e:
                return self._api_error(e)
            except (ValueError, TypeError) as e:
                return self._error(400, str(e))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                return self._internal_error(e)
            self._reply(out)

        self._traced(serve)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, manager: ModelManager):
        super().__init__(addr, _Handler)
        self.manager = manager


class Listener:
    """One address serving a manager's routes on a thread of its own
    (port 0 binds a free port). An :class:`APIServer` listens through
    one; another over the same manager is a second front door to the
    same engines, and ``close`` stops only it."""

    def __init__(self, manager: ModelManager, address: str = "127.0.0.1",
                 port: int = 0):
        self._httpd = _HTTPServer((address, port), manager)
        self.address, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.address}:{self.port}"

    def start(self) -> "Listener":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        """Stop accepting requests and release the address."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()


class APIServer:
    """The port's OpenAI-compatible server over one ModelManager. Port 0
    binds a free port (read ``.port`` after construction)."""

    def __init__(self, manager: ModelManager, address: str = "127.0.0.1",
                 port: int = 8080):
        self.manager = manager
        app = manager.app
        # the process-wide SLO observatory's targets from the settings
        # (all zero: no shedding), the metrics history's restore and
        # writer (LOCALAI_HISTORY_DIR), and the anomaly profiler
        # (LOCALAI_PROFILE_ON_ANOMALY=1), as the JAX package's server
        obs_slo.SLO.configure(targets=obs_slo.targets_from_config(app),
                              burn_threshold=app.slo_burn_threshold)
        obs_history.install_from_env()
        obs_profiler.install_from_env(str(app.backend_assets_path or "."))
        # fault injection: LOCALAI_FAULT_* specs armed once, at boot
        faults.install_from_env()
        # /v1/files + /v1/batches: the registry and the job store, reloaded
        # from upload_path (jobs that survived a restart resume now);
        # /v1/assistants: the assistants, reloaded from config_path, their
        # files in that registry
        manager.batch_state = batches.BatchState(app, manager)
        manager.assistants = assistants.AssistantStore(
            app.config_path, app.upload_path,
            registry=manager.batch_state.files)
        # /stores/*: the vector stores, on the app's device; /models/*:
        # the galleries and the install job runner
        manager.stores = StoreRegistry(device=app.device)
        manager.gallery = gallery_api.GalleryState(app, manager.loader)
        self._listener = Listener(manager, address, port)
        self.address, self.port = self._listener.address, self._listener.port
        self.watcher = None     # a config.watcher.ConfigWatcher, if any

    @property
    def url(self) -> str:
        return f"http://{self.address}:{self.port}"

    def start(self) -> "APIServer":
        self._listener.start()
        return self

    def serve_forever(self) -> None:
        self._listener.serve_forever()

    def shutdown(self) -> None:
        """Stop accepting requests, the config watcher, the batch
        executor, then every engine."""
        if self.watcher is not None:
            self.watcher.stop()
        self._listener.close()
        # the executor stops before the engines: an in-progress job stays
        # durable and resumes from its output file at the next boot
        self.manager.batch_state.shutdown()
        self.manager.gallery.shutdown()
        self.manager.shutdown()
