"""The OpenAPI document of the port's live route table, and its explorer.

Port of ``localai_tpu/api/openapi.py``: ``GET /swagger/doc.json`` is an
OpenAPI 3.0 document built at request time from the routes the server
matches (``api.server.route_table``), so it cannot drift from them; the
endpoints users call most carry hand-written request bodies
(``_DOCS``), every other operation the first line of its handler's
docstring. ``GET /swagger`` is a self-contained page (no external
asset) that lists the document's operations. Both are open without an
API key, as on the JAX package.
"""

from __future__ import annotations

import html

from localai_tpu_torch import __version__

# richer docs for the endpoints users call most; every other operation
# gets a stub from its route
_DOCS: dict[tuple[str, str], dict] = {
    ("POST", "/v1/chat/completions"): {
        "summary": "OpenAI-compatible chat completion",
        "requestBody": {
            "model": "string", "messages": "array", "stream": "boolean",
            "tools": "array", "max_tokens": "integer",
            "temperature": "number",
        },
    },
    ("POST", "/v1/completions"): {
        "summary": "Text completion (list prompts fan out to choices)",
        "requestBody": {"model": "string", "prompt": "string|array",
                        "stream": "boolean", "n": "integer"},
    },
    ("POST", "/v1/embeddings"): {
        "summary": "Embeddings (LLM mean-pool or bert sentence encoder)",
        "requestBody": {"model": "string", "input": "string|array"},
    },
    ("POST", "/v1/images/generations"): {
        "summary": "Image generation (diffusers-class pipelines)",
        "requestBody": {"model": "string", "prompt": "string",
                        "size": "string", "response_format": "string"},
    },
    ("POST", "/v1/audio/transcriptions"): {
        "summary": "Speech-to-text (whisper engine, multipart upload)",
    },
    ("POST", "/v1/audio/speech"): {
        "summary": "Text-to-speech",
        "requestBody": {"model": "string", "input": "string",
                        "voice": "string"},
    },
    ("POST", "/v1/rerank"): {
        "summary": "Jina-compatible rerank (cross-encoder or cosine)",
        "requestBody": {"model": "string", "query": "string",
                        "documents": "array", "top_n": "integer"},
    },
    ("POST", "/v1/files"): {"summary": "Upload a file (multipart)"},
    ("POST", "/v1/assistants"): {"summary": "Create an assistant"},
    ("POST", "/models/apply"): {
        "summary": "Install a model from a gallery (async job)",
        "requestBody": {"id": "string", "name": "string"},
    },
}


def build_spec(routes) -> dict:
    """``(method, path pattern, handler)`` triples → OpenAPI 3.0."""
    paths: dict[str, dict] = {}
    for method, path, fn in routes:
        doc = _DOCS.get((method, path), {})
        op: dict = {
            "summary": doc.get(
                "summary",
                (getattr(fn, "__doc__", None) or "").strip().split("\n")[0]
                or f"{method} {path}"),
            "responses": {"200": {"description": "OK"}},
        }
        body = doc.get("requestBody")
        if body:
            op["requestBody"] = {"content": {"application/json": {
                "schema": {"type": "object", "properties": {
                    k: {"type": "string" if "|" in v or v == "string"
                        else v}
                    for k, v in body.items()}}}}}
        params = [p[1:-1] for p in path.split("/")
                  if p.startswith("{") and p.endswith("}")]
        if params:
            op["parameters"] = [{"name": p, "in": "path", "required": True,
                                 "schema": {"type": "string"}}
                                for p in params]
        paths.setdefault(path, {})[method.lower()] = op
    return {
        "openapi": "3.0.3",
        "info": {"title": "LocalAI-TPU API",
                 "description": "OpenAI-compatible serving on PyTorch and "
                                "CUDA",
                 "version": __version__},
        "security": [{"bearerAuth": []}],
        "components": {"securitySchemes": {"bearerAuth": {
            "type": "http", "scheme": "bearer"}}},
        "paths": dict(sorted(paths.items())),
    }


def spec_json(manager, query) -> dict:
    """GET /swagger/doc.json: the OpenAPI document of the live routes."""
    from localai_tpu_torch.api.server import route_table

    return build_spec(route_table(manager.app))


def swagger_ui(manager, query) -> tuple:
    """GET /swagger: a self-contained explorer over the live document."""
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>LocalAI-TPU API</title>
<style>body{{font:14px/1.5 system-ui;background:#0f1217;color:#e6e9ee;
margin:1.5rem auto;max-width:900px;padding:0 1rem}}
.ep{{border:1px solid #2a3240;border-radius:8px;margin:.5rem 0;
background:#171c24}}summary{{padding:.5rem .8rem;cursor:pointer}}
.m{{display:inline-block;min-width:52px;font-weight:700}}
.GET{{color:#38b26f}}.POST{{color:#4f9cf7}}.DELETE{{color:#d9573b}}
pre{{background:#0c0f14;padding:.6rem .8rem;border-radius:6px;
overflow:auto;margin:.4rem .8rem .8rem}}</style></head><body>
<h2>LocalAI-TPU API <small style="color:#8b95a5">{html.escape(__version__)}
</small></h2>
<p><a href="/swagger/doc.json" style="color:#4f9cf7">doc.json</a>
(OpenAPI 3.0)</p><div id="eps">loading…</div>
<script>
(async () => {{
  const spec = await (await fetch('/swagger/doc.json')).json();
  const out = [];
  for (const [path, ops] of Object.entries(spec.paths)) {{
    for (const [m, op] of Object.entries(ops)) {{
      const M = m.toUpperCase();
      const body = op.requestBody
        ? '<pre>' + JSON.stringify(
            op.requestBody.content['application/json'].schema.properties,
            null, 2) + '</pre>' : '';
      out.push(`<details class="ep"><summary><span class="m ${{M}}">${{M}}
        </span> <code>${{path}}</code> — ${{op.summary || ''}}</summary>
        ${{body}}</details>`);
    }}
  }}
  document.getElementById('eps').innerHTML = out.join('');
}})();
</script></body></html>"""
    return "text/html; charset=utf-8", doc.encode("utf-8")


GET = {"/swagger": swagger_ui, "/swagger/doc.json": spec_json}
