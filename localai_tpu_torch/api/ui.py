"""The web UI of the port: pages over the server's JSON APIs.

Port of ``localai_tpu/api/ui.py``. Every page is one self-contained
document (inline CSS and plain JavaScript over ``fetch`` and SSE; no
external URL), built from strings as the JAX package builds it, and each
page's script calls the same JSON routes as the JAX package's page:

  * ``/`` for a browser (``Accept: text/html``, :func:`wants_html`):
    the configured models with their load state and per-usecase links;
  * ``/browse``: the gallery, searched, installed with live job progress
    (``/models/available``, ``/models/apply``, ``/models/jobs/{uuid}``,
    ``/models/delete/{name}``);
  * ``/chat/[model]``: a streamed chat over ``/v1/chat/completions``;
  * ``/text2image/[model]``, ``/tts/[model]``: ``/v1/images/generations``
    and ``/tts``;
  * ``/talk/[model]``: microphone → WAV in the page →
    ``/v1/audio/transcriptions`` → ``/v1/chat/completions`` →
    ``/v1/audio/speech`` → playback;
  * ``/swarm`` and ``/swarm/nodes``: a federation router's nodes, fetched
    by the server (``federation.explorer.fetch_nodes``) from a router of
    the allowlist (``federated_router``, ``swarm_routers``, compared in
    their canonical scheme/host/port/path form) or at this server's own
    port on loopback; a URL with userinfo, a query or a fragment, or not
    http(s), is a 400, any other router a 403, one that does not answer
    a 502;
  * ``/slo``, ``/fleet``, ``/usage``, ``/batches``: polling panels over
    ``/v1/slo``, ``/debug/flight``, ``/debug/anatomy``, ``/v1/fleet``,
    ``/v1/usage`` and ``/v1/batches``.

Pages are readable without an API key (they hold no data: ``UI_PREFIXES``
and ``UI_EXACT``, GET only), while their scripts send the key the
operator saves in the page header; ``/swarm/nodes`` needs the key.
``disable_webui`` takes every route of this module away and ``/``
answers JSON to a browser too.
"""

from __future__ import annotations

import html
from urllib.parse import urlsplit

from localai_tpu_torch.api.openai import APIError

CSS = """
:root { --bg:#0f1217; --panel:#171c24; --line:#2a3240; --fg:#e6e9ee;
  --dim:#8b95a5; --acc:#4f9cf7; --ok:#38b26f; --warn:#d9923b; }
* { box-sizing:border-box; }
body { margin:0; background:var(--bg); color:var(--fg);
  font:15px/1.5 system-ui, sans-serif; }
a { color:var(--acc); text-decoration:none; }
header { display:flex; gap:1.2rem; align-items:center;
  padding:.7rem 1.2rem; border-bottom:1px solid var(--line);
  background:var(--panel); flex-wrap:wrap; }
header .brand { font-weight:700; }
header nav { display:flex; gap:.9rem; }
header input { margin-left:auto; }
main { max-width:980px; margin:1.4rem auto; padding:0 1rem; }
.card { background:var(--panel); border:1px solid var(--line);
  border-radius:10px; padding:1rem 1.2rem; margin-bottom:1rem; }
table { width:100%; border-collapse:collapse; }
td, th { text-align:left; padding:.45rem .5rem;
  border-bottom:1px solid var(--line); }
.badge { font-size:.78em; padding:.1rem .5rem; border-radius:999px;
  border:1px solid var(--line); color:var(--dim); }
.badge.loaded { color:var(--ok); border-color:var(--ok); }
button, input, textarea, select { background:#0c0f14; color:var(--fg);
  border:1px solid var(--line); border-radius:7px; padding:.45rem .7rem;
  font:inherit; }
button { cursor:pointer; background:var(--acc); color:#fff;
  border-color:transparent; }
button.sub { background:transparent; color:var(--acc);
  border-color:var(--line); }
progress { width:100%; height:8px; }
#log { white-space:pre-wrap; }
.msg { padding:.55rem .8rem; border-radius:9px; margin:.4rem 0;
  max-width:85%; white-space:pre-wrap; }
.msg.user { background:#23344e; margin-left:auto; }
.msg.assistant { background:#1d242f; }
.row { display:flex; gap:.6rem; align-items:center; }
.row > * { flex:1; }
.row > button { flex:0; }
.dim { color:var(--dim); }
img.out { max-width:100%; border-radius:10px; margin-top:.8rem; }
"""

JS_COMMON = """
function authHeaders(extra) {
  const h = Object.assign({'Content-Type': 'application/json'}, extra||{});
  const k = localStorage.getItem('apiKey');
  if (k) h['Authorization'] = 'Bearer ' + k;
  return h;
}
function saveKey(el) { localStorage.setItem('apiKey', el.value); }
function initKey() {
  const el = document.getElementById('apikey');
  if (el) el.value = localStorage.getItem('apiKey') || '';
}
document.addEventListener('DOMContentLoaded', initKey);
"""


def _page(title: str, body: str, script: str = "") -> tuple:
    doc = f"""<!doctype html>
<html><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(title)} — LocalAI-TPU</title>
<style>{CSS}</style></head>
<body>
<header>
  <span class="brand">LocalAI-TPU</span>
  <nav>
    <a href="/">Home</a>
    <a href="/browse">Models</a>
    <a href="/chat/">Chat</a>
    <a href="/talk/">Talk</a>
    <a href="/text2image/">Image</a>
    <a href="/tts/">TTS</a>
    <a href="/swarm">Swarm</a>
    <a href="/slo">SLO</a>
    <a href="/fleet">Fleet</a>
    <a href="/usage">Usage</a>
    <a href="/batches">Batches</a>
  </nav>
  <input id="apikey" placeholder="API key (if set)"
         onchange="saveKey(this)" size="18">
</header>
<main>{body}</main>
<script>{JS_COMMON}{script}</script>
</body></html>"""
    return "text/html; charset=utf-8", doc.encode("utf-8")


def _model_names(manager, usecase=None) -> list[str]:
    names = []
    for n in manager.loader.names():
        cfg = manager.loader.get(n)
        if usecase is None or (cfg is not None and cfg.has_usecase(usecase)):
            names.append(n)
    return names


def _model_select(names: list[str], selected: str = "") -> str:
    opts = "".join(
        f'<option value="{html.escape(n)}"'
        f'{" selected" if n == selected else ""}>{html.escape(n)}</option>'
        for n in names
    )
    return f'<select id="model">{opts}</select>'


# -- home --------------------------------------------------------------------

def home(manager, query) -> tuple:
    """GET / for a browser: the configured models with their load state
    and per-usecase links."""
    loaded = set(manager.loaded_names())
    rows = []
    for name in manager.loader.names():
        cfg = manager.loader.get(name)
        status = ('<span class="badge loaded">loaded</span>'
                  if name in loaded else '<span class="badge">idle</span>')
        links = []
        if cfg is not None and cfg.has_usecase("chat"):
            links.append(f'<a href="/chat/{html.escape(name)}">chat</a>')
        if cfg is not None and cfg.has_usecase("image"):
            links.append(
                f'<a href="/text2image/{html.escape(name)}">image</a>')
        if cfg is not None and cfg.has_usecase("tts"):
            links.append(f'<a href="/tts/{html.escape(name)}">tts</a>')
        rows.append(
            f"<tr><td>{html.escape(name)}</td><td>{status}</td>"
            f"<td>{' · '.join(links)}</td></tr>"
        )
    body = f"""
<div class="card"><h2>Installed models</h2>
<table><tr><th>Model</th><th>State</th><th></th></tr>
{''.join(rows) or '<tr><td colspan=3 class="dim">none installed — '
 '<a href="/browse">browse the gallery</a></td></tr>'}</table></div>
<div class="card dim">OpenAI-compatible API at <code>/v1</code> ·
<a href="/metrics">metrics</a> · <a href="/system">system</a></div>"""
    return _page("Home", body)


# -- gallery browser ---------------------------------------------------------

def browse(manager, query) -> tuple:
    """GET /browse: the searchable gallery, installs with live job
    progress, deletes."""
    body = """
<div class="card">
  <h2>Model gallery</h2>
  <div class="row">
    <input id="q" placeholder="search models…" oninput="render()">
  </div>
  <div id="list" class="dim">loading…</div>
</div>"""
    script = """
// gallery entries are THIRD-PARTY data (fetched index YAMLs): build the
// table with textContent/dataset, never innerHTML interpolation — a
// crafted name/description must not script-inject into the operator's
// browser (which holds the API key in localStorage)
let MODELS = [];
async function load() {
  try {
    const r = await fetch('/models/available', {headers: authHeaders()});
    MODELS = await r.json();
  } catch (e) { MODELS = []; }
  render();
}
function render() {
  const q = (document.getElementById('q').value || '').toLowerCase();
  const list = document.getElementById('list');
  list.textContent = '';
  const table = document.createElement('table');
  let shown = 0;
  MODELS.forEach((m, i) => {
    if (q && !(m.name + ' ' + (m.description||''))
        .toLowerCase().includes(q)) return;
    shown++;
    const tr = table.insertRow();
    const td = tr.insertCell();
    const b = document.createElement('b');
    b.textContent = m.name;
    const desc = document.createElement('span');
    desc.className = 'dim';
    desc.textContent = m.description || '';
    const job = document.createElement('div');
    job.id = 'job-' + i;
    td.append(b, document.createElement('br'), desc, job);
    const act = tr.insertCell();
    const btn = document.createElement('button');
    if (m.installed) {
      btn.className = 'sub'; btn.textContent = 'delete';
      btn.onclick = () => del(m.name);
    } else {
      btn.textContent = 'install';
      btn.onclick = () => install(m.name, i);
    }
    act.appendChild(btn);
  });
  if (shown) list.appendChild(table);
  else list.textContent = 'no models match';
}
function showErr(slot, text) {
  slot.textContent = '';
  const e = document.createElement('span');
  e.style.color = 'var(--warn)';
  e.textContent = text;
  slot.appendChild(e);
}
async function install(id, i) {
  const slot = document.getElementById('job-' + i);
  slot.innerHTML = '<progress max="100" value="0"></progress>';
  const r = await fetch('/models/apply', {method: 'POST',
    headers: authHeaders(), body: JSON.stringify({id})});
  const body = await r.json().catch(() => ({}));
  const uuid = body.uuid;
  if (!r.ok || !uuid) {
    showErr(slot, (body.error && body.error.message) ||
            ('install failed (' + r.status + ')'));
    return;
  }
  const timer = setInterval(async () => {
    const s = await (await fetch('/models/jobs/' + uuid,
                                 {headers: authHeaders()})).json();
    slot.querySelector('progress').value = s.progress || 0;
    if (s.processed) {
      clearInterval(timer);
      slot.textContent = '';
      if (s.error) {
        showErr(slot, s.error);
      } else {
        const ok = document.createElement('span');
        ok.className = 'badge loaded';
        ok.textContent = 'installed';
        slot.appendChild(ok);
        load();
      }
    }
  }, 700);
}
async function del(name) {
  await fetch('/models/delete/' + encodeURIComponent(name),
              {method: 'POST', headers: authHeaders()});
  load();
}
load();
"""
    return _page("Models", body, script)


# -- chat --------------------------------------------------------------------

def chat_page(manager, query, model: str = "") -> tuple:
    """GET /chat/[model]: a streamed chat over /v1/chat/completions."""
    names = _model_names(manager, "chat")
    selected = model
    body = f"""
<div class="card">
  <div class="row"><h2 style="flex:1">Chat</h2>{_model_select(names, selected)}</div>
  <div id="msgs"></div>
  <div class="row">
    <textarea id="inp" rows="2" placeholder="say something…"
      onkeydown="if(event.key==='Enter'&&!event.shiftKey){{event.preventDefault();send();}}"></textarea>
    <button onclick="send()">Send</button>
  </div>
</div>"""
    script = """
const HISTORY = [];
function bubble(cls, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + cls; d.textContent = text;
  document.getElementById('msgs').appendChild(d);
  d.scrollIntoView(); return d;
}
async function send() {
  const inp = document.getElementById('inp');
  const text = inp.value.trim();
  if (!text) return;
  inp.value = '';
  HISTORY.push({role: 'user', content: text});
  bubble('user', text);
  const out = bubble('assistant', '…');
  const resp = await fetch('/v1/chat/completions', {method: 'POST',
    headers: authHeaders(),
    body: JSON.stringify({model: document.getElementById('model').value,
      messages: HISTORY, stream: true})});
  if (!resp.ok) { out.textContent = 'error: ' + await resp.text(); return; }
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let acc = '', buf = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    const frames = buf.split('\\n\\n'); buf = frames.pop();
    for (const f of frames) {
      const line = f.split('\\n').find(l => l.startsWith('data: '));
      if (!line || line === 'data: [DONE]') continue;
      const delta = JSON.parse(line.slice(6)).choices[0].delta;
      if (delta && delta.content) {
        acc += delta.content; out.textContent = acc;
      }
    }
  }
  HISTORY.push({role: 'assistant', content: acc});
}
"""
    return _page("Chat", body, script)


# -- text2image --------------------------------------------------------------

def text2image_page(manager, query, model: str = "") -> tuple:
    """GET /text2image/[model]: /v1/images/generations, shown inline."""
    names = _model_names(manager, "image")
    selected = model
    body = f"""
<div class="card">
  <div class="row"><h2 style="flex:1">Generate image</h2>{_model_select(names, selected)}</div>
  <div class="row">
    <input id="prompt" placeholder="a photo of…">
    <button id="go" onclick="gen()">Generate</button>
  </div>
  <div id="out" class="dim"></div>
</div>"""
    script = """
async function gen() {
  const out = document.getElementById('out');
  const btn = document.getElementById('go');
  btn.disabled = true; out.textContent = 'generating…';
  try {
    const r = await fetch('/v1/images/generations', {method: 'POST',
      headers: authHeaders(),
      body: JSON.stringify({model: document.getElementById('model').value,
        prompt: document.getElementById('prompt').value,
        response_format: 'b64_json'})});
    const body = await r.json();
    if (!r.ok) throw new Error(JSON.stringify(body.error || body));
    out.innerHTML = body.data.map(d =>
      `<img class="out" src="data:image/png;base64,${d.b64_json}">`).join('');
  } catch (e) { out.textContent = 'error: ' + e.message; }
  btn.disabled = false;
}
"""
    return _page("Text to image", body, script)


# -- tts ---------------------------------------------------------------------

def tts_page(manager, query, model: str = "") -> tuple:
    """GET /tts/[model]: /tts, played in the page."""
    names = _model_names(manager, "tts") or _model_names(manager)
    selected = model
    body = f"""
<div class="card">
  <div class="row"><h2 style="flex:1">Text to speech</h2>{_model_select(names, selected)}</div>
  <div class="row">
    <input id="text" placeholder="text to speak…">
    <button onclick="speak()">Speak</button>
  </div>
  <div id="out"></div>
</div>"""
    script = """
async function speak() {
  const out = document.getElementById('out');
  out.textContent = 'synthesizing…';
  const r = await fetch('/tts', {method: 'POST', headers: authHeaders(),
    body: JSON.stringify({model: document.getElementById('model').value,
      input: document.getElementById('text').value})});
  if (!r.ok) { out.textContent = 'error: ' + await r.text(); return; }
  const url = URL.createObjectURL(await r.blob());
  out.innerHTML = `<audio controls autoplay src="${url}"></audio>`;
}
"""
    return _page("TTS", body, script)


# -- talk (voice chat) -------------------------------------------------------

def talk_page(manager, query, model: str = "") -> tuple:
    """GET /talk/[model]: the voice-chat loop (microphone → WAV encoded
    in the page → /v1/audio/transcriptions → /v1/chat/completions →
    /v1/audio/speech → playback)."""
    chat_models = _model_names(manager, "chat") or _model_names(manager)
    stt = _model_names(manager, "transcript")
    tts = _model_names(manager, "tts")
    selected = model

    def select(id_, names):
        opts = "".join(
            f'<option value="{html.escape(n)}"'
            f'{" selected" if n == selected else ""}>'
            f'{html.escape(n)}</option>'
            for n in names) or "<option value=''>(default)</option>"
        return f'<select id="{id_}">{opts}</select>'

    body = f"""
<div class="card">
  <div class="row"><h2 style="flex:1">Talk</h2>
    <label>chat {select("model", chat_models)}</label>
    <label>stt {select("sttmodel", stt)}</label>
    <label>tts {select("ttsmodel", tts)}</label>
  </div>
  <div class="row">
    <button id="rec" onclick="toggleRec()">● Record</button>
    <span id="status">idle</span>
  </div>
  <div id="log"></div>
  <div id="out"></div>
</div>"""
    script = """
let ctx, source, proc, stream, chunks = [], recording = false, history = [];
function logLine(who, text) {
  const d = document.createElement('div');
  d.textContent = who + ': ' + text;
  document.getElementById('log').appendChild(d);
}
function wavBlob(buffers, rate) {
  let n = 0; buffers.forEach(b => n += b.length);
  const pcm = new Int16Array(n); let off = 0;
  buffers.forEach(b => { for (let i = 0; i < b.length; i++)
    pcm[off++] = Math.max(-1, Math.min(1, b[i])) * 32767; });
  const buf = new ArrayBuffer(44 + pcm.length * 2);
  const v = new DataView(buf);
  const ws = (o, s) => { for (let i = 0; i < s.length; i++)
    v.setUint8(o + i, s.charCodeAt(i)); };
  ws(0, 'RIFF'); v.setUint32(4, 36 + pcm.length * 2, true); ws(8, 'WAVE');
  ws(12, 'fmt '); v.setUint32(16, 16, true); v.setUint16(20, 1, true);
  v.setUint16(22, 1, true); v.setUint32(24, rate, true);
  v.setUint32(28, rate * 2, true); v.setUint16(32, 2, true);
  v.setUint16(34, 16, true); ws(36, 'data');
  v.setUint32(40, pcm.length * 2, true);
  new Int16Array(buf, 44).set(pcm);
  return new Blob([buf], {type: 'audio/wav'});
}
async function toggleRec() {
  const btn = document.getElementById('rec');
  const status = document.getElementById('status');
  if (!recording) {
    stream = await navigator.mediaDevices.getUserMedia({audio: true});
    ctx = new AudioContext();
    source = ctx.createMediaStreamSource(stream);
    proc = ctx.createScriptProcessor(4096, 1, 1);
    chunks = [];
    proc.onaudioprocess = e =>
      chunks.push(new Float32Array(e.inputBuffer.getChannelData(0)));
    source.connect(proc); proc.connect(ctx.destination);
    recording = true; btn.textContent = '■ Stop'; status.textContent =
      'recording…';
    return;
  }
  recording = false; btn.textContent = '● Record';
  proc.disconnect(); source.disconnect();
  stream.getTracks().forEach(t => t.stop());  // release the microphone
  const rate = ctx.sampleRate; ctx.close();
  status.textContent = 'transcribing…';
  const fd = new FormData();
  fd.append('file', wavBlob(chunks, rate), 'talk.wav');
  fd.append('model', document.getElementById('sttmodel').value);
  // multipart: the browser must set its own boundary content-type
  const auth = {}; const k = localStorage.getItem('apiKey');
  if (k) auth['Authorization'] = 'Bearer ' + k;
  const tr = await fetch('/v1/audio/transcriptions',
    {method: 'POST', headers: auth, body: fd});
  if (!tr.ok) { status.textContent = 'stt error: ' + await tr.text();
    return; }
  const text = (await tr.json()).text;
  logLine('you', text);
  history.push({role: 'user', content: text});
  status.textContent = 'thinking…';
  const cr = await fetch('/v1/chat/completions', {method: 'POST',
    headers: authHeaders(),
    body: JSON.stringify({model: document.getElementById('model').value,
      messages: history})});
  if (!cr.ok) { status.textContent = 'chat error: ' + await cr.text();
    return; }
  const reply = (await cr.json()).choices[0].message.content;
  history.push({role: 'assistant', content: reply});
  logLine('assistant', reply);
  status.textContent = 'speaking…';
  const sr = await fetch('/v1/audio/speech', {method: 'POST',
    headers: authHeaders(),
    body: JSON.stringify({model: document.getElementById('ttsmodel').value,
      input: reply})});
  if (!sr.ok) { status.textContent = 'tts error: ' + await sr.text();
    return; }
  const url = URL.createObjectURL(await sr.blob());
  document.getElementById('out').innerHTML =
    `<audio controls autoplay src="${url}"></audio>`;
  status.textContent = 'idle';
}
"""
    return _page("Talk", body, script)


# -- swarm (federation status) -----------------------------------------------

def swarm_page(manager, query) -> tuple:
    """GET /swarm[?router=URL]: a federation router's nodes, fetched by
    the server (/swarm/nodes) so the browser needs no cross-origin
    access."""
    router = query.get("router", "http://127.0.0.1:8080")
    body = f"""
<div class="card">
  <div class="row"><h2 style="flex:1">Federation swarm</h2>
    <input id="router" value="{html.escape(router)}" size="28">
    <button onclick="refresh()">Refresh</button>
  </div>
  <div id="nodes">loading…</div>
</div>"""
    script = """
function esc(v) {  // router-supplied fields are untrusted — escape all
  const d = document.createElement('div');
  d.textContent = String(v);
  return d.innerHTML;
}
async function refresh() {
  const out = document.getElementById('nodes');
  const router = encodeURIComponent(document.getElementById('router').value);
  const r = await fetch('/swarm/nodes?router=' + router,
    {headers: authHeaders()});
  if (!r.ok) { out.textContent = 'error: ' + await r.text(); return; }
  const data = await r.json();
  const rows = (data.nodes || []).map(n =>
    `<tr><td>${esc(n.id)}</td><td>${esc(n.address)}</td>` +
    `<td>${n.online ? 'online' : 'OFFLINE'}</td>` +
    `<td>${esc(n.requests)}</td><td>${esc(n.failures)}</td></tr>`).join('');
  out.innerHTML = `<p>${esc(data.online ?? 0)}/${(data.nodes || []).length}` +
    ` nodes online</p><table><tr><th>id</th><th>address</th><th>state</th>` +
    `<th>requests</th><th>failures</th></tr>${rows}</table>`;
}
refresh();
"""
    return _page("Swarm", body, script)


def _norm_router(url: str):
    """(scheme, host, port, path) of a router URL for the allowlist:
    scheme and host lowercased, the default port made explicit, a
    trailing slash dropped, so ``HTTP://Router:80/`` and
    ``http://router`` compare equal. None for anything that is not plain
    http(s) or carries userinfo."""
    try:
        parts = urlsplit(url)
    except ValueError:
        return None
    scheme = (parts.scheme or "").lower()
    if scheme not in ("http", "https"):
        return None
    if parts.username is not None or parts.password is not None:
        return None
    try:
        port = parts.port
    except ValueError:
        return None
    host = (parts.hostname or "").lower()
    return (scheme, host, port or (443 if scheme == "https" else 80),
            parts.path.rstrip("/"))


def swarm_nodes(manager, query) -> dict:
    """GET /swarm/nodes?router=URL: the router's node registry, fetched
    by the server. Only a router of the allowlist (``federated_router``,
    ``swarm_routers``) or loopback at this server's own port is fetched,
    so a key holder cannot use the server to probe other hosts or sweep
    the ports of local services."""
    from localai_tpu_torch.federation.explorer import fetch_nodes

    router = query.get("router", "http://127.0.0.1:8080")
    if not router.startswith(("http://", "https://")):
        raise APIError(400, "router must be an http(s) URL")
    if "?" in router or "#" in router:
        # a query or fragment would cut off the /federated/nodes suffix
        # and make the server a generic URL fetcher
        raise APIError(400, "router URL must not carry a query")
    target = _norm_router(router)
    if target is None:
        raise APIError(400, "malformed router URL (no userinfo, http(s) "
                            "only)")
    cfg = manager.app
    allowed = {_norm_router(r.strip())
               for r in (cfg.federated_router, cfg.swarm_routers or "")
               for r in r.split(",") if r.strip()} - {None}
    own_port = (target[1] in ("127.0.0.1", "localhost", "::1")
                and target[2] == cfg.port)
    if target not in allowed and not own_port:
        raise APIError(403, "router not in the configured allowlist "
                            "(federated_router / swarm_routers)")
    try:
        return fetch_nodes(router)
    except Exception as e:  # noqa: BLE001 — a router down is a 502
        raise APIError(502, f"router unreachable: {e}") from None


# -- SLO observatory and flight recorder -------------------------------------

def slo_page(manager, query) -> tuple:
    """GET /slo: per-model latency percentiles and burn rates
    (/v1/slo), the flight recorder (/debug/flight) and the dispatch
    anatomy (/debug/anatomy), polled."""
    body = """
<div class="card">
  <div class="row"><h2 style="flex:1">SLO observatory</h2>
    <span id="shed" class="badge">…</span></div>
  <div id="slo" class="dim">loading…</div>
</div>
<div class="card">
  <h2>Flight recorder</h2>
  <div id="flight" class="dim">loading…</div>
</div>
<div class="card">
  <h2>Dispatch anatomy</h2>
  <div class="dim" style="margin-bottom:6px">
    windowed wall-time shares per model: gap / sched / launch / sync /
    unattributed (obs.anatomy — bubble is an estimator)</div>
  <div id="anatomy" class="dim">loading…</div>
</div>"""
    script = """
function fmt(v, d) {
  return (v === null || v === undefined) ? '—' : Number(v).toFixed(d ?? 1);
}
function table(out, headers, rows) {  // textContent only: API data is
  out.textContent = '';               // untrusted for innerHTML
  const t = document.createElement('table');
  const hr = t.insertRow();
  headers.forEach(h => {
    const th = document.createElement('th');
    th.textContent = h; hr.appendChild(th);
  });
  rows.forEach(r => {
    const tr = t.insertRow();
    r.forEach(v => tr.insertCell().textContent = v);
  });
  out.appendChild(t);
  if (!rows.length) out.textContent = 'no data yet';
}
async function refresh() {
  try {
    const s = await (await fetch('/v1/slo', {headers: authHeaders()})).json();
    const models = s.models || {};
    const shedding = Object.values(models).some(m => m.shedding);
    const badge = document.getElementById('shed');
    badge.textContent = shedding ? 'SHEDDING' : 'healthy';
    badge.className = 'badge' + (shedding ? '' : ' loaded');
    const rows = [];
    for (const [name, m] of Object.entries(models)) {
      for (const [w, a] of Object.entries(m.windows || {})) {
        rows.push([name, w, a.count,
                   fmt(a.ttft_ms && a.ttft_ms.p95),
                   fmt(a.tpot_ms && a.tpot_ms.p95, 2),
                   fmt(a.e2e_ms && a.e2e_ms.p95),
                   fmt(a.burn_rate, 2),
                   m.shedding ? 'shedding (' + m.shed_total + ' shed)'
                              : 'ok']);
      }
    }
    table(document.getElementById('slo'),
          ['model', 'window', 'n', 'ttft p95 ms', 'tpot p95 ms',
           'e2e p95 ms', 'burn', 'state'], rows);
  } catch (e) {
    document.getElementById('slo').textContent = 'error: ' + e.message;
  }
  try {
    const f = await (await fetch('/debug/flight?limit=64',
                                 {headers: authHeaders()})).json();
    const rows = [];
    for (const [name, m] of Object.entries(f.models || {})) {
      const last = m.records[m.records.length - 1] || {};
      rows.push([name, m.dispatches, m.tokens_total,
                 fmt(m.percentiles.step_ms_p50, 2),
                 fmt(m.percentiles.step_ms_p99, 2),
                 fmt(last.occupancy, 2),
                 last.queue_depth ?? '—',
                 fmt(last.kv_utilization, 2),
                 last.spec_accept == null ? '—'
                                          : fmt(last.spec_accept, 2)]);
    }
    table(document.getElementById('flight'),
          ['model', 'dispatches', 'tokens', 'step p50 ms', 'step p99 ms',
           'occupancy', 'queue', 'kv util', 'spec accept'], rows);
  } catch (e) {
    document.getElementById('flight').textContent = 'error: ' + e.message;
  }
  try {
    const a = await (await fetch('/debug/anatomy',
                                 {headers: authHeaders()})).json();
    const out = document.getElementById('anatomy');
    out.textContent = '';
    const colors = {gap: '#888', sched: '#d90', launch: '#38c',
                    sync: '#2a6', unattributed: '#444'};
    let any = false;
    for (const [name, m] of Object.entries(a.models || {})) {
      if (!m.samples) continue;
      any = true;
      const row = document.createElement('div');
      row.style.margin = '6px 0';
      const label = document.createElement('div');
      label.textContent = name + ' — host overhead ' +
        fmt(m.host_overhead_fraction, 3) + ' · bubble ' +
        fmt(m.device_bubble_fraction, 3) + ' · ' + m.samples +
        ' dispatches / ' + fmt(m.dispatch_ms_total, 0) + ' ms';
      row.appendChild(label);
      const bar = document.createElement('div');
      bar.style.cssText =
        'display:flex;height:14px;border-radius:3px;overflow:hidden;' +
        'background:#222;margin-top:2px';
      const shares = Object.assign({}, m.phase_share || {});
      shares.unattributed = m.unattributed_share;
      for (const [ph, share] of Object.entries(shares)) {
        if (!share) continue;
        const seg = document.createElement('div');
        seg.style.width = (share * 100).toFixed(1) + '%';
        seg.style.background = colors[ph] || '#666';
        seg.title = ph + ' ' + (share * 100).toFixed(1) + '%';
        bar.appendChild(seg);
      }
      row.appendChild(bar);
      const legend = document.createElement('div');
      legend.className = 'dim';
      legend.textContent = Object.entries(shares)
        .filter(([, v]) => v != null)
        .map(([ph, v]) => ph + ' ' + (v * 100).toFixed(1) + '%')
        .join(' · ');
      row.appendChild(legend);
      out.appendChild(row);
    }
    if (!any) out.textContent = 'no dispatches in window yet';
  } catch (e) {
    document.getElementById('anatomy').textContent = 'error: ' + e.message;
  }
}
refresh();
setInterval(refresh, 2000);
"""
    return _page("SLO", body, script)


# -- fleet router ------------------------------------------------------------

def fleet_page(manager, query) -> tuple:
    """GET /fleet: the replicas' state, dial health and routing mix
    (/v1/fleet), polled."""
    body = """
<div class="card">
  <div class="row"><h2 style="flex:1">Fleet</h2>
    <span id="fhealth" class="badge">…</span></div>
  <div id="replicas" class="dim">loading…</div>
</div>
<div class="card">
  <h2>Routing</h2>
  <div id="routing" class="dim">loading…</div>
  <p class="dim">Placement: prompt-prefix affinity (token-chain block hash
  → consistent-hash ring) with least-loaded fallback; shed replicas are
  routed around; a replica dying mid-request fails over.</p>
</div>"""
    script = """
function table(out, headers, rows) {  // textContent only: API data is
  out.textContent = '';               // untrusted for innerHTML
  const t = document.createElement('table');
  const hr = t.insertRow();
  headers.forEach(h => {
    const th = document.createElement('th');
    th.textContent = h; hr.appendChild(th);
  });
  rows.forEach(r => {
    const tr = t.insertRow();
    r.forEach(v => tr.insertCell().textContent = v);
  });
  out.appendChild(t);
  if (!rows.length) out.textContent = 'no fleet-served models';
}
async function refresh() {
  try {
    const d = await (await fetch('/v1/fleet',
                                 {headers: authHeaders()})).json();
    const models = d.models || {};
    const reps = [], routing = [];
    let dead = 0, healthy = 0;
    for (const [name, m] of Object.entries(models)) {
      if (!m.fleet) continue;
      (m.replicas || []).forEach(r => {
        if (r.state === 'healthy') healthy++; else dead++;
        const shed = (m.shedding || {})[r.id];
        reps.push([r.id, r.role, r.state + (shed ? ' (shedding)' : ''),
                   r.inflight, r.dispatched, r.errors,
                   r.dial_seconds === null ? '—' : r.dial_seconds + 's',
                   r.checked_age_s === null ? '—' : r.checked_age_s + 's']);
      });
      const rt = (m.router || {}).routed || {};
      routing.push([name, rt.affinity || 0, rt.least_loaded || 0,
                    rt.failover || 0, (m.router || {}).routed_around || 0,
                    m.respawns || 0, m.prefix_transfers || 0,
                    m.prefix_transfer_bytes || 0, m.disagg_fallbacks || 0]);
    }
    const badge = document.getElementById('fhealth');
    badge.textContent = dead ? (dead + ' degraded') :
                        (healthy ? healthy + ' healthy' : 'no fleet');
    badge.className = 'badge' + (dead ? '' : ' loaded');
    table(document.getElementById('replicas'),
          ['replica', 'role', 'state', 'inflight', 'dispatched', 'errors',
           'dial', 'checked'], reps);
    table(document.getElementById('routing'),
          ['model', 'affinity', 'least-loaded', 'failover', 'routed around',
           'respawns', 'prefix transfers', 'transfer bytes',
           'disagg fallbacks'], routing);
  } catch (e) {
    document.getElementById('replicas').textContent = 'error: ' + e.message;
  }
}
refresh();
setInterval(refresh, 2000);
"""
    return _page("Fleet", body, script)


# -- usage accounting --------------------------------------------------------

def usage_page(manager, query) -> tuple:
    """GET /usage: per-tenant cost rows, the goodput ratio and the waste
    by reason (/v1/usage), polled. Tenants are hashed buckets: no key
    reaches this page."""
    body = """
<div class="card">
  <div class="row"><h2 style="flex:1">Usage</h2>
    <span id="goodput" class="badge">…</span></div>
  <div id="tenants" class="dim">loading…</div>
</div>
<div class="card">
  <h2>Waste decomposition</h2>
  <div id="waste" class="dim">loading…</div>
  <p class="dim">Goodput = tokens delivered on natural completions
  (stop/length). Waste classes: speculation-rejected draft tokens,
  failover/migration re-prefills, shed admissions, cancelled and
  NaN-quarantined requests.</p>
</div>"""
    script = """
function fmt(v, d) {
  return (v === null || v === undefined) ? '—' : Number(v).toFixed(d ?? 1);
}
function table(out, headers, rows, empty) {  // textContent only: API
  out.textContent = '';                      // data is untrusted
  const t = document.createElement('table');
  const hr = t.insertRow();
  headers.forEach(h => {
    const th = document.createElement('th');
    th.textContent = h; hr.appendChild(th);
  });
  rows.forEach(r => {
    const tr = t.insertRow();
    r.forEach(v => tr.insertCell().textContent = v);
  });
  out.appendChild(t);
  if (!rows.length) out.textContent = empty || 'no data yet';
}
async function refresh() {
  try {
    const d = await (await fetch('/v1/usage',
                                 {headers: authHeaders()})).json();
    const badge = document.getElementById('goodput');
    const g = d.goodput || {};
    badge.textContent = 'goodput ' + fmt(100 * (g.goodput_ratio ?? 1)) + '%';
    badge.className = 'badge' +
      ((g.goodput_ratio ?? 1) >= 0.9 ? ' loaded' : '');
    const rows = (d.data || []).map(p =>
      [p.tenant, p.model + '/' + p.lane, p.requests, p.delivered_tokens,
       p.prompt_tokens, fmt(p.dispatch_ms, 0), fmt(p.queue_wait_ms, 0),
       fmt(p.kv_block_seconds, 1), p.waste_tokens]);
    table(document.getElementById('tenants'),
          ['tenant', 'model/lane', 'req', 'delivered', 'prompt',
           'dispatch ms', 'queue ms', 'kv blk·s', 'wasted'], rows,
          'no attributed requests yet');
    const wrows = (d.waste || []).map(c =>
      [c.reason, c.model, c.tokens, c.requests]);
    table(document.getElementById('waste'),
          ['reason', 'model', 'tokens', 'requests'], wrows,
          'no waste recorded');
  } catch (e) {
    document.getElementById('tenants').textContent = 'error: ' + e.message;
  }
}
refresh();
setInterval(refresh, 2000);
"""
    return _page("Usage", body, script)


# -- offline batch jobs ------------------------------------------------------

def batches_page(manager, query) -> tuple:
    """GET /batches: the batch jobs with their progress (/v1/batches),
    polled."""
    body = """
<div class="card">
  <div class="row"><h2 style="flex:1">Batch jobs</h2>
    <span id="lane" class="badge">…</span></div>
  <div id="jobs" class="dim">loading…</div>
  <p class="dim">Submit jobs with <code>POST /v1/files</code>
  (purpose=batch) + <code>POST /v1/batches</code>; download results from
  <code>/v1/files/{output_file_id}/content</code>.</p>
</div>"""
    script = """
function table(out, headers, rows) {  // textContent only: API data is
  out.textContent = '';               // untrusted for innerHTML
  const t = document.createElement('table');
  const hr = t.insertRow();
  headers.forEach(h => {
    const th = document.createElement('th');
    th.textContent = h; hr.appendChild(th);
  });
  rows.forEach(r => {
    const tr = t.insertRow();
    r.forEach(v => tr.insertCell().textContent = v);
  });
  out.appendChild(t);
  if (!rows.length) out.textContent = 'no batch jobs yet';
}
async function refresh() {
  try {
    const d = await (await fetch('/v1/batches',
                                 {headers: authHeaders()})).json();
    const jobs = d.data || [];
    const active = jobs.some(j => j.status === 'in_progress');
    const badge = document.getElementById('lane');
    badge.textContent = active ? 'RUNNING' : 'idle';
    badge.className = 'badge' + (active ? ' loaded' : '');
    const rows = jobs.map(j => {
      const c = j.request_counts || {};
      const done = (c.completed || 0) + (c.failed || 0);
      const pct = c.total ? Math.round(100 * done / c.total) : 0;
      return [j.id, j.endpoint, j.status,
              done + '/' + (c.total || 0) + ' (' + pct + '%)',
              c.failed || 0,
              j.output_file_id || '—',
              new Date((j.created_at || 0) * 1000).toLocaleString()];
    });
    table(document.getElementById('jobs'),
          ['id', 'endpoint', 'status', 'progress', 'failed',
           'output file', 'created'], rows);
  } catch (e) {
    document.getElementById('jobs').textContent = 'error: ' + e.message;
  }
}
refresh();
setInterval(refresh, 2000);
"""
    return _page("Batches", body, script)


# -- wiring ------------------------------------------------------------------

# pages a GET may read without an API key (the server's auth reads
# these): the prefixes, and the exact paths whose sub-routes must stay
# protected (/swarm/nodes fetches an operator-named router)
UI_PREFIXES = ("/browse", "/chat/", "/text2image/", "/tts/", "/talk/")
UI_EXACT = ("/swarm", "/slo", "/batches", "/fleet", "/usage")


def wants_html(headers) -> bool:
    """A browser's request (``Accept`` names text/html)."""
    return "text/html" in (headers.get("Accept") or "")


GET = {"/browse": browse, "/chat/": chat_page,
       "/text2image/": text2image_page, "/tts/": tts_page,
       "/talk/": talk_page, "/swarm": swarm_page,
       "/swarm/nodes": swarm_nodes, "/slo": slo_page,
       "/batches": batches_page, "/fleet": fleet_page,
       "/usage": usage_page}
GET_PARAM = (("/chat/{model}", chat_page),
             ("/text2image/{model}", text2image_page),
             ("/tts/{model}", tts_page), ("/talk/{model}", talk_page))
