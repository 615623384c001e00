"""The PyTorch port's Mamba and its recurrent serving facade against the
JAX package (``models/mamba.py``, ``models/mamba_serving.py``), on the CPU.

Parameters drawn by the JAX package (every vector moved off its constant,
an own head so greedy streams are not echoes) are carried across by
``params_from_numpy``; seeded numpy inputs go through both. Held, in
float32: prefill logits within 1e-4 of the largest at prompt lengths 1,
3 (shorter than the conv kernel), 16, 17 and 40, with the conv and scan
states; the reference's bucketed, length-gated prefill (a prompt shorter
than its bucket, and one of exactly the bucket's length) against the
port's; the decode step against the prefill at the next position; 16
greedy tokens equal, an empty prompt included; a checkpoint directory
(HF layout written by the port, a byte-level BPE ``tokenizer.json``
trained by ``tokenizers``) loaded by both, also in bfloat16, where the
dtypes of the states and the logits follow JAX's promotions; and a chat
over the port's HTTP server (max_tokens, a stop string, streamed) equal
to the JAX package's serving facade. The helpers serve
``tests/test_torch_rwkv.py`` too.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
pytest.importorskip("tokenizers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.config.app_config import AppConfig as JaxAppConfig  # noqa: E402
from localai_tpu.config.model_config import ModelConfig as JaxModelConfig  # noqa: E402
from localai_tpu.engine.scheduler import GenRequest as JaxGenRequest  # noqa: E402
from localai_tpu.models import mamba as jm  # noqa: E402
from localai_tpu.models import rwkv as jrw  # noqa: E402
from localai_tpu.models.mamba_serving import MambaServingModel as JaxServing  # noqa: E402
from localai_tpu_torch.api.server import APIServer  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import ConfigLoader  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models import mamba as tm  # noqa: E402
from localai_tpu_torch.models import rwkv as trw  # noqa: E402
from localai_tpu_torch.models.loader import write_checkpoint  # noqa: E402
from localai_tpu_torch.models.mamba_serving import MambaServingModel  # noqa: E402
from localai_tpu_torch.models.manager import ModelManager  # noqa: E402
from localai_tpu_torch.templates.cache import TemplateCache  # noqa: E402
from localai_tpu_torch.templates.chat import build_chat_prompt  # noqa: E402
from localai_tpu_torch.utils.device import params_from_numpy  # noqa: E402
from test_torch_tokenizer import LLAMA3_PATTERN, _byte_level_bpe  # noqa: E402

EOS = "<|endoftext|>"
# the HF config.json of each test model (vocabulary: the trained BPE's
# ids, the end token last)
HF = {
    "mamba": {"model_type": "mamba", "vocab_size": 320, "hidden_size": 32,
              "intermediate_size": 64, "num_hidden_layers": 2,
              "state_size": 8, "conv_kernel": 4, "time_step_rank": 4,
              "use_bias": False, "use_conv_bias": True,
              "layer_norm_epsilon": 1e-5},
    "rwkv": {"model_type": "rwkv", "vocab_size": 320, "hidden_size": 32,
             "attention_hidden_size": 32, "intermediate_size": 96,
             "num_hidden_layers": 3, "layer_norm_epsilon": 1e-5},
}
MODS = {"mamba": (jm, tm), "rwkv": (jrw, trw)}


def configs(kind: str):
    j, t = MODS[kind]
    cls = "MambaConfig" if kind == "mamba" else "RwkvConfig"
    return getattr(j, cls).from_hf(HF[kind]), getattr(t, cls).from_hf(
        HF[kind])


def jax_tree(kind: str, seed: int = 0) -> dict:
    """The JAX package's random parameters as numpy, every vector and mix
    weight noised; Mamba gets its own head."""
    j, _ = MODS[kind]
    jcfg, _ = configs(kind)
    tree = {k: np.asarray(v) for k, v in
            j.init_params(jax.random.key(seed), jcfg).items()}
    rng = np.random.default_rng(seed)
    for k, v in tree.items():
        if v.ndim == 1 or "time_mix" in k:
            tree[k] = (v + 0.3 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    if kind == "mamba":
        tree["lm_head.weight"] = (0.05 * rng.standard_normal(
            (jcfg.vocab_size, jcfg.hidden_size))).astype(np.float32)
    return tree


def both(kind: str, seed: int = 0):
    tree = jax_tree(kind, seed)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            params_from_numpy(tree, "cpu"))


def full_logits(kind, params, cfg, ids, length=None, port=True):
    """(logits [B, L, V], states) of a fresh prefill on either package;
    ``length`` gates the reference's bucketed prefill."""
    j, t = MODS[kind]
    mod = t if port else j
    args = () if port else (length,)
    if kind == "mamba":
        return mod.forward_prefill(params, cfg, ids, *args)
    return mod.forward(params, cfg, ids, None, *args)


def step(kind, params, cfg, tok, states, port=True):
    j, t = MODS[kind]
    if kind == "mamba":
        return (t if port else j).forward_step(params, cfg, tok, states)
    logits, states = (t if port else j).forward(params, cfg, tok[:, None],
                                                 states)
    return logits[:, -1], states


def flat_states(kind, states) -> list:
    """A state list as numpy arrays, in a fixed order."""
    if kind == "mamba":
        return [np.asarray(x, np.float32) if not torch.is_tensor(x)
                else x.float().numpy() for pair in states for x in pair]
    out = []
    for s in states:
        for f in ("ffn_shift", "attn_shift", "num", "den", "mx"):
            x = getattr(s, f)
            out.append(x.float().numpy() if torch.is_tensor(x)
                       else np.asarray(x, np.float32))
    return out


def close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max()))


def states_close(kind, got, want, tol=1e-4):
    for a, b in zip(flat_states(kind, got), flat_states(kind, want),
                    strict=True):
        if kind == "rwkv":   # mx starts at -1e38: compare where it moved
            b = np.where(b < -1e30, -1e30, b)
            a = np.where(a < -1e30, -1e30, a)
        close(a, b, tol)


def check_prefill(kind, L):
    jp, tp = both(kind, L)
    jcfg, tcfg = configs(kind)
    ids = np.random.default_rng(L).integers(0, jcfg.vocab_size, (1, L))
    want, wst = full_logits(kind, jp, jcfg, jnp.asarray(ids), port=False)
    got, gst = full_logits(kind, tp, tcfg, torch.from_numpy(ids))
    close(got.numpy(), np.asarray(want))
    states_close(kind, gst, wst)


def check_bucketed(kind, length, bucket):
    """The reference right-pads to ``bucket`` and gates the state with
    ``length``; the port's prefill of the true length gives the same
    states and logits."""
    jp, tp = both(kind, 3)
    jcfg, tcfg = configs(kind)
    ids = np.random.default_rng(length).integers(0, jcfg.vocab_size,
                                                 (1, bucket))
    ids[0, length:] = 0
    want, wst = full_logits(kind, jp, jcfg, jnp.asarray(ids), length,
                            port=False)
    got, gst = full_logits(kind, tp, tcfg, torch.from_numpy(ids[:, :length]))
    close(got.numpy(), np.asarray(want)[:, :length])
    states_close(kind, gst, wst)


def check_states_own_their_storage(kind):
    """The states a prefill returns hold only their own bytes: a view into
    the prefill's [L, ...] buffers would keep every position's activations
    of every layer alive while a stream decodes."""
    _, tp = both(kind, 2)
    _, tcfg = configs(kind)
    ids = torch.arange(40)[None] % tcfg.vocab_size
    _, states = full_logits(kind, tp, tcfg, ids)
    leaves = ([x for pair in states for x in pair] if kind == "mamba" else
              [getattr(s, f) for s in states
               for f in ("ffn_shift", "attn_shift", "num", "den", "mx")])
    for x in leaves:
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


def check_step(kind, L):
    jp, tp = both(kind, 5)
    jcfg, tcfg = configs(kind)
    ids = np.random.default_rng(9).integers(0, jcfg.vocab_size, (1, L + 1))
    full, _ = full_logits(kind, tp, tcfg, torch.from_numpy(ids))
    _, st = full_logits(kind, tp, tcfg, torch.from_numpy(ids[:, :L]))
    stepped, st2 = step(kind, tp, tcfg, torch.from_numpy(ids[:, L]), st)
    close(stepped.numpy(), full.numpy()[:, L])
    _, jst = full_logits(kind, jp, jcfg, jnp.asarray(ids[:, :L]), port=False)
    jstep, jst2 = step(kind, jp, jcfg, jnp.asarray(ids[:, L]), jst,
                       port=False)
    close(stepped.numpy(), np.asarray(jstep))
    states_close(kind, st2, jst2)


def lms(kind, seed=0, tokenizer=None):
    jp, tp = both(kind, seed)
    jcfg, tcfg = configs(kind)
    j, t = MODS[kind]
    cls = "MambaLM" if kind == "mamba" else "RwkvLM"
    return (getattr(j, cls)(jcfg, jp, tokenizer),
            getattr(t, cls)(tcfg, tp, tokenizer))


def check_greedy(kind, prompt):
    jlm, tlm = lms(kind, 3)
    want = jlm.generate(prompt, max_new_tokens=16, eos_ids=set())
    got = tlm.generate(prompt, max_new_tokens=16, eos_ids=set())
    assert got == want and len(set(got)) > 2


def write_recurrent_checkpoint(path, kind, tree=None, dtype=np.float32):
    """An HF checkpoint directory of the kind's test model: ``config.json``
    with the end token's id, the tensors (written by the port's writer),
    and a byte-level BPE trained by ``tokenizers``."""
    spec = _byte_level_bpe(LLAMA3_PATTERN, [EOS], 300)
    eos = next(t["id"] for t in spec["added_tokens"] if t["content"] == EOS)
    tree = tree if tree is not None else jax_tree(kind, 4)
    tensors = {k: torch.from_numpy(np.array(v, np.float32))
               for k, v in tree.items()}
    write_checkpoint(path, {**HF[kind], "eos_token_id": eos}, tensors)
    (path / "tokenizer.json").write_text(json.dumps(spec))
    return path


def check_checkpoint(tmp_path, kind):
    d = write_recurrent_checkpoint(tmp_path / kind, kind)
    j, t = MODS[kind]
    jlm = getattr(j, f"resolve_{kind}")(str(d))
    tlm = getattr(t, f"resolve_{kind}")(str(d), device="cpu")
    assert tlm.cfg.eos_token_id == jlm.cfg.eos_token_id == \
        tlm.tokenizer.token_to_id(EOS)
    text = "The model reads a prompt, writes its keys and values"
    prompt = tlm.tokenizer.encode(text)
    assert prompt == jlm.tokenizer.encode(text)
    assert tlm.generate(prompt, max_new_tokens=16) == jlm.generate(
        prompt, max_new_tokens=16)
    # by name under the models dir, as a YAML's ``model:`` names it
    assert getattr(t, f"resolve_{kind}")(
        kind, model_path=tmp_path, device="cpu").cfg == tlm.cfg
    with pytest.raises(FileNotFoundError, match="not found"):
        getattr(t, f"resolve_{kind}")("missing", tmp_path, device="cpu")


def check_bf16(tmp_path, kind, keep_f32):
    """A bfloat16 load keeps the reference's float32 tensors in float32
    and follows its promotions: the same state and logit dtypes, logits
    close to the reference's (bf16 roundings differ between the two
    libraries' kernels)."""
    d = write_recurrent_checkpoint(tmp_path / kind, kind)
    j, t = MODS[kind]
    jlm = getattr(j, f"resolve_{kind}")(str(d), dtype="bfloat16")
    tlm = getattr(t, f"resolve_{kind}")(str(d), dtype="bfloat16",
                                        device="cpu")
    for name, v in tlm.params.items():
        assert str(v.dtype).split(".")[-1] == str(jlm.params[name].dtype)
        assert (v.dtype == torch.float32) == keep_f32(name, v), name
    ids = np.asarray([tlm.tokenizer.encode("caches keep the hot set")])
    want, wst = full_logits(kind, jlm.params, jlm.cfg, jnp.asarray(ids),
                            port=False)
    got, gst = full_logits(kind, tlm.params, tlm.cfg, torch.from_numpy(ids))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    jl = [np.asarray(x) for x in jax.tree.leaves(wst)]
    tl = [x for x in (jax.tree.leaves([(s.ffn_shift, s.attn_shift, s.num,
                                        s.den, s.mx) for s in gst])
                      if kind == "rwkv" else [x for p in gst for x in p])]
    if kind == "rwkv":
        jl = [np.asarray(x) for s in wst for x in (
            s.ffn_shift, s.attn_shift, s.num, s.den, s.mx)]
    assert [str(x.dtype).split(".")[-1] for x in tl] == [
        str(x.dtype) for x in jl]
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    assert np.abs(a - b).max() <= 0.05 * np.abs(b).max()


def chat_matches_the_reference(tmp_path, kind):
    """``backend: <kind>`` from a YAML: the port's HTTP server answers a
    greedy chat with the JAX package's serving facade's text, under
    ``max_tokens``, a stop string (finish "stop") and streamed."""
    import urllib.request

    d = write_recurrent_checkpoint(tmp_path / "ckpt", kind)
    models = tmp_path / "models"
    models.mkdir()
    doc = {"name": "r", "backend": kind, "model": str(d),
           "engine": {"dtype": "float32"}}
    (models / "r.yaml").write_text(yaml.safe_dump(doc))
    loader = ConfigLoader(models)
    loader.load_from_path()
    server = APIServer(ModelManager(AppConfig(model_path=str(models),
                                              device="cpu"), loader),
                       "127.0.0.1", 0).start()
    messages = [{"role": "user", "content": "Tell me about the cache."}]
    prompt = build_chat_prompt(TemplateCache(models), loader.get("r"),
                               messages)
    jcfg = JaxModelConfig(**doc)
    ref = JaxServing(jcfg, JaxAppConfig(model_path=str(models)))

    def reference(max_tokens, stop=()):
        h = ref.scheduler.submit(JaxGenRequest(
            prompt=ref.tokenizer.encode(prompt, add_bos=True),
            max_new_tokens=max_tokens, temperature=0.0, stop=tuple(stop)))
        return h.result(60)

    def post(body):
        req = urllib.request.Request(
            server.url + "/v1/chat/completions",
            data=json.dumps({"model": "r", "messages": messages,
                             "temperature": 0, **body}).encode())
        return urllib.request.urlopen(req, timeout=120)

    try:
        want = reference(12)
        out = json.loads(post({"max_tokens": 12}).read())
        choice = out["choices"][0]
        assert choice["message"]["content"] == want.text
        assert choice["finish_reason"] == want.finish_reason == "length"
        assert out["usage"]["completion_tokens"] == 12
        assert out["usage"]["prompt_tokens"] == len(
            ref.tokenizer.encode(prompt, add_bos=True))
        stop = want.text[len(want.text) // 2:][:3]
        assert stop
        want = reference(12, [stop])
        out = json.loads(post({"max_tokens": 12, "stop": [stop]}).read())
        assert out["choices"][0]["message"]["content"] == want.text
        assert out["choices"][0]["finish_reason"] == want.finish_reason \
            == "stop"
        with post({"max_tokens": 12, "stream": True}) as r:
            frames = [json.loads(line[6:]) for line in r.read().split(b"\n")
                      if line.startswith(b"data: {")]
        text = "".join(f["choices"][0]["delta"].get("content") or ""
                       for f in frames if f["choices"])
        assert text == reference(12).text
        sm = server.manager.get("r")
        assert isinstance(sm, MambaServingModel)
        assert sm.scheduler.metrics()["total_generated_tokens"] >= 24
        assert not sm.busy and sm.alive()
    finally:
        server.shutdown()


# -- Mamba -----------------------------------------------------------------


def test_config_from_hf_equals_the_reference():
    for hf in (HF["mamba"], {"hidden_size": 2560, "time_step_rank": "auto"},
               {}, {"eos_token_id": None, "intermediate_size": 100}):
        assert tm.MambaConfig.from_hf(hf).__dict__ == \
            jm.MambaConfig.from_hf(hf).__dict__
    assert tm.MambaConfig.from_hf({"hidden_size": 2560}).time_step_rank \
        == 160


@pytest.mark.parametrize("L", [1, 3, 16, 17, 40])
def test_prefill_logits_and_states_equal_the_reference(L):
    check_prefill("mamba", L)


@pytest.mark.parametrize("length,bucket", [(3, 16), (11, 16), (16, 16),
                                           (17, 32)])
def test_bucketed_prefill_equals_the_true_length(length, bucket):
    check_bucketed("mamba", length, bucket)


@pytest.mark.parametrize("L", [1, 2, 8])
def test_step_equals_the_prefill_at_the_next_position(L):
    check_step("mamba", L)


def test_prefill_states_own_their_storage():
    check_states_own_their_storage("mamba")


@pytest.mark.parametrize("prompt", [[], [7], [5, 9, 11], list(range(1, 30))],
                         ids=["empty", "one", "shorter-than-k", "long"])
def test_greedy_tokens_equal_the_reference(prompt):
    check_greedy("mamba", prompt)


def test_generate_stops_on_eos_and_reports_each_token():
    jlm, tlm = lms("mamba", 6)
    free = tlm.generate([3, 4], max_new_tokens=16, eos_ids=set())
    seen = []
    got = tlm.generate([3, 4], max_new_tokens=16, eos_ids={free[5]},
                       on_token=seen.append)
    assert got == seen == free[:free.index(free[5])]
    assert got == jlm.generate([3, 4], max_new_tokens=16,
                               eos_ids={free[5]})


def test_seeded_sampling_repeats_itself():
    """Sampling draws from a ``torch.Generator`` seeded with ``seed``: a
    seed repeats its stream (the JAX package's threefry bits are another
    stream: seeded streams agree in distribution only)."""
    _, tlm = lms("mamba", 6)
    a = tlm.generate([1, 2, 3], max_new_tokens=16, temperature=1.0, seed=5,
                     eos_ids=set())
    b = tlm.generate([1, 2, 3], max_new_tokens=16, temperature=1.0, seed=5,
                     eos_ids=set())
    c = tlm.generate([1, 2, 3], max_new_tokens=16, temperature=1.0, seed=6,
                     eos_ids=set())
    assert a == b != c


def test_checkpoint_dir_loads_as_the_reference(tmp_path):
    check_checkpoint(tmp_path, "mamba")


def test_bf16_dtypes_follow_the_reference(tmp_path):
    check_bf16(tmp_path, "mamba", lambda name, t: tm.keeps_float32(name))


def test_debug_preset_and_init_params():
    lm = tm.resolve_mamba("debug:mamba-tiny", seed=1, device="cpu")
    assert lm.cfg.__dict__ == jm.MambaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, state_size=8,
        conv_kernel=4, num_layers=2, time_step_rank=4,
        eos_token_id=257).__dict__
    ref = {k: np.asarray(v) for k, v in jm.init_params(
        jax.random.key(0), jm.MambaConfig(**lm.cfg.__dict__)).items()}
    assert set(lm.params) == set(ref)
    for k, v in lm.params.items():
        assert tuple(v.shape) == ref[k].shape, k
        if ref[k].std() == 0:          # the constants are the reference's
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6)
    b = tm.init_params(lm.cfg, torch.Generator().manual_seed(0), "cpu",
                       dtype="bfloat16")
    assert b["backbone.layers.0.mixer.A_log"].dtype == torch.float32
    assert b["backbone.layers.0.mixer.in_proj.weight"].dtype == \
        torch.bfloat16


def test_chat_over_http_matches_the_reference(tmp_path):
    chat_matches_the_reference(tmp_path, "mamba")


def test_serving_facade_finish_reasons(tmp_path):
    """Cancelled mid-stream → "cancelled"; a model that raises → "error"
    (the API answers 502); ``ignore_eos`` runs to the budget; the facade
    has the surface the API reads and no llama runner."""
    mcfg = ModelConfig(name="m", backend="mamba", model="debug:mamba-tiny")
    sm = MambaServingModel(mcfg, AppConfig(device="cpu",
                                           model_path=str(tmp_path)))
    assert (sm.vision, sm.image_token_id, sm.name) == (None, 0, "m")
    assert not hasattr(sm, "runner") and sm.templates is not None
    h = sm.scheduler.submit(GenRequest(prompt=[1, 2], max_new_tokens=64,
                                       temperature=0.0, ignore_eos=True))
    h.cancel()
    assert h.result(30).finish_reason in ("cancelled", "length")
    h = sm.scheduler.submit(GenRequest(prompt=[1, 2], max_new_tokens=9,
                                       temperature=0.0, ignore_eos=True))
    assert h.result(30).finish_reason == "length"
    assert len(h.token_ids) == 9

    def boom(*a, **k):
        raise RuntimeError("device lost")

    sm.lm.generate = boom
    h = sm.scheduler.submit(GenRequest(prompt=[1], max_new_tokens=4))
    assert h.result(30).finish_reason == "error" and h.text == ""
    assert sm.engine_metrics()["type"] == "mamba"
    sm.close()
    assert not sm.alive()


REQUESTS = {
    "plain": ("/v1/chat/completions", {}),
    "tools": ("/v1/chat/completions", {"tools": [{"type": "function",
              "function": {"name": "get_weather", "parameters": {
                  "type": "object", "properties": {
                      "city": {"type": "string"}}}}}]}),
    "tool-choice-required": ("/v1/chat/completions", {
        "tool_choice": "required", "tools": [{"type": "function",
        "function": {"name": "ping", "parameters": {"type": "object"}}}]}),
    "json-object": ("/v1/chat/completions",
                    {"response_format": {"type": "json_object"}}),
    "n-2": ("/v1/chat/completions", {"n": 2}),
    "completion-echo": ("/v1/completions", {"prompt": "The cache",
                                            "echo": True}),
    "grammar": ("/v1/chat/completions", {"grammar": "root ::= \"x\""}),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_requests_answer_as_the_reference_server(tmp_path, name):
    """Both HTTP servers over one ``backend: mamba`` YAML: the same status
    and the same greedy choices. A constraint (tools, ``tool_choice``,
    JSON mode) is built and then ignored by the recurrent engine on both,
    ``n`` and ``echo`` need no llama runner; a raw ``grammar`` is the
    port's own 400 (the JAX package reads it nowhere)."""
    import urllib.error
    import urllib.request

    from test_api import _ServerThread, make_state

    kind = "mamba"
    d = write_recurrent_checkpoint(tmp_path / "ckpt", kind)
    models = tmp_path / "models"
    models.mkdir()
    (models / "r.yaml").write_text(yaml.safe_dump(
        {"name": "r", "backend": kind, "model": str(d),
         "parameters": {"max_tokens": 6, "temperature": 0}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    port = APIServer(ModelManager(AppConfig(model_path=str(models),
                                            device="cpu"), loader),
                     "127.0.0.1", 0).start()
    ref = _ServerThread(make_state(models))
    path, extra = REQUESTS[name]
    body = {"model": "r", "max_tokens": 6, "temperature": 0, **extra}
    if path.endswith("chat/completions"):
        body["messages"] = [{"role": "user", "content": "weather in Oslo?"}]

    def post(base):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        got, want = post(port.url), post(ref.base)
        if name == "grammar":
            assert got[0] == 400 and want[0] == 200
            return
        assert got[0] == want[0] == 200
        strip = [{k: v for k, v in c.items() if k != "logprobs"}
                 for c in want[1]["choices"]]
        assert got[1]["choices"] == strip
        assert got[1]["usage"] == want[1]["usage"]
    finally:
        ref.stop()
        port.shutdown()
