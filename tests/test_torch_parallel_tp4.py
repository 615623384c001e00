"""Tensor parallelism end to end on the CPU at ``model=4``: the cases of
``test_torch_parallel_tp2`` over four gloo ranks (one leader in this
process, three spawned followers) against the JAX package's runner on
``MeshPlan(model=4)``. The ``q4`` model runs an int4 pool with float32
weights here; debug:small's int4 weights cannot be cut four ways (its
256-row ``wo`` leaves 64 rows a rank, half a scale group of 128), and
int4 weights that cannot be cut are refused at load, naming the shape,
where the JAX package's GSPMD programs serve them.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("aiohttp")

from test_torch_parallel_tp2 import (  # noqa: E402,F401
    make_servers,
    test_greedy_completions_equal_the_jax_mesh,
    test_speculation_runs_windows_on_the_mesh,
    test_tools_chat_equals_the_jax_mesh,
    test_embeddings_equal_the_jax_mesh,
    test_prefill_logits_equal_the_jax_forward,
)

import test_torch_parallel_tp2 as tp2  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402

servers = make_servers(4)


@pytest.fixture(autouse=True, scope="module")
def _width_four():
    # the refused load below fails on every follower too (counted)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp2, "WIDTH", 4)
        mp.setattr(tp2, "LOAD_ERRORS", 1)
        yield


def test_int4_weights_that_cannot_be_cut_are_refused(servers):
    """The leader's load fails naming the shape, each follower's load of
    the same YAML fails alike, and the group goes on serving (debug:tiny:
    its 64-row ``wo`` leaves 16 rows a rank, a quarter of a group)."""
    models = Path(servers[2].manager.app.model_path)
    doc = {"name": "q4w", "model": "debug:tiny", "context_size": 256,
           "engine": {**tp2.BASE, "kv_dtype": "int4",
                      "quantization": "int4"}}
    (models / "q4w.yaml").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="int4 weight of shape"):
        servers[2].manager._load(ModelConfig.from_dict(doc))
    # the group still serves
    out = tp2._post(servers[0] + "/v1/completions", {
        "model": "dense", "prompt": "still here", "max_tokens": 4,
        "temperature": 0})
    assert out["usage"]["completion_tokens"] > 0


# last: it stops the server
from test_torch_parallel_tp2 import (  # noqa: E402,F401
    test_followers_report_the_leaders_token_digest,
)
