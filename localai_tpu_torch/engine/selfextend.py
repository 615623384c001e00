"""Self-extend / group attention: serving beyond the trained context.

Port of ``localai_tpu/engine/selfextend.py``. The KV cache stays UNroped
in self-extend mode (``models.llama.forward`` runs with the identity
table of :func:`identity_rope`), and every attention site computes BOTH
score sets, merged by relative distance:

  neighbor score : rope(p) . rope(j)                       where p - j <  ga_w
  grouped score  : rope(p//g + ga_w - ga_w//g) . rope(j//g)   otherwise

for query position p, key position j and g = ga_n. The query shift
``ga_w - ga_w // ga_n`` keeps the two branches continuous at the window
edge (arXiv:2401.01325), clamped to the table's last row as the JAX
package's gather clamps it. The attention kernels (K1–K3) assume
pre-roped K, so these sites run this plain attention, as the JAX package
runs its XLA attend.

Queries are processed in chunks of rows (:data:`SCORE_BYTES` bounds one
chunk's f32 score set): the same function, whose one-pass form would hold
[1, 8, 4, 16384, 16384] f32 scores per set (34 GB) for a 12k-token
prompt in a 16384 bucket at Llama-3-8B's heads. Keys are rotated once
per call, outside the chunk loop.
"""

from __future__ import annotations

import math

import torch

from localai_tpu_torch.models import llama as mdl
from localai_tpu_torch.models.llama import LlamaConfig

# bytes of one query chunk's f32 score set [S, Hq, rows, C]
SCORE_BYTES = 1 << 29


def identity_rope(rope) -> tuple[torch.Tensor, torch.Tensor]:
    """A (cos=1, sin=0) table shaped like ``rope``: ``forward`` then
    leaves q/k unrotated, and the self-extend attend applies all
    rotations itself."""
    cos, sin = rope
    return torch.ones_like(cos), torch.zeros_like(sin)


def build_attend(cfg: LlamaConfig, rope, ga_n: int, ga_w: int,
                 qpos: torch.Tensor, kpos: torch.Tensor):
    """attend(q, keys, values, mask) for the plain attention sites.

    q [S, T, Hq, hd] and keys/values [S, Hkv, C, hd] arrive UNroped;
    qpos [S, T] / kpos [C] are absolute positions; mask [S, T, C] bool is
    the normal causal/validity mask. A chunk takes as many query rows as
    :data:`SCORE_BYTES` allows."""
    cos_t, sin_t = rope
    limit = cos_t.shape[0] - 1
    shift = ga_w - ga_w // ga_n
    qpos, kpos = qpos.long(), kpos.long()

    def rope_q(x, pos):                       # x [S, t, Hq, hd], pos [S, t]
        return mdl.apply_rope(x, cos_t[pos][:, :, None, :],
                              sin_t[pos][:, :, None, :])

    def rope_k(keys, pos):                    # keys [S, Hkv, C, hd], pos [C]
        return mdl.apply_rope(keys, cos_t[pos][None, None],
                              sin_t[pos][None, None])

    def attend(q, keys, values, mask):
        S, T = q.shape[0], q.shape[1]
        Hkv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.hd
        C = keys.shape[2]
        k_n = rope_k(keys, kpos)
        k_g = rope_k(keys, kpos // ga_n)
        rows = max(1, SCORE_BYTES // (4 * S * Hkv * g * C))
        out = []
        for t0 in range(0, T, rows):
            t1 = min(T, t0 + rows)
            qc, pc = q[:, t0:t1], qpos[:, t0:t1]

            def scores(qr, kr):
                qg = qr.reshape(S, t1 - t0, Hkv, g, hd)
                return torch.einsum("stkgh,sklh->skgtl", qg, kr) \
                    / math.sqrt(hd)

            s_n = scores(rope_q(qc, pc), k_n)
            q_g = (pc // ga_n + shift).clamp(max=limit)
            s_g = scores(rope_q(qc, q_g), k_g)
            dist = pc[:, :, None] - kpos[None, None, :]       # [S, t, C]
            s = torch.where((dist < ga_w)[:, None, None], s_n, s_g).float()
            s = s.masked_fill(~mask[:, None, None, t0:t1], -1e30)
            probs = torch.softmax(s, dim=-1).to(values.dtype)
            out.append(torch.einsum("skgtl,sklh->stkgh", probs, values))
        return torch.cat(out, dim=1).reshape(S, T, cfg.num_heads, hd)

    return attend
