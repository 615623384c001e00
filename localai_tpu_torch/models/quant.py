"""Int8 / int4 weight quantization for the llama engine.

Port of ``localai_tpu/models/quant.py``. Same recipes, bit for bit:

  * int8 (mode ``"w8"``): symmetric per output channel, scale =
    max|w| / 127 over the contraction axis, q = round(w / scale) in
    [-127, 127] (``torch.round`` rounds half to even, like ``jnp.round``).
  * int8_w8a8 (mode ``"w8a8"``): the int8 weight of ``"w8"``, and the
    activations quantized per token with :func:`quantize_lastdim` (the
    scaled int8 KV recipe); the int8 x int8 product accumulates in int32
    (:func:`int8_matmul`) and both scales are applied to the f32
    accumulator in the JAX package's order, so f32 results equal its
    bit for bit. The JAX package computes this product in XLA, outside
    any Pallas kernel, so the port takes the library's ``torch._int_mm``.
  * int4 (mode ``"w4"``): symmetric per (group of ``group`` contraction
    rows, output channel), scale = max|w| / 7, q in [-7, 7].

``matmul`` sends an eligible shape (``ops.qmatmul.eligible`` /
``w4_eligible``: 2-D, 128-aligned, M <= 256) to the kernel wrappers on
every device — the CUDA kernels for CUDA tensors, their plain versions on
the CPU. An ineligible shape (a long prefill chunk) computes the product
the JAX package computes there without a Pallas kernel:
``(x @ q.to(x.dtype)) * scale.to(x.dtype)``, or the per-group einsum for
w4.

Sparse-MoE expert stacks ([E, K, N] a layer) are per-channel int8 in
every mode, as in the JAX package. ``moe_up`` / ``moe_down`` send an
aligned stack to ``ops.qmatmul.w8_matmul_experts`` (K4, one launch per
projection, every row count); the JAX package's einsum over the
dequantized stack stays for unaligned debug widths and unquantized
stacks. On the card an aligned stack never takes that einsum: it would
write a bf16 copy of every expert matrix (2.8 GB a Mixtral-8x7B layer).

**w4 storage.** torch has no int4 dtype, so a w4 ``q`` is uint8 with two
nibbles per byte, packed along the contraction axis: byte i holds rows 2i
(low nibble) and 2i+1 (high nibble) of one output column, so a [K, N]
weight is stored [K/2, N]. Both rows of a byte fall in the same group
(groups are even), a warp reading a packed row along N stays coalesced,
and the kernel (``csrc/w4_matmul.cu``), its plain version and the weight
carrier (``llama.params_from_numpy``) all go through ``pack_w4`` /
``unpack_w4``, defined once in ``ops/qmatmul.py`` beside the kernel that
reads them. The int4 KV pool uses a different packing, the JAX
package's halves layout along the last axis (:func:`quantize_lastdim4`),
because its bytes are compared with JAX's byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch

from localai_tpu_torch.ops import qmatmul
from localai_tpu_torch.ops.qmatmul import pack_w4, unpack_w4
from localai_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight.

    q:     int8 with the weight's shape (w8, w8a8), or uint8 packed along
           ``axis`` (w4: that axis has half the rows, see :func:`pack_w4`).
    scale: f32. w8/w8a8: the weight's shape without ``axis`` (one scale
           per output channel). w4: ``axis`` kept at size K / group.
    axis:  the contraction axis of the logical weight.
    mode:  ``"w8"`` | ``"w8a8"`` | ``"w4"``.
    group: contraction rows per scale (w4); 0 for w8.

    A w8a8 matmul weight ([..., K, N], contracted over K) is stored
    column-major in its last two dims (:func:`_column_major`): its shape
    and values are the JAX package's, its memory the [N, K] layout in
    which ``torch._int_mm`` takes the weight 4-8x faster on the card
    than a row-major one.
    """

    q: torch.Tensor
    scale: torch.Tensor
    axis: int
    mode: str = "w8"
    group: int = 0

    def __post_init__(self) -> None:
        if self.mode == "w8a8" and self.axis == self.q.dim() - 2:
            self.q = _column_major(self.q)

    @property
    def shape(self) -> tuple[int, ...]:
        """The logical weight's shape (a w4 ``q`` holds half of ``axis``)."""
        shape = list(self.q.shape)
        if self.mode == "w4":
            shape[self.axis] *= 2
        return tuple(shape)

    def __getitem__(self, i: int) -> "QuantizedTensor":
        """Slice of a stacked [L, ...] weight along its leading axis (the
        layer loop's view of one layer)."""
        if self.axis == 0:
            raise IndexError("cannot slice the contraction axis")
        return QuantizedTensor(self.q[i], self.scale[i], self.axis - 1,
                               self.mode, self.group)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.axis, self.mode, self.group)


def _column_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` [..., K, N] with the same shape and values, stored as
    [..., N, K] in memory (a transposed view of a contiguous tensor);
    returned as it is when it is stored so already."""
    if q.stride(-2) == 1 and q.stride(-1) == q.shape[-2]:
        return q
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

# ``quantization`` settings and the mode of the matmul weights they give
QUANT_MODES = {"int8": "w8", "int8_w8a8": "w8a8", "int4": "w4"}


def quantize_tensor(w: torch.Tensor, axis: int,
                    mode: str = "w8") -> QuantizedTensor:
    """Symmetric per-channel int8: scale = amax|w| / 127 over ``axis``;
    ``mode`` "w8" or "w8a8" (the same bytes, another product)."""
    wf = w.float()
    scale = wf.abs().amax(dim=axis).clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale.unsqueeze(axis)).clamp(-127, 127).to(
        torch.int8)
    return QuantizedTensor(q=q, scale=scale, axis=axis, mode=mode)


def _group_size(K: int, group: int) -> int:
    """Largest divisor of K that is ≤ group (small debug dims stay exact)."""
    g = min(K, group)
    while K % g:
        g -= 1
    return g


def _quantize4(w: torch.Tensor, axis: int, g: int):
    """(int8 q in [-7, 7] with w's shape, f32 scale with ``axis`` at
    K/g) — the int4 recipe before packing."""
    wf = w.float()
    shape = tuple(wf.shape)
    K = shape[axis]
    grouped = wf.reshape(shape[:axis] + (K // g, g) + shape[axis + 1:])
    scale = grouped.abs().amax(dim=axis + 1).clamp(min=1e-8) / 7.0
    q = torch.round(grouped / scale.unsqueeze(axis + 1)).clamp(-7, 7).to(
        torch.int8)
    return q.reshape(shape), scale


def quantize_tensor4(w: torch.Tensor, axis: int,
                     group: int = 128) -> QuantizedTensor:
    """Symmetric group-wise int4 over ``axis`` in groups of ``group`` rows
    (``_group_size`` for small dims); q comes back packed (pack_w4)."""
    g = _group_size(w.shape[axis], group)
    q, scale = _quantize4(w, axis, g)
    return QuantizedTensor(q=pack_w4(q, axis), scale=scale, axis=axis,
                           mode="w4", group=g)


def quantize_lastdim(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 over the last axis: x [..., K] →
    (q int8 [..., K], scale f32 [...]). The scaled int8 KV pool recipe."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_lastdim4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int4 over the last axis, nibble-packed in the
    halves layout: x [..., K] (K even) → (int8 [..., K/2], scale f32
    [...]). Byte i holds element i in its low nibble and element i + K/2
    in its high nibble — the int4 KV pool's bytes, equal to JAX's."""
    if x.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last dim, got "
                         f"{tuple(x.shape)}")
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 7.0
    q = torch.round(xf / scale[..., None]).clamp(-7, 7).to(torch.int8)
    half = q.shape[-1] // 2
    packed = (q[..., :half] & 0x0F) | (q[..., half:] << 4)
    return packed, scale


def unpack_int4_lastdim(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of the :func:`quantize_lastdim4` packing: int8 [..., K/2] →
    int8 [..., K] in [-8, 7]."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.cat([lo, hi], dim=-1)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def dequantize_tensor(qt: QuantizedTensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if qt.mode == "w4":
        q = unpack_w4(qt.q, qt.axis)
        shape = tuple(q.shape)
        ax = qt.axis
        gc = qt.scale.shape[ax]
        grouped = q.reshape(shape[:ax] + (gc, shape[ax] // gc)
                            + shape[ax + 1:]).to(dtype)
        out = grouped * qt.scale.unsqueeze(ax + 1).to(dtype)
        return out.reshape(shape)
    return qt.q.to(dtype) * qt.scale.unsqueeze(qt.axis).to(dtype)


# torch._int_mm on a CUDA tensor takes more than 16 rows of x, and K and N
# multiples of 8: int8_matmul pads every product to these rules
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor,
                transpose_w: bool = False) -> torch.Tensor:
    """Exact int8 x int8 product, accumulated in int32: xq [M, K] against
    wq [K, N] (``transpose_w``: wq is [N, K] and the product takes its
    transpose). The library's ``torch._int_mm`` on both devices, every
    shape brought to its CUDA rules by zero padding, which adds nothing
    to the kept sums:

      * fewer than ``INT_MM_MIN_ROWS`` rows of x (decode): zero rows;
      * K off a multiple of 8: zero columns of x and zero rows of a copy
        of w (no served model has such a K);
      * N off a multiple of 8 (a vocabulary of 32001 ids in the lm_head
        or a tied table): the aligned columns are a view of w as it is
        stored, and the last 1-7 columns a copy padded with zeros to 8,
        product of its own.
    """
    w = wq.t() if transpose_w else wq
    M, K = xq.shape
    N = w.shape[1]
    if K % INT_MM_ALIGN:
        pad = -K % INT_MM_ALIGN
        xq = torch.cat([xq, xq.new_zeros(M, pad)], dim=1)
        w = torch.cat([w, w.new_zeros(pad, N)])
    if M < INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(INT_MM_MIN_ROWS - M, xq.shape[1])])
    n_al = N - N % INT_MM_ALIGN
    parts = [torch._int_mm(xq, w[:, :n_al])] if n_al else []
    if n_al < N:
        tail = w.new_zeros(INT_MM_ALIGN, w.shape[0]).t()   # column-major
        tail[:, :N - n_al] = w[:, n_al:]
        parts.append(torch._int_mm(xq, tail)[:, :N - n_al])
    acc = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return acc[:M]


def int8_matmul_ref(xq: torch.Tensor, wq: torch.Tensor,
                    transpose_w: bool = False) -> torch.Tensor:
    """:func:`int8_matmul`'s plain version on any device: the product in
    float64, exact while |sum| < 2**53 (int8 x int8 over any K a model
    has), as int32."""
    w = wq.t() if transpose_w else wq
    return (xq.double() @ w.double()).to(torch.int32)


def _w8a8(x: torch.Tensor, w: "QuantizedTensor",
          transpose_w: bool) -> torch.Tensor:
    """x @ w (or w.T) for a w8a8 weight, in the JAX package's arithmetic:
    x quantized per token, the int32 product in f32, times x's scale,
    times the weight's per-output-channel scale, cast to x's dtype."""
    xq, xs = quantize_lastdim(x)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), w.q, transpose_w)
    acc = acc.reshape(*x.shape[:-1], acc.shape[-1]).float()
    return (acc * xs[..., None] * w.scale).to(x.dtype)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for plain or quantized [K, N] weights."""
    if not isinstance(w, QuantizedTensor):
        return x @ w
    if w.mode == "w8a8":   # before K4: a w8a8 weight never reaches it
        return _w8a8(x, w, transpose_w=False)
    lead = x.shape[:-1]
    if w.mode == "w4":
        if qmatmul.w4_eligible(x.shape, w.q, w.scale):
            y = qmatmul.w4_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale)
            return y.reshape(*lead, y.shape[-1])
        q = unpack_w4(w.q, w.axis)
        K, N = q.shape[-2], q.shape[-1]
        gc = w.scale.shape[-2]
        wg = q.reshape(gc, K // gc, N).to(x.dtype)
        xg = x.reshape(*lead, gc, K // gc)
        acc = torch.einsum("...gk,gkn->...gn", xg, wg)
        return (acc * w.scale.to(x.dtype)).sum(-2)
    if qmatmul.eligible(x.shape, w.q, w.scale, transpose_w=False):
        y = qmatmul.w8_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale)
        return y.reshape(*lead, y.shape[-1])
    return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)


def matmul_t(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w.T (tied-embedding lm_head). Per-row scales become per-output-
    column scales under the transpose. Embedding tables stay per-row int8
    in int4 mode too, so there is no w4 branch."""
    if not isinstance(w, QuantizedTensor):
        return x @ w.T.to(x.dtype)
    if w.mode == "w8a8":
        return _w8a8(x, w, transpose_w=True)
    if w.mode != "w8":
        raise ValueError(f"matmul_t takes per-row int8 tables, got {w.mode}")
    if qmatmul.eligible(x.shape, w.q, w.scale, transpose_w=True):
        y = qmatmul.w8_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale,
                              transpose_w=True)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return (x @ w.q.T.to(x.dtype)) * w.scale.to(x.dtype)


def moe_up(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., D] against an expert stack w [E, D, F] → [..., E, F]."""
    if not isinstance(w, QuantizedTensor):
        return torch.einsum("...d,edf->...ef", x, w)
    lead = x.shape[:-1]
    if qmatmul.experts_eligible(tuple(x.shape), w.q, w.scale):
        y = qmatmul.w8_matmul_experts(x.reshape(-1, x.shape[-1]), w.q,
                                      w.scale)
        return y.reshape(*lead, *y.shape[1:])
    acc = torch.einsum("...d,edf->...ef", x, w.q.to(x.dtype))
    return acc * w.scale.to(x.dtype)          # scale [E, F]


def moe_down(a: torch.Tensor, w: Any) -> torch.Tensor:
    """a [..., E, F] against an expert stack w [E, F, D] → [..., E, D]."""
    if not isinstance(w, QuantizedTensor):
        return torch.einsum("...ef,efd->...ed", a, w)
    lead = a.shape[:-2]
    if qmatmul.experts_eligible(tuple(a.shape), w.q, w.scale):
        y = qmatmul.w8_matmul_experts(
            a.reshape(-1, *a.shape[-2:]).contiguous(), w.q, w.scale)
        return y.reshape(*lead, *y.shape[1:])
    acc = torch.einsum("...ef,efd->...ed", a, w.q.to(a.dtype))
    return acc * w.scale.to(a.dtype)          # scale [E, D]


def embed_rows(w: Any, tokens: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather for plain or per-row-quantized tables."""
    if isinstance(w, QuantizedTensor):
        return w.q[tokens].to(dtype) * w.scale[tokens][..., None].to(dtype)
    return w[tokens].to(dtype)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

# which params get quantized, and the contraction axis of each stacked
# [L, K, N] layer weight; norm gains, qkv biases and the MoE router
# (``moe_gate``, in the compute dtype) stay as they are
_LAYER_AXES = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 1,
    "w_gate": 1, "w_up": 1, "w_down": 1,
}
_EXPERTS = ("w_gate", "w_up", "w_down")


def quantize_layer(name: str, w: torch.Tensor, mode: str, group: int = 128
                   ) -> Any:
    """One layer's slice of stacked weight ``name`` (``w`` without the
    L axis) as ``quantize_params`` quantizes it: an expert stack [E, K, N]
    per-channel int8 (w8) over K in every mode; another matmul weight
    [K, N] int8, int8 for w8a8 or group-wise int4 over K (``mode``
    "int8" / "int8_w8a8" / "int4"); the rest (norms, biases, the router)
    as it is. Scales of one [E, K] slice depend on that slice alone, so
    quantizing layer by layer as a checkpoint is read gives the bytes of
    quantizing the whole stack."""
    if name not in _LAYER_AXES:
        return w
    if name in _EXPERTS and w.dim() == 3:
        return quantize_tensor(w, 1)
    if mode == "int4":
        return quantize_tensor4(w, 0, group)
    return quantize_tensor(w, 0, QUANT_MODES[mode])


def quantize_table(w: torch.Tensor, axis: int, mode: str,
                   group: int = 128) -> QuantizedTensor:
    """The embedding table (``axis`` 1, per row) or lm_head (``axis`` 0,
    per output column) as ``quantize_params`` quantizes it: int8 in the
    mode's product, except that the embedding stays w8 in int4 mode (the
    gather and the tied logits keep their exact per-channel form) while
    the lm_head goes group-wise int4."""
    if mode == "int4":
        return (quantize_tensor(w, axis) if axis == 1
                else quantize_tensor4(w, axis, group))
    return quantize_tensor(w, axis, QUANT_MODES[mode])


def stack_layers(parts: Iterable[Any], n: int) -> Any:
    """Stack ``n`` per-layer slices (tensors, or ``QuantizedTensor``
    slices of one kind) along a new leading L axis, into storage
    allocated at the first slice and filled as the slices come: the slices
    are never held beside the stack."""
    out = None
    for i, p in enumerate(parts):
        if isinstance(p, QuantizedTensor):
            if out is None:
                q = p.q.new_empty((n, *p.q.shape))
                if p.q.dim() == 2 and p.q.stride(0) == 1:
                    # a column-major slice: column-major storage (no copy)
                    q = p.q.new_empty((n, p.q.shape[1],
                                       p.q.shape[0])).transpose(1, 2)
                out = QuantizedTensor(q,
                                      p.scale.new_empty((n, *p.scale.shape)),
                                      p.axis + 1, p.mode, p.group)
            out.q[i] = p.q
            out.scale[i] = p.scale
        else:
            if out is None:
                out = p.new_empty((n, *p.shape))
            out[i] = p
    return out


def quantized_spec(spec: tuple, axis: int, grouped: bool = False) -> tuple:
    """The scale's sharding spec (``parallel.sharding``: a tuple, one
    entry a dimension) from the weight's: drop the contracted axis
    (per-channel int8) or keep it (group-wise w4: the scale's group axis
    tiles the weight's contraction axis, so it is cut the same way). A
    tensor-parallel rank then keeps the scales of its output channels
    beside them, and of its K rows' groups."""
    if grouped:
        return tuple(spec)
    entries = list(spec)
    while len(entries) < axis + 1:
        entries.append(None)
    del entries[axis]
    return tuple(entries)


def quantize_params(params: dict, mode: str = "int8", group: int = 128,
                    device: str | torch.device | None = "cuda") -> dict:
    """Quantize a llama parameter tree's matmul weights onto ``device``.

    embed goes per-row int8 (axis 1) in every mode, so the gather and the
    tied-embedding logits stay exact per channel; lm_head per output
    column (axis 0, or group-wise int4 over D); stacked layer weights over
    their K axis; expert stacks [L, E, K, N] per-channel int8 (w8) over K
    (axis 2) in every mode, as in the JAX package. ``mode``: ``"int8"``,
    ``"int8_w8a8"`` (embed, lm_head and layer matmuls in mode w8a8) or
    ``"int4"``."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unsupported quantization mode {mode!r} (want "
                         f"one of {sorted(QUANT_MODES)})")
    device = resolve_device(device)
    out = dict(params)
    out["embed"] = quantize_table(params["embed"].to(device), 1, mode, group)
    if "lm_head" in params:
        out["lm_head"] = quantize_table(params["lm_head"].to(device), 0, mode,
                                        group)
    layers = {}
    for name, w in params["layers"].items():
        # one layer slice at a time: no f32 copy of a whole stack exists
        layers[name] = (stack_layers((quantize_layer(
            name, w[i].to(device), mode, group) for i in range(len(w))),
            len(w)) if name in _LAYER_AXES else w.to(device))
    out["layers"] = layers
    out["final_norm"] = params["final_norm"].to(device)
    return out
