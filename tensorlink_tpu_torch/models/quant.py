"""Weight-only int8 and int8/int4 KV quantization (port of
``tensorlink_tpu/models/quant.py``).

``QTensor`` holds an int8 weight and its per-output-channel f32 scale;
:func:`matmul` is the one seam every weight product goes through, so a
``quantize_params`` tree serves unchanged. ``quantize_kv``/``quantize_kv4``
quantize KV rows headed into the paged cache (engine/paged.py) with one
f32 scale per (position, head); int4 packs two values per byte in the
SPLIT-HALF layout: byte ``j`` of a packed row holds element ``j`` in its
low nibble and element ``j + hd/2`` in its high nibble.

Every expression runs in the JAX order (f32 division by the scale, round
half to even, clip, then the integer cast), so codes, packed bytes and
scales equal the JAX package's bit for bit on the same input.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..parallel.mesh import REPLICATED, Sharded, Split, put


@dataclass
class QTensor:
    """int8 weight + broadcastable scale; ``q * scale ≈ original``."""

    q: torch.Tensor  # int8, original shape
    scale: torch.Tensor  # f32, broadcastable to q (per out-channel)

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def to(self, device) -> "QTensor":
        return QTensor(q=self.q.to(device), scale=self.scale.to(device))


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric int8 reducing only the contraction axis (second-to-last):
    ``[in, out]`` gets scales ``[1, out]``, a layer-stacked ``[L, in,
    out]`` weight ``[L, 1, out]``."""
    wf = w.float()
    amax = wf.abs().amax(dim=w.ndim - 2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(t: QTensor, dtype: torch.dtype = torch.bfloat16):
    return (t.q.float() * t.scale).to(dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a QTensor (dequantized on the fly, as
    the JAX expression: the int8 codes in x's dtype, then the scale) or a
    plain ``[in, out]`` tensor."""
    if isinstance(w, QTensor):
        y = x @ w.q.to(x.dtype)
        return y * w.scale.squeeze(-2).to(x.dtype)
    return x @ w


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``head_dim``: ``[..., hd] -> (int8 [..., hd],
    f32 scale [...])`` — one scale per (position, head), so a position's
    (codes, scale) pair depends only on its own KV row."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`."""
    return (q.float() * scale[..., None]).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int values in [-7, 7] ``[..., hd]`` (hd even) into nibbles
    ``[..., hd // 2]`` int8, split-half layout. The int32 → int8 cast of
    bytes above 127 wraps, as JAX's does."""
    h = q.shape[-1] // 2
    b = q.to(torch.int32)
    return ((b[..., :h] & 0xF) | ((b[..., h:] & 0xF) << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: nibbles ``[..., hd // 2]`` int8 back
    to sign-extended values ``[..., hd]`` int32 in [-8, 7]."""
    b = packed.to(torch.int32) & 0xFF
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1)


def quantize_kv4(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 over ``head_dim`` into packed pages: ``[..., hd] ->
    (int8 [..., hd // 2], f32 scale [...])`` at :func:`quantize_kv`'s
    per-(position, head) granularity, 15 levels."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -7, 7)
    return pack_int4(q), scale


def dequantize_kv4(packed: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv4`."""
    return (unpack_int4(packed).float() * scale[..., None]).to(dtype)


# Parameter-tree leaves quantized for serving: the large matmul weights.
# Norm scales, biases and qk-norm vectors stay exact.
_QUANT_LEAF_NAMES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router"}
)


def _quantize_placed(w: Sharded) -> QTensor:
    """A weight placed on a mesh quantized as the whole weight (its
    scale's maximum runs over the whole contraction axis): the codes
    placed like the weight, the scales split with the output columns over
    the tensor axis or, for a weight split along its input rows, whole
    (whole over fsdp: the forward joins the codes' fsdp pieces)."""
    qt = quantize_tensor(w.full())
    out_split = w.grid[0] > 1 and w.spec.dim == len(w.shape) - 1
    return QTensor(q=put(w.mesh, qt.q, w.spec),
                   scale=put(w.mesh, qt.scale,
                             Split(w.spec.dim, w.spec.axis) if out_split
                             else REPLICATED))


def quantize_params(params: dict, *, min_size: int = 1 << 16) -> dict:
    """Quantize the matmul weights of a parameter tree for serving.
    Embeddings and leaves under ``min_size`` elements stay full
    precision; an untied ``lm_head`` is quantized too. A tree placed on
    a mesh quantizes each weight as the whole, so its codes and scales
    are the unplaced tree's, placed (``_quantize_placed``)."""

    def quantize(node):
        if isinstance(node, Sharded):
            return _quantize_placed(node)
        return quantize_tensor(node)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, QTensor):  # idempotent
            return node
        if (
            name in _QUANT_LEAF_NAMES
            and len(getattr(node, "shape", ())) in (2, 3)
            and node.numel() >= min_size
        ):
            return quantize(node)
        return node

    out = dict(walk(params))
    head = params.get("lm_head")
    if (
        head is not None
        and not isinstance(head, QTensor)
        and len(getattr(head, "shape", ())) == 2
        and head.numel() >= min_size
    ):
        out["lm_head"] = quantize(head)
    return out


def quantized_bytes(params) -> int:
    """Actual parameter bytes of a (possibly quantized) tree."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, QTensor):
        return quantized_bytes(params.q) + quantized_bytes(params.scale)
    if isinstance(params, (torch.Tensor, Sharded)):
        return params.numel() * params.element_size()
    return 0


__all__ = [
    "QTensor", "dequantize", "dequantize_kv", "dequantize_kv4", "matmul",
    "pack_int4", "quantize_kv", "quantize_kv4", "quantize_params",
    "quantize_tensor", "quantized_bytes", "unpack_int4",
]
