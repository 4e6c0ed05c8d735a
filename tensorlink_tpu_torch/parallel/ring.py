"""Ring attention — sequence parallelism over a ``seq`` mesh axis — and
the quantized collectives (port of ``tensorlink_tpu/parallel/ring.py``).

Long sequences are split over the ``seq`` axis and attention runs as a
ring:

- each device holds its query, key and value blocks ``[B, T/n, H, hd]``;
- the K/V blocks and their global start offsets rotate around the ring
  in a fixed device order, ``n`` steps (device ``i`` holds block ``(i -
  r) mod n`` at step ``r``, the block ``lax.ppermute`` hands it there);
  each hop is :func:`~.mesh.to_device`, so on one card a hop is free and
  over cards it is a peer copy;
- each device accumulates flash-style blockwise softmax statistics in
  float32 (running max, normalizer, weighted values);
- causal masking is global-position arithmetic on the rotating offsets;
  a block wholly in a query block's future is skipped, which leaves every
  accumulator bitwise as computing it would (its weights are exactly 0);
- GQA contracts the un-repeated K/V heads (``[B, S, n_kv, group, hd]``).

The JAX ring has no Pallas kernel: its blocks are ``jnp.einsum``
products, and here they are the same products in PyTorch, as every
product the JAX package computes outside a Pallas kernel is.

**Quantized collectives** (EQuARX, the KV-cache quantization applied to
the wire): ``ring_attention(..., quantized=True)`` rotates int8 K/V
blocks with per-row float32 scales, each block quantized once on its own
device (``models/quant.py::quantize_kv``), so the hop count never
compounds the error. :func:`quantized_all_gather` and
:func:`quantized_psum` are the gather and the all-reduce over explicit
shards — a list of each participant's tensor in mesh order, as the
port's tensor-parallel paths hold them: every shard is quantized once,
its codes and scales cross to the reading device, and there it is
dequantized with its own scales and concatenated, stacked or summed in
float32 in mesh order. Every participant therefore computes the same
bits, whichever device reads, as in JAX (tests/test_ring.py's bounds).
"""

from __future__ import annotations

import torch

from .mesh import Mesh, Sharded, Split, put, to_device

NEG_INF = -1e30

__all__ = [
    "quantize_shards",
    "quantized_all_gather",
    "quantized_psum",
    "ring_attention",
    "ring_blocks",
    "sequence_sharded",
]


# ---------------------------------------------------------------------------
# Quantized collectives: int8 over the wire, float32 reduction
# ---------------------------------------------------------------------------


def _quant_chunk(x: torch.Tensor) -> tuple:
    """Symmetric int8 over the last axis with per-row float32 scales, the
    paged KV cache's granularity (``models/quant.py::quantize_kv``)."""
    from ..models.quant import quantize_kv

    return quantize_kv(x)


def _dequant_chunk(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The float32 view of a quantized chunk."""
    return q.float() * scale[..., None]


def quantize_shards(parts: list) -> list:
    """Each shard's ``(codes, scales, dtype)``, quantized once on its own
    device: what crosses the wire to every reader."""
    return [(*_quant_chunk(p), p.dtype) for p in parts]


def _arrived(quantized: list, device) -> list:
    """Each quantized shard dequantized on ``device`` with its own
    scales, in its own dtype."""
    return [_dequant_chunk(to_device(q, device), to_device(s, device)).to(dt)
            for q, s, dt in quantized]


def quantized_all_gather(parts: list, device, *, axis: int = 0,
                         tiled: bool = False,
                         quantized: list | None = None) -> torch.Tensor:
    """JAX's ``quantized_all_gather`` over explicit shards: the shards
    ``parts`` (mesh order) gathered on ``device`` with an int8 payload.
    ``tiled`` concatenates them along ``axis`` (the tensor-parallel
    reassembly of an activation split along a feature axis), else they
    stack along a new dimension at ``axis``. ``quantized`` reuses
    :func:`quantize_shards` of ``parts`` (a gather read on several
    devices quantizes each shard once)."""
    chunks = _arrived(quantized or quantize_shards(parts), device)
    if tiled:
        return torch.cat(chunks, dim=axis) if len(chunks) > 1 else chunks[0]
    return torch.stack(chunks, dim=axis)


def quantized_psum(parts: list, device, *,
                   quantized: list | None = None) -> torch.Tensor:
    """JAX's ``quantized_psum`` over explicit shards: each shard
    quantized once, dequantized on ``device`` and summed in float32 in
    mesh order (shard 0 first), then cast to the shards' dtype — the
    same bits on every reader and every run, where a ring reduction's
    order could vary with the device's place in the ring."""
    quantized = quantized or quantize_shards(parts)
    acc = None
    for q, s, _dt in quantized:
        x = _dequant_chunk(to_device(q, device), to_device(s, device))
        acc = x if acc is None else acc + x
    return acc.to(quantized[0][2])


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def _block_scores(qg: torch.Tensor, k: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Grouped-query scores. qg ``[B, Tq, Hkv, G, hd]``, k ``[B, Tk, Hkv,
    hd]`` → ``[B, Hkv, G, Tq, Tk]`` in float32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale


def ring_blocks(qs: list, ks: list, vs: list, *, scale: float,
                causal: bool = True, quantized: bool = False) -> list:
    """The ring over per-device blocks: ``qs[i]``/``ks[i]``/``vs[i]`` are
    block ``i`` of the sequence (``[B, T/n, H, hd]``, on device ``i`` of
    the ring); returns each device's attention output block there, in
    ``qs[i]``'s dtype. Differentiable (the backward runs the hops in
    reverse)."""
    n = len(qs)
    if quantized:
        wire = [(quantize_shards([k])[0], quantize_shards([v])[0])
                for k, v in zip(ks, vs)]
    outs = []
    for i, q in enumerate(qs):
        dev = q.device
        B, Tq, Hq, hd = q.shape
        Hkv = ks[i].shape[2]
        G = Hq // Hkv
        qg = q.reshape(B, Tq, Hkv, G, hd)
        q_pos = i * Tq + torch.arange(Tq, device=dev)
        m = torch.full((B, Hkv, G, Tq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Tq, Hkv, G, hd), dtype=torch.float32, device=dev)
        for r in range(n):
            j = (i - r) % n  # the block this device holds at step r
            Tk = ks[j].shape[1]
            start = j * Tk
            if causal and start > i * Tq + Tq - 1:
                continue  # wholly in the future: every weight is 0
            if quantized:
                (k8, k_s, _), (v8, v_s, _) = wire[j]
                k_blk = _dequant_chunk(to_device(k8, dev), to_device(k_s, dev))
                v_blk = _dequant_chunk(to_device(v8, dev), to_device(v_s, dev))
            else:
                k_blk, v_blk = to_device(ks[j], dev), to_device(vs[j], dev)
            s = _block_scores(qg, k_blk, scale)  # [B, Hkv, G, Tq, Tk]
            if causal:
                kv_pos = start + torch.arange(Tk, device=dev)
                mask = q_pos[:, None] >= kv_pos[None, :]
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            new_m = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - new_m[..., None])
            corr = torch.exp(m - new_m)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bqhgd", p, v_blk.float())
            o = o * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = new_m
        l = torch.clamp(l, min=1e-30)
        out = o / l.permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, Tq, Hq, hd).to(q.dtype))
    return outs


def _blocks(x, mesh: Mesh, axis_name: str) -> list:
    """Each ring device's block of ``x``: its piece of a leaf split over
    ``axis_name`` along dim 1, or a cut of a whole tensor moved there."""
    flat = mesh.flat()
    members = mesh.axis_members(axis_name)
    if isinstance(x, Sharded):
        return [x.shards[j] for j in members]
    n = len(members)
    T = x.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} does not split over the "
                         f"{axis_name} axis of {n}")
    b = T // n
    return [to_device(x[:, i * b:(i + 1) * b], flat[j])
            for i, j in enumerate(members)]


def ring_attention(
    q,  # [B, S, Hq, hd]: whole, or split over axis_name along dim 1
    k,  # [B, S, Hkv, hd]
    v,
    mesh: Mesh,
    *,
    axis_name: str = "seq",
    scale: float | None = None,
    causal: bool = True,
    quantized: bool = False,
):
    """Sequence-parallel attention over ``mesh[axis_name]``, equal to full
    (causal) attention on the whole arrays within float rounding
    (tests/test_torch_ring.py). ``q``/``k``/``v`` are whole tensors (cut
    into the axis's blocks here; the output comes back whole on ``q``'s
    device) or leaves placed by :func:`sequence_sharded` (the output is
    placed like ``q``). ``quantized`` (``ModelConfig.collective_quant``)
    rotates int8 K/V with per-row scales instead of the blocks
    themselves."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    outs = ring_blocks(_blocks(q, mesh, axis_name), _blocks(k, mesh,
                                                            axis_name),
                       _blocks(v, mesh, axis_name), scale=scale,
                       causal=causal, quantized=quantized)
    if isinstance(q, Sharded):
        members = mesh.axis_members(axis_name)
        spec = Split(1, axis_name)
        by_key = {q.keys()[j]: o for j, o in zip(members, outs)}
        shards = [to_device(by_key[key], dev)
                  for key, dev in zip(q.keys(), mesh.flat())]
        return Sharded(shards, spec, q.shape, mesh)
    return torch.cat([to_device(o, q.device) for o in outs], dim=1)


def sequence_sharded(mesh: Mesh, x: torch.Tensor, axis_name: str = "seq",
                     dim: int = 1) -> Sharded:
    """Split a tensor's sequence dimension over the ring axis."""
    return put(mesh, x, Split(dim, axis_name))
