"""Operation and byte counts the benchmark's ratios are taken against.

The yardstick of ``mfu`` and of the attention kernels' roofline shares,
frozen here so that the program under test cannot move it. Every count is
worked out from host-side state: the model's widths and, per chunk, the
slot table the engine packed (each slot's start, valid rows, whether it
samples and how many tokens it still wants). Nothing is read from device
tensors.

Peaks are one NVIDIA H100 SXM's published dense rates (NVIDIA's data
sheet, 700 W): 989 TFLOP/s in bf16 and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
PAGE_ENTRY_BYTES = 4  # one int32 block-table entry or per-slot scalar


@dataclass(frozen=True)
class Widths:
    """The widths a count needs, from a configuration's published keys."""

    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    n_experts: int = 0
    experts_per_token: int = 0

    @classmethod
    def from_hf(cls, hf: dict) -> "Widths":
        heads = int(hf["num_attention_heads"])
        return cls(
            d_model=int(hf["hidden_size"]),
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=heads,
            n_kv_heads=int(hf.get("num_key_value_heads") or heads),
            head_dim=int(hf.get("head_dim") or hf["hidden_size"] // heads),
            d_ff=int(hf["intermediate_size"]),
            vocab=int(hf["vocab_size"]),
            n_experts=int(hf.get("num_local_experts") or 0),
            experts_per_token=int(hf.get("num_experts_per_tok") or 0),
        )


def layer_params_active(w: Widths) -> int:
    """Weights one token multiplies through in one layer: the q, k, v and
    output projections, and the MLP (a MoE layer: its router and the
    experts the token is routed to, not the others)."""
    q_dim, kv_dim = w.n_heads * w.head_dim, w.n_kv_heads * w.head_dim
    attn = w.d_model * (2 * q_dim + 2 * kv_dim)
    mlp = 3 * w.d_model * w.d_ff
    if w.n_experts:
        mlp = w.experts_per_token * mlp + w.d_model * w.n_experts
    return attn + mlp


def row_flops(w: Widths, ctx: int, *, head: bool) -> int:
    """Model FLOPs of one token's forward pass at ``ctx`` attended keys:
    2 per weight of every layer, causal attention's QK and PV products (4
    per query head, head dim and key), and the LM head where the row
    produces a token."""
    body = 2 * w.n_layers * layer_params_active(w)
    attn = 4 * w.n_layers * w.n_heads * w.head_dim * ctx
    return body + attn + (2 * w.d_model * w.vocab if head else 0)


def decode_active(emit, remaining, j: int) -> list[bool]:
    """Which slots run decode-continuation step ``j`` (1-based): a slot
    that sampled in the ragged pass and still wanted more than ``j``
    tokens then (no stop ids: the traffic sets none)."""
    return [bool(e) and int(r) > j for e, r in zip(emit, remaining)]


def chunk_flops(w: Widths, pack: dict) -> int:
    """Model FLOPs of the useful rows of one chunk: every valid row of the
    ragged pass (prompt pieces and decoding slots' current tokens), the
    head on the rows that sample, and each continuation step's live
    slots. Padded rows and idle slots count nothing."""
    starts, n_valid = pack["starts"], pack["n_valid"]
    emit, remaining = pack["emit"], pack["remaining"]
    total = 0
    for s, (st, nv) in enumerate(zip(starts, n_valid)):
        st, nv = int(st), int(nv)
        for j in range(nv):
            total += row_flops(w, st + j + 1,
                               head=bool(emit[s]) and j == nv - 1)
    for j in range(1, int(pack["n_steps"])):
        for s, live in enumerate(decode_active(emit, remaining, j)):
            if live:
                ctx = int(starts[s]) + int(n_valid[s]) + j
                total += row_flops(w, ctx, head=True)
    return total


def _kv_row_bytes(w: Widths, elt: int) -> int:
    """Bytes of one position's K (or V) row of one kv head, fp pages."""
    return w.head_dim * elt


def ragged_launch(w: Widths, pack: dict, elt: int = 2) -> tuple[int, int]:
    """``(bytes, flops)`` one layer's ragged attention launch needs: each
    valid query row read once and its output row written once, each
    valid K and V byte read once, the block-table entries in use and two
    scalars of each slot with valid rows; QK and PV products over each
    valid row's causal keys. Padded rows and idle slots need nothing."""
    hq, hkv, hd = w.n_heads, w.n_kv_heads, w.head_dim
    page = int(pack["page"])
    live = pairs = pages = rows = slots = 0
    for st, nv in zip(pack["starts"], pack["n_valid"]):
        st, nv = int(st), int(nv)
        if nv <= 0:
            continue
        slots += 1
        rows += nv
        live += st + nv
        pages += -(-(st + nv) // page)
        pairs += nv * st + nv * (nv + 1) // 2
    n_bytes = (2 * rows * hq * hd * elt
               + 2 * live * hkv * _kv_row_bytes(w, elt)
               + pages * PAGE_ENTRY_BYTES + 2 * slots * PAGE_ENTRY_BYTES)
    return n_bytes, 4 * hd * hq * pairs


def paged_launch(w: Widths, lengths, page: int,
                 elt: int = 2) -> tuple[int, int]:
    """``(bytes, flops)`` one layer's decode attention launch needs at
    attended ``lengths`` (0 for a slot that does not run): each live
    slot's query read and its output row written, each attended K and V
    byte read once, the block-table entries in use and the live slots'
    lengths; QK and PV products over the attended keys."""
    hq, hkv, hd = w.n_heads, w.n_kv_heads, w.head_dim
    n_live = sum(1 for n in lengths if n > 0)
    keys = sum(int(n) for n in lengths)
    pages = sum(-(-int(n) // page) for n in lengths)
    n_bytes = (2 * n_live * hq * hd * elt
               + 2 * keys * hkv * _kv_row_bytes(w, elt)
               + pages * PAGE_ENTRY_BYTES + n_live * PAGE_ENTRY_BYTES)
    return n_bytes, 4 * hd * hq * keys


def bound_s(n_bytes: int, flops: int) -> float:
    """The least time the chip could take: the larger of the bytes over
    HBM bandwidth and the operations over the bf16 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def chunk_ragged_bound_s(w: Widths, pack: dict) -> float:
    """The bound of a chunk's ragged launches, one per layer."""
    return w.n_layers * bound_s(*ragged_launch(w, pack))


def chunk_paged_bound_s(w: Widths, pack: dict) -> float:
    """The bound of a chunk's decode launches: one per layer in each of the
    ``n_steps - 1`` continuation steps, every slot's attended length that
    step (its length after the ragged pass plus the step's token)."""
    page = int(pack["page"])
    total = 0.0
    for j in range(1, int(pack["n_steps"])):
        act = decode_active(pack["emit"], pack["remaining"], j)
        lengths = [int(st) + int(nv) + j if a else 0
                   for st, nv, a in zip(pack["starts"], pack["n_valid"],
                                        act)]
        total += w.n_layers * bound_s(*paged_launch(w, lengths, page))
    return total
