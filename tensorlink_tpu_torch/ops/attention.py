"""Paged attention for the serving step (port of
``tensorlink_tpu/ops/attention.py``).

Two functions carry the continuous-batching main path:

- :func:`ragged_paged_attention` — the unified prefill+decode step's
  attention over a fixed ``[S, C]`` query block with per-slot ``(start,
  n_valid)`` as data, once per layer per chunk;
- :func:`paged_attention` — one query per slot at its length, once per
  layer per decode-continuation step.

Each has a plain PyTorch version (``*_ref``, ported from the JAX
references) and a wrapper that launches a CUDA kernel written for Hopper
(``ops/csrc/``, built by ``ops/_build.py``). A wrapper takes the plain
version only because the tensor it was given lies on the CPU; on a CUDA
tensor it launches the kernel or raises — nothing falls back. Every
wrapper counts its launches (``fn.launches``) and every plain version its
calls (``fn.calls``), so a run can show which path it went through.

Pages are ``[P, Hkv, page, hd]`` (kv-head-major, the JAX layout), block
tables int32 ``[S, n_pp]``. Not in this slice: the int8/int4 page
variants of the kernels (``k_scale``/``v_scale`` raise on CUDA),
``flash_attention`` and ``paged_prefill_attention``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use
_TILE_ROWS = 16  # query rows per tile: ops/csrc/paged_common.cuh
_SPLIT_PAGES = 16  # pages per attend block: ops/csrc/paged_common.cuh
_QUANT_LATER = (
    "int8/int4 KV pages (k_scale/v_scale) are not ported to CUDA yet — "
    "they arrive with the int8/int4 slice of the port"
)


def _gather_pages(pages, scales, block_tables, shape):
    """Contiguous f32 per-slot KV view over the page pool: gathers each
    block table's pages (dequantizing int8 pages by their per-(page,
    position, head) scales when given) and lays them out ``[.., K, Hkv,
    hd]``."""
    x = pages[block_tables.long()]
    if scales is not None and x.shape[-1] * 2 == shape[-1]:
        raise NotImplementedError(
            "packed int4 pages are not ported yet — they arrive with the "
            "int8/int4 slice of the port"
        )
    x = x.float()
    if scales is not None:
        x = x * scales[block_tables.long()].float()[..., None]
    # [.., n_pp, Hkv, page, hd] -> [.., n_pp, page, Hkv, hd] -> [.., K, ..]
    return x.transpose(-3, -2).reshape(shape)


def _ragged_ref(q, k_pages, v_pages, block_tables, starts, n_valid, scale,
                k_scale, v_scale):
    S, C, Hq, hd = q.shape
    _, Hkv, page, _ = k_pages.shape
    K = block_tables.shape[1] * page
    k = _gather_pages(k_pages, k_scale, block_tables, (S, K, Hkv, hd))
    v = _gather_pages(v_pages, v_scale, block_tables, (S, K, Hkv, hd))
    G = Hq // Hkv
    qg = q.reshape(S, C, Hkv, G, hd).float()
    scores = torch.einsum("sckgd,sxkd->sckgx", qg, k) * scale
    dev = q.device
    q_pos = starts.long()[:, None] + torch.arange(C, device=dev)[None, :]
    k_pos = torch.arange(K, device=dev)[None, None, :]
    causal = k_pos <= q_pos[:, :, None]  # [S, C, K]
    scores = torch.where(causal[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    # rows at or past n_valid (whole idle slots too) are all-masked; their
    # softmax is uniform garbage, so the zero guard rides the weights
    row_ok = torch.arange(C, device=dev)[None, :] < n_valid.long()[:, None]
    w = torch.where(row_ok[:, :, None, None, None], w, torch.zeros_like(w))
    out = torch.einsum("sckgx,sxkd->sckgd", w, v)
    return out.reshape(S, C, Hq, hd).to(q.dtype)


def ragged_paged_attention_ref(
    q: torch.Tensor,  # [S, C, Hq, hd] — per-slot query block
    k_pages: torch.Tensor,  # [P, Hkv, page, hd]
    v_pages: torch.Tensor,  # [P, Hkv, page, hd]
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    starts: torch.Tensor,  # int32 [S] — absolute position of q[s, 0]
    n_valid: torch.Tensor,  # int32 [S] — valid queries per slot
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,  # f32 [P, Hkv, page] — int8 pages
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain ragged paged attention — the CPU serving path and what the
    CUDA kernel is held against. Query ``j`` of slot ``s`` sits at
    ``starts[s] + j`` and attends every key position ``<= starts[s] + j``
    through the slot's pages (the caller scatters the block's KV first);
    rows at or past ``n_valid[s]`` give exact zeros. The same masked
    softmax GQA math as the JAX reference, in float32."""
    ragged_paged_attention_ref.calls += 1
    return _ragged_ref(q, k_pages, v_pages, block_tables, starts, n_valid,
                       scale, k_scale, v_scale)


def paged_attention_ref(
    q: torch.Tensor,  # [S, Hq, hd] — one query token per slot
    k_pages: torch.Tensor,  # [P, Hkv, page, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    lengths: torch.Tensor,  # int32 [S] — valid positions per slot
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain paged decode attention: slot ``s`` attends positions
    ``< lengths[s]``; a length-0 slot gives zeros. Computed as the
    one-row case of the ragged reference (start ``length - 1``, one valid
    row when the length is positive), so a decode slot and a 1-valid-row
    ragged slot run one code path."""
    paged_attention_ref.calls += 1
    lengths = lengths.long()
    out = _ragged_ref(
        q[:, None], k_pages, v_pages, block_tables,
        torch.clamp(lengths - 1, min=0), (lengths > 0).long(),
        scale, k_scale, v_scale,
    )
    return out[:, 0]


def _check_launch(name, q, k_pages, v_pages, ints, k_scale):
    """The wrapper's contract for a CUDA launch: raise on anything the
    kernel does not take."""
    if k_scale is not None:
        raise NotImplementedError(_QUANT_LATER)
    if q.device.type != "cuda":
        raise TypeError(f"{name}: tensors must be on a CUDA device or the CPU")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    for t in (k_pages, v_pages):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: pages must be {q.dtype}, got {t.dtype}")
    for t in (k_pages, v_pages, *ints):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32")
    for t in (q, k_pages, v_pages, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte aligned")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pages must be [P, Hkv, page, hd]")
    _, Hkv, page, hd = k_pages.shape
    if q.shape[-1] != hd or q.shape[-2] % Hkv:
        raise ValueError(f"{name}: q heads/head_dim do not match the pages")
    if hd % 32 or hd > 256:
        raise ValueError(f"{name}: head_dim must be a multiple of 32, <= 256")
    smem = 4 * (_TILE_ROWS * (hd + 1) + page * (hd + 1) + page * hd
                + _TILE_ROWS * page + _TILE_ROWS * hd + 3 * _TILE_ROWS)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{name}: page {page} x head_dim {hd} needs {smem} bytes of "
            f"shared memory, more than a block's {_MAX_SMEM}"
        )
    return Hkv, page, hd


def _workspace(q, S, Hkv, n_rows, hd, n_pp):
    """The two-pass kernels' f32 partials: per (slot, kv head, row tile,
    split) a tile of accumulators and its (max, denominator) pairs."""
    n = S * Hkv * -(-n_rows // _TILE_ROWS) * -(-n_pp // _SPLIT_PAGES)
    acc = torch.empty(n * _TILE_ROWS * hd, dtype=torch.float32,
                      device=q.device)
    ml = torch.empty(n * _TILE_ROWS * 2, dtype=torch.float32, device=q.device)
    return acc, ml


def _launch(name, fn_name, q, args):
    from . import _build  # nvcc/ctypes only on the launch path

    lib = _build.load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.tl_error_string(err).decode()} (shapes q={tuple(q.shape)})"
        )


def ragged_paged_attention(
    q: torch.Tensor,  # [S, C, Hq, hd]
    k_pages: torch.Tensor,  # [P, Hkv, page, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    starts: torch.Tensor,  # int32 [S]
    n_valid: torch.Tensor,  # int32 [S]
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ragged paged attention; returns ``[S, C, Hq, hd]`` in q's dtype.
    CPU tensors take :func:`ragged_paged_attention_ref`; CUDA tensors
    launch ``ops/csrc/ragged_paged_attention.cu`` (its attend and combine
    passes, counted as one launch) on the current stream, with no
    synchronisation, or raise."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_pages, v_pages, block_tables, starts, n_valid, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    name = "ragged_paged_attention"
    ints = (block_tables, starts, n_valid)
    Hkv, page, hd = _check_launch(name, q, k_pages, v_pages, ints, k_scale)
    if q.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{name}: q must be [S, C, Hq, hd], tables [S, n_pp]")
    S, C, Hq, _ = q.shape
    if block_tables.shape[0] != S or starts.shape != (S,) \
            or n_valid.shape != (S,):
        raise ValueError(f"{name}: per-slot tensors must have {S} rows")
    n_pp = block_tables.shape[1]
    out = torch.empty_like(q)
    ws_acc, ws_ml = _workspace(q, S, Hkv, C * (Hq // Hkv), hd, n_pp)
    _launch(
        name, "tl_ragged_paged_attention", q,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         block_tables.data_ptr(), starts.data_ptr(), n_valid.data_ptr(),
         out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(),
         int(q.dtype == torch.bfloat16), S, C, Hq, Hkv, hd, page, n_pp,
         float(scale)),
    )
    ragged_paged_attention.launches += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [S, Hq, hd]
    k_pages: torch.Tensor,  # [P, Hkv, page, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    lengths: torch.Tensor,  # int32 [S]
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paged decode attention; returns ``[S, Hq, hd]`` in q's dtype. CPU
    tensors take :func:`paged_attention_ref`; CUDA tensors launch
    ``ops/csrc/paged_attention.cu`` (its attend and combine passes,
    counted as one launch) on the current stream, with no
    synchronisation, or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    name = "paged_attention"
    ints = (block_tables, lengths)
    Hkv, page, hd = _check_launch(name, q, k_pages, v_pages, ints, k_scale)
    if q.dim() != 3 or block_tables.dim() != 2:
        raise ValueError(f"{name}: q must be [S, Hq, hd], tables [S, n_pp]")
    S, Hq, _ = q.shape
    if block_tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(f"{name}: per-slot tensors must have {S} rows")
    n_pp = block_tables.shape[1]
    out = torch.empty_like(q)
    ws_acc, ws_ml = _workspace(q, S, Hkv, Hq // Hkv, hd, n_pp)
    _launch(
        name, "tl_paged_attention", q,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
         ws_acc.data_ptr(), ws_ml.data_ptr(), int(q.dtype == torch.bfloat16),
         S, Hq, Hkv, hd, page, n_pp, float(scale)),
    )
    paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
paged_attention.launches = 0
ragged_paged_attention_ref.calls = 0
paged_attention_ref.calls = 0


def reset_counts() -> None:
    """Zero every launch and plain-call counter (before a measured run)."""
    ragged_paged_attention.launches = 0
    paged_attention.launches = 0
    ragged_paged_attention_ref.calls = 0
    paged_attention_ref.calls = 0


__all__ = [
    "paged_attention",
    "paged_attention_ref",
    "ragged_paged_attention",
    "ragged_paged_attention_ref",
    "reset_counts",
]
