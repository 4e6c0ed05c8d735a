"""Attention kernels (port of ``tensorlink_tpu/ops/attention.py``).

:func:`flash_attention` — causal offset-0 attention over dense ``[B, T,
H, hd]`` tensors with an online softmax and an optional sliding window:
the dense engine's fresh-cache prefill (``models/transformer.py::
forward`` with ``flash_prefill``).

Three paged functions, each over full-precision, int8 or packed-int4
pages:

- :func:`ragged_paged_attention` — the unified prefill+decode step's
  attention over a fixed ``[S, C]`` query block with per-slot ``(start,
  n_valid)`` as data, once per layer per chunk;
- :func:`paged_attention` — one query per slot at its length, once per
  layer per decode-continuation step;
- :func:`paged_prefill_attention` — one slot's chunk at an offset over
  one block-table row (no engine caller; the ``S = 1``, ``n_valid = C``
  case of the ragged kernel, launched as such).

Each has a plain PyTorch version (``*_ref``, ported from the JAX
references) and a wrapper that launches a CUDA kernel written for Hopper
(``ops/csrc/``, built by ``ops/_build.py``). A wrapper takes the plain
version only because the tensor it was given lies on the CPU; on a CUDA
tensor it launches the kernel or raises — nothing falls back. Every
wrapper counts its launches (``fn.launches``, and per page format in
``fn.launches_by_format``) and every plain version its calls
(``fn.calls``), so a run can show which path and which variant it took.

Pages are ``[P, Hkv, page, hd]`` (kv-head-major, the JAX layout), block
tables int32 ``[S, n_pp]``. Quantized pages are int8 with f32 scales
``[P, Hkv, page]`` (``k_scale``/``v_scale``, one per position and head);
packed int4 pages have a trailing dim of ``hd / 2``, two values per byte
in the split-half layout of ``models/quant.py``.
"""

from __future__ import annotations

import torch

from ..models.quant import unpack_int4

NEG_INF = -1e30
_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use
_TILE_ROWS = 16  # query rows per tile: ops/csrc/paged_common.cuh
_SPLIT_PAGES = 16  # pages per attend block: ops/csrc/paged_common.cuh
# the ragged kernel's bf16 body (ops/csrc/ragged_paged_attention.cu):
_TC_TILE_ROWS = 64  # query rows per tile
_SPLIT_KEYS = 512  # key positions per attend block
FORMATS = ("fp", "int8", "int4")  # page format codes 0, 1, 2 of the kernels


def flash_attention_ref(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    *,
    scale: float,
    window: int | None = None,
) -> torch.Tensor:
    """Plain causal offset-0 attention — the CPU path and what the CUDA
    kernel is held against. What the Pallas ``_flash_kernel`` computes:
    float32 scores, query ``i`` sees keys ``j <= i`` (and ``j > i -
    window`` with a window), softmax and PV in float32 with the kernel's
    guards (a row with no visible key gives zeros, the denominator is
    floored at 1e-30), one cast to q's dtype at the end. Unlike the einsum
    ``attention``, the weights are not cast to v's dtype before PV."""
    flash_attention_ref.calls += 1
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    ok = j <= i
    if window is not None:
        ok &= j > i - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    w = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return out.reshape(B, T, Hq, hd).to(q.dtype)


def _check_head_dim(name, hd, tensor_cores) -> None:
    """The bf16 tensor-core bodies take a product depth of 16; the scalar
    bodies (every f32 launch) load 16-byte vectors of f32 and need a
    multiple of 32."""
    mult, body = (16, "bf16 tensor-core") if tensor_cores else (32, "scalar")
    if hd % mult or hd > 256:
        raise ValueError(f"{name}: head_dim must be a multiple of {mult}, "
                         f"<= 256 (the {body} kernel)")


def _check_flash(q, k, v, window) -> None:
    """The flash wrapper's contract for a CUDA launch: raise on anything
    the kernel does not take."""
    name = "flash_attention"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k and v must be {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be [B, T, Hq, hd], k/v [B, T, Hkv, "
                         "hd]")
    B, T, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != hd:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{name}: q heads do not divide over the kv heads")
    _check_head_dim(name, hd, q.dtype == torch.bfloat16)
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be positive, got {window}")
    elt = q.element_size()
    for t in (q, k, v):
        # rows are read in place: heads packed, 16-byte aligned rows
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError(f"{name}: each token's heads must be packed "
                             "[H, hd] rows")
        if t.data_ptr() % 16 or (t.stride(0) * elt) % 16 \
                or (t.stride(1) * elt) % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    if q.device.type != "cuda":
        raise TypeError(f"{name}: tensors must be on a CUDA device or the CPU")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: all tensors must be on {q.device}")


def flash_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    *,
    scale: float,
    block_q: int = 128,
    block_k: int = 128,
    window: int | None = None,
) -> torch.Tensor:
    """Causal offset-0 attention; returns ``[B, T, Hq, hd]`` in q's dtype.
    ``window`` applies Mistral-style sliding-window masking (key ``j``
    visible from ``i`` iff ``i - window < j <= i``). Keeps the JAX
    contract that ``T`` is a multiple of ``min(block_q, T)`` and
    ``min(block_k, T)`` (``ValueError`` otherwise); the CUDA kernel tiles
    on its own. CPU tensors take :func:`flash_attention_ref`; CUDA
    tensors launch ``ops/csrc/flash_attention.cu`` on the current stream,
    with no synchronisation, reading q/k/v in place through their batch
    and token strides, or raise."""
    B, T, Hq, hd = q.shape
    bq, bk = min(block_q, T), min(block_k, T)
    if T % bq or T % bk:
        raise ValueError(
            f"seq len {T} must divide block sizes ({bq}, {bk}) — the "
            "engine's bucketed prefill shapes guarantee this"
        )
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, window=window)
    _check_flash(q, k, v, window)
    out = torch.empty((B, T, Hq, hd), dtype=q.dtype, device=q.device)
    _launch(
        "flash_attention", "tl_flash_attention", q,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         int(q.dtype == torch.bfloat16), B, T, Hq, k.shape[2], hd,
         q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
         v.stride(1), 0 if window is None else int(window), float(scale)),
    )
    flash_attention.launches += 1
    return out


def _gather_pages(pages, scales, block_tables, shape):
    """Contiguous f32 per-slot KV view over the page pool: gathers each
    block table's pages, dequantizing with the per-(page, position, head)
    scales when given — packed int4 pages (trailing dim half the target
    head_dim) unpack before the scale multiply — and lays them out
    ``[.., K, Hkv, hd]``."""
    x = pages[block_tables.long()]
    if scales is not None and x.shape[-1] * 2 == shape[-1]:
        x = unpack_int4(x).float()  # split-half nibbles → [.., hd]
    else:
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
    k_pages: torch.Tensor,  # [P, Hkv, page, hd] (int8 [.., hd/2]: int4)
    v_pages: torch.Tensor,  # [P, Hkv, page, hd]
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    starts: torch.Tensor,  # int32 [S] — absolute position of q[s, 0]
    n_valid: torch.Tensor,  # int32 [S] — valid queries per slot
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,  # f32 [P, Hkv, page] — int8/int4
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


def _prefill_rows(q, bt_row, start):
    """The one-slot ragged arguments of a prefill chunk: ``[1, C, Hq,
    hd]`` queries, a ``[1, n_pp]`` table, ``starts = [start]`` and
    ``n_valid = [C]`` (int32, on q's device)."""
    dev = q.device
    starts = torch.as_tensor(start, dtype=torch.int32).reshape(1).to(dev)
    n_valid = torch.full((1,), q.shape[0], dtype=torch.int32, device=dev)
    return q[None], bt_row[None], starts, n_valid


def paged_prefill_attention_ref(
    q: torch.Tensor,  # [C, Hq, hd] — one slot's prefill-chunk queries
    k_pages: torch.Tensor,  # [P, Hkv, page, hd]
    v_pages: torch.Tensor,
    bt_row: torch.Tensor,  # int32 [n_pp] — the slot's block-table row
    start,  # int32 scalar (tensor or int) — absolute position of q[0]
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain offset-carrying paged prefill attention: query ``j`` sits at
    ``start + j`` and attends every key position ``<= start + j`` through
    the slot's pages. Computed as the one-slot case of the ragged
    reference (``starts = [start]``, ``n_valid = [C]``)."""
    paged_prefill_attention_ref.calls += 1
    qs, bt, starts, n_valid = _prefill_rows(q, bt_row, start)
    return _ragged_ref(qs, k_pages, v_pages, bt, starts, n_valid, scale,
                       k_scale, v_scale)[0]


def _page_format(name, q, k_pages, v_pages, k_scale, v_scale) -> int:
    """The page format code (0 fp, 1 int8, 2 packed int4) of a launch's
    pages and scales, raising on any combination the kernels do not take:
    fp pages in q's dtype without scales; int8 pages of trailing dim
    ``hd`` (int8) or ``hd / 2`` (int4) with both scales f32 ``[P, Hkv,
    page]``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: give both k_scale and v_scale, or neither")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pages must be [P, Hkv, page, hd]")
    P, Hkv, page, row = k_pages.shape
    hd = q.shape[-1]
    if k_scale is None:
        for t in (k_pages, v_pages):
            if t.dtype != q.dtype:
                raise TypeError(f"{name}: pages must be {q.dtype}, got "
                                f"{t.dtype} (quantized pages need scales)")
        if row != hd:
            raise ValueError(f"{name}: q head_dim {hd} != page dim {row}")
        return 0
    for t in (k_pages, v_pages):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: scaled pages must be int8, got "
                            f"{t.dtype}")
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32, got {t.dtype}")
        if tuple(t.shape) != (P, Hkv, page):
            raise ValueError(f"{name}: scales must be [P, Hkv, page] = "
                             f"{[P, Hkv, page]}, got {list(t.shape)}")
    if row == hd:
        return 1
    if 2 * row == hd:
        return 2
    raise ValueError(f"{name}: int8 page dim {row} must be head_dim {hd} "
                     f"(int8) or {hd // 2} (packed int4)")


def _check_launch(name, q, k_pages, v_pages, ints, k_scale, v_scale,
                  tensor_cores=False):
    """The wrapper's contract for a CUDA launch: raise on anything the
    kernel does not take. ``tensor_cores``: the launch goes to the ragged
    kernel's bf16 body (bf16 q), which takes head_dim a multiple of 16
    and any page size; otherwise to its scalar f32 body (head_dim a
    multiple of 32, the page's f32 tiles within a block's shared
    memory). Returns
    ``(Hkv, page, hd, fmt)`` with
    ``fmt`` the page format code of :func:`_page_format`."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    fmt = _page_format(name, q, k_pages, v_pages, k_scale, v_scale)
    _, Hkv, page, _ = k_pages.shape
    hd = q.shape[-1]
    if q.shape[-2] % Hkv:
        raise ValueError(f"{name}: q heads do not divide over the kv heads")
    _check_head_dim(name, hd, tensor_cores)
    if not tensor_cores:
        smem = 4 * (_TILE_ROWS * (hd + 1) + page * (hd + 1) + page * hd
                    + _TILE_ROWS * page + _TILE_ROWS * hd + 3 * _TILE_ROWS)
        if smem > _MAX_SMEM:
            raise ValueError(
                f"{name}: page {page} x head_dim {hd} needs {smem} bytes "
                f"of shared memory, more than a block's {_MAX_SMEM}"
            )
    dev = q.device
    if dev.type != "cuda":
        raise TypeError(f"{name}: tensors must be on a CUDA device or the CPU")
    scales = () if k_scale is None else (k_scale, v_scale)
    for t in (k_pages, v_pages, *scales, *ints):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32")
    for t in (q, k_pages, v_pages, *scales, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte aligned")
    return Hkv, page, hd, fmt


def _workspace(q, S, Hkv, n_rows, hd, n_pp, page, tensor_cores=False):
    """The two-pass kernels' f32 partials: per (slot, kv head, row tile,
    split) a tile of accumulators and its (max, denominator) pairs. The
    scalar bodies split 16 pages at a time over 16-row tiles; the bf16
    body 512 key positions at a time over 64-row tiles. One allocation,
    the accumulators first: returns ``(workspace, acc pointer, (m, l)
    pointer)``."""
    if tensor_cores:
        rows, n_splits = _TC_TILE_ROWS, -(-(n_pp * page) // _SPLIT_KEYS)
    else:
        rows, n_splits = _TILE_ROWS, -(-n_pp // _SPLIT_PAGES)
    n = S * Hkv * -(-n_rows // rows) * n_splits
    ws = torch.empty(n * rows * (hd + 2), dtype=torch.float32,
                     device=q.device)
    acc = ws.data_ptr()
    return ws, acc, acc + n * rows * hd * 4


# A device's current stream as a raw handle: torch's own binding, which
# its compiled kernels launch on; building the public Stream object on
# every call was a large share of a launch's host work.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(name, fn_name, q, args):
    """Call the C entry point ``fn_name`` on q's device's current stream
    (switching the current device only when q lies on another)."""
    from . import _build  # nvcc/ctypes only on the launch path

    lib = _build.load(_build.ENTRY_POINTS[fn_name][0])
    fn = getattr(lib, fn_name)
    index = q.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _stream(index))
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.tl_error_string(err).decode()} (shapes q={tuple(q.shape)})"
        )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(fn, fmt):
    fn.launches += 1
    fn.launches_by_format[FORMATS[fmt]] += 1


def _ragged_launch(name, q, k_pages, v_pages, block_tables, starts,
                   n_valid, scale, k_scale, v_scale) -> tuple:
    """Check and launch ``ops/csrc/ragged_paged_attention.cu`` (its
    attend and combine passes; bf16 q takes its tensor-core body, f32 q
    its scalar one) on the current stream; returns ``(out, fmt)``."""
    ints = (block_tables, starts, n_valid)
    tc = q.dtype == torch.bfloat16
    Hkv, page, hd, fmt = _check_launch(name, q, k_pages, v_pages, ints,
                                       k_scale, v_scale, tensor_cores=tc)
    if q.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{name}: q must be [S, C, Hq, hd], tables [S, n_pp]")
    S, C, Hq, _ = q.shape
    if block_tables.shape[0] != S or starts.shape != (S,) \
            or n_valid.shape != (S,):
        raise ValueError(f"{name}: per-slot tensors must have {S} rows")
    n_pp = block_tables.shape[1]
    out = torch.empty_like(q)
    _ws, ws_acc, ws_ml = _workspace(q, S, Hkv, C * (Hq // Hkv), hd, n_pp,
                                    page, tensor_cores=tc)
    _launch(
        "ragged_paged_attention", "tl_ragged_paged_attention", q,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
         starts.data_ptr(), n_valid.data_ptr(), out.data_ptr(), ws_acc,
         ws_ml, int(tc), fmt, S, C, Hq, Hkv, hd, page, n_pp, float(scale)),
    )
    return out, fmt


def ragged_paged_attention(
    q: torch.Tensor,  # [S, C, Hq, hd]
    k_pages: torch.Tensor,  # [P, Hkv, page, hd] (int8 [.., hd/2]: int4)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    starts: torch.Tensor,  # int32 [S]
    n_valid: torch.Tensor,  # int32 [S]
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,  # f32 [P, Hkv, page]
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ragged paged attention; returns ``[S, C, Hq, hd]`` in q's dtype.
    CPU tensors take :func:`ragged_paged_attention_ref`; CUDA tensors
    launch ``ops/csrc/ragged_paged_attention.cu`` (its attend and combine
    passes, counted as one launch) in the pages' format on the current
    stream, with no synchronisation, or raise."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_pages, v_pages, block_tables, starts, n_valid, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    out, fmt = _ragged_launch(
        "ragged_paged_attention", q, k_pages, v_pages, block_tables, starts,
        n_valid, scale, k_scale, v_scale,
    )
    _count(ragged_paged_attention, fmt)
    return out


def paged_prefill_attention(
    q: torch.Tensor,  # [C, Hq, hd]
    k_pages: torch.Tensor,  # [P, Hkv, page, hd]
    v_pages: torch.Tensor,
    bt_row: torch.Tensor,  # int32 [n_pp]
    start,  # int32 scalar (tensor or int)
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Offset-carrying paged prefill attention; returns ``[C, Hq, hd]`` in
    q's dtype. CPU tensors take :func:`paged_prefill_attention_ref`; CUDA
    tensors launch the ragged kernel with ``S = 1``, ``starts = [start]``
    and ``n_valid = [C]`` (counted here, not as a ragged launch), or
    raise."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(
            q, k_pages, v_pages, bt_row, start, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    name = "paged_prefill_attention"
    if q.dim() != 3 or bt_row.dim() != 1:
        raise ValueError(f"{name}: q must be [C, Hq, hd], bt_row [n_pp]")
    qs, bt, starts, n_valid = _prefill_rows(q, bt_row, start)
    out, fmt = _ragged_launch(name, qs, k_pages, v_pages, bt, starts,
                              n_valid, scale, k_scale, v_scale)
    _count(paged_prefill_attention, fmt)
    return out[0]


def paged_attention(
    q: torch.Tensor,  # [S, Hq, hd]
    k_pages: torch.Tensor,  # [P, Hkv, page, hd] (int8 [.., hd/2]: int4)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # int32 [S, n_pp]
    lengths: torch.Tensor,  # int32 [S]
    *,
    scale: float,
    k_scale: torch.Tensor | None = None,  # f32 [P, Hkv, page]
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paged decode attention; returns ``[S, Hq, hd]`` in q's dtype. CPU
    tensors take :func:`paged_attention_ref`; CUDA tensors launch the
    ragged kernel's one-row entry point (``tl_paged_attention`` in
    ``ops/csrc/ragged_paged_attention.cu``: each slot's row at its length
    - 1, read from ``lengths`` in the kernel; its attend and combine
    passes counted as one launch) in the pages' format on the current
    stream, with no synchronisation, or raise. bf16 q takes the
    tensor-core body, so a decode row equals bitwise the ragged kernel's
    row at the same position; f32 q the scalar body."""
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    name = "paged_attention"
    ints = (block_tables, lengths)
    tc = q.dtype == torch.bfloat16
    Hkv, page, hd, fmt = _check_launch(name, q, k_pages, v_pages, ints,
                                       k_scale, v_scale, tensor_cores=tc)
    if q.dim() != 3 or block_tables.dim() != 2:
        raise ValueError(f"{name}: q must be [S, Hq, hd], tables [S, n_pp]")
    S, Hq, _ = q.shape
    if block_tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(f"{name}: per-slot tensors must have {S} rows")
    n_pp = block_tables.shape[1]
    out = torch.empty_like(q)
    _ws, ws_acc, ws_ml = _workspace(q, S, Hkv, Hq // Hkv, hd, n_pp, page,
                                    tensor_cores=tc)
    _launch(
        name, "tl_paged_attention", q,
        (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
         lengths.data_ptr(), out.data_ptr(), ws_acc, ws_ml, int(tc), fmt, S,
         Hq, Hkv, hd, page, n_pp, float(scale)),
    )
    _count(paged_attention, fmt)
    return out


_WRAPPERS = (ragged_paged_attention, paged_attention, paged_prefill_attention)
_REFS = (ragged_paged_attention_ref, paged_attention_ref,
         paged_prefill_attention_ref, flash_attention_ref)


def reset_counts() -> None:
    """Zero every launch and plain-call counter (before a measured run)."""
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.launches_by_format = dict.fromkeys(FORMATS, 0)
    flash_attention.launches = 0
    for fn in _REFS:
        fn.calls = 0


reset_counts()

__all__ = [
    "FORMATS",
    "flash_attention",
    "flash_attention_ref",
    "paged_attention",
    "paged_attention_ref",
    "paged_prefill_attention",
    "paged_prefill_attention_ref",
    "ragged_paged_attention",
    "ragged_paged_attention_ref",
    "reset_counts",
]
