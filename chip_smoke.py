"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device: a CUDA card is required; prints its name and power limit and
   turns TF32 off for float32 products and convolutions.
2. Build: compiles the CUDA kernels from tensorlink_tpu_torch/ops/csrc/
   (one nvcc per source, started together) into build/tensorlink_tpu_torch/.
3. Kernels: each kernel over full-precision, int8 and packed-int4 pages,
   and paged_prefill_attention, against its plain PyTorch version at the
   main path's shapes and at small edge cases (float32 rtol = atol =
   2e-5; bfloat16 q compared in float32 at 1.6e-2); a known-answer check
   of the int4 split-half nibble order inside the kernels; the ragged
   kernel's bf16 rows bitwise equal however a chunk is framed (chunks of
   1 to 88 positions: narrow and wide tiles); paged_attention's rows
   bitwise equal to the ragged kernel's rows at the same positions, in a
   decode slot, verify slots of 4 and 9 positions (3 and 8 drafts) and a
   128-row prefill chunk, bf16 and
   f32, every page format (decode_rows_check); then each
   variant timed at the main path's shape in bfloat16 (kernel_ms and
   library_ms eager: median of 30 calls between CUDA events, the host
   work of each call included; device_ms and library_device_ms: 10 calls
   captured in a CUDA graph, median of 30 replays) beside its plain
   version, torch's
   scaled_dot_product_attention over pre-gathered KV where one call
   computes the same function, and its bound on the card. The flash
   kernel likewise: against its plain version on the main shape (B 4, T
   2048, Hq 16, Hkv 8, hd 128), tests/test_ops.py's shapes, three sliding
   windows, T 100 and 37 and head_dim 64 and 256; timed at the main shape
   beside one causal GQA scaled_dot_product_attention call. bfloat16 runs
   the tensor-core bodies of flash and of the ragged kernel, whose one-row
   launch paged_attention is (also at head_dim 16, test_ops.py's MQA and
   prefill shapes), float32 the scalar bodies.
4. Step parity: qwen3-0p6b at full width in float32, three
   paged_ragged_step chunks on a mixed block with the kernels and with
   their plain versions, over fp, int8 and int4 pages — counts and
   lengths equal; the logits of every draw made from equal tokens on
   both paths within a limit per page format, and tokens equal (int4: a
   slot's tokens may part only where the plain logits' top two lie
   within that limit); every layer, fed the same input on both paths,
   within rtol = atol = 2e-5 on its output and with byte-equal quantized
   pages and scales (fp pages within 2e-5); free running, fp pages within
   4 times that bound and quantized codes within 1 of each other.
5. Serving: qwen3-0p6b at full width in bfloat16 behind a
   ContinuousBatcher, three runs — fp pages (16 requests from 4
   threads), int8 pages (the same 16), and int8 weights over int4 pages
   (8 of them) — each with the kernels' launch counts checked against
   the chunks run and all in the run's page format, the plain versions
   never called, the prefix cache hit, pages conserved, and a greedy
   request re-run alone equal to its co-batched stream.
6. Dense parity: qwen3-0p6b at full width in float32 with
   flash_attention on, GenerationEngine's prefill of two prompts through
   the flash kernel and through its plain version — every layer from the
   same input within rtol = atol = 2e-5, last-token logits within a limit
   set from readings — and greedy generate_compiled, beam and lookahead
   token-equal on both paths. Then bf16 parity: qwen3-0p6b in bfloat16,
   the tensor-core bodies on real activations: one ragged chunk's layers
   over MAIN's mixed block (fp pages), one decode step of its slots after
   it, and one flash prefill of two prompts, each layer's attention
   output from the kernel against the
   plain version's on the same inputs, per row max |diff| within 1.6e-2
   x the row's max |plain|; a planted off-by-one mask must fail that.
7. Dense serving: qwen3-0p6b at full width in bfloat16 with
   flash_attention on: generate_compiled and generate_chunked (equal
   tokens) on 8 mixed greedy/sampled requests, a 3000-token prompt
   (chunked prefill), beam, lookahead, and an int8 weights + int8 dense
   cache engine; the flash kernel's launches equal n_layers x the flash
   prefills the engines counted, and no plain attention runs.

8. The rest of the single-card engine, qwen3-0p6b in bfloat16 at full
   width, every engine on the CUDA kernels (each phase resets the
   counts, then checks one ragged launch a layer per chunk and
   chunk_steps - 1 decode launches, and no plain version): speculative
   serving over fp and int8 pages (16 requests, half repetitive, spec on
   and off: greedy streams equal or parted only at a near-tie, the plain
   top-two gap logged; drafts packed, more than one token per verify
   pass, verify slots of 8 drafts; tokens/s both ways as readings);
   migration over fp, int8 and int4 pages between two engines (a stream
   frozen mid-decode, shipped through the TLTS frame and adopted, equal
   to its uninterrupted run; nothing left in transit; int4 → int8
   refused), one prefill→decode handoff and a drain that sheds its queue;
   the host-RAM tier (a prefix churned out and promoted back) and one
   fleet pull; two tenants (bf16 and int8 weights) on one shared page
   pool, each equal to its solo runs within its quota; and a live weight
   publish mid-stream. gemm_rows reads whether a row's bits depend on the
   GEMM's height (also on the host: c.gemm_rows("cpu")).
9. Checkpoints: qwen3-0p6b (phase 8's seeded bf16 tree) written by the
   port's export_hf in 256 MiB shards with an index and an HF Qwen3
   config under build/checkpoints/, read back by load_params with no
   config given (the preset's config, every leaf bitwise; layers [10,
   14) alone equal that slice), its load time and rate printed beside
   the card's name and power limit, and 8 requests served through the
   kernels from the loaded tree token-equal to an engine over the source
   tree. Then mixtral-8x7b at full width and 2 of its 32 layers (seeded
   bf16, default 4 GiB shards), loaded back bitwise and served through
   the kernels over fp and int8 pages, a greedy request alone equal to
   its co-batched stream. In each of those runs the first chunk's ragged
   launches and the first live decode step's paged_attention launches
   (Hq 32, Hkv 8, hd 128, pages of 16) are held per layer against their
   plain versions on the same inputs, as bf16 parity (phase 6) holds
   them, with a planted fault above the bound (the ragged launch's own
   key masked; the decode launch's query heads over the next kv head).
   Each layer's dense-dispatch MoE MLP of one ragged chunk is held per
   row within 1.6e-2 x the row's max of a float32 reference that routes
   apart from the program (the plain router product, numpy's stable
   top-2 on the host, which ttr.top_k must match) and runs only each
   token's top-2 experts; a third expert's gate switched on reads above
   that bound, and the capacity dispatch at capacity factor E/K is
   within it of the dense dispatch. The checkpoints are deleted at the
   end of the phase.
10. The node path: a port ValidatorNode (HTTP endpoint) and WorkerNode
   on 127.0.0.1 (keys and logs under build/node/), the worker on the
   card. POST /request-model hosts qwen3-0p6b at full width (seeded
   bf16 weights, the default int8 KV pages) and 8 concurrent greedy
   /v1/generate requests (prompts of 64 to 1536 bytes, 64 new tokens), a
   streamed /v1/chat/completions and a sampled request flow through the
   validator's remote ContinuousBatcher, GENERATE and TOKEN frames, and
   the worker's ContinuousEngine. Held: every request finishes; the
   worker engine made one ragged launch a layer per chunk and
   chunk_steps - 1 decode launches, in int8, and no plain version ran;
   each greedy request's tokens equal, and its HTTP text equals the text
   of, an in-process ContinuousBatcher over the same seeded tree with the
   worker's knobs; the streamed chat's deltas join to the plain run of
   the same request; neither node's network process maps a torch or jax
   library; /stats shows int8 pages of 59,136 bytes a position,
   /metrics carries tlink_engine_* and /healthz lists the model. Prints
   client tokens/s and request latency over HTTP, and the engine's
   first-token times (from /trace) beside the in-process run's: readings
   with the card's name and power limit, not claims.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine import paged
from tensorlink_tpu_torch.engine.loader import export_hf, load_params
from tensorlink_tpu_torch.engine.paged import PagedKVCache, paged_ragged_step
from tensorlink_tpu_torch.engine.sampling import SamplingParams
from tensorlink_tpu_torch.ml.batching import ContinuousBatcher
from tensorlink_tpu_torch.models import config_presets, init_params
from tensorlink_tpu_torch.models import transformer as ttr
from tensorlink_tpu_torch.models.quant import (
    pack_int4,
    quantize_kv,
    quantize_kv4,
    unpack_int4,
)
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.ops import attention as att
from tensorlink_tpu_torch.parallel.expert import sparse_moe_mlp

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# free-running f32 pages after 3 chunks over 28 layers, in units of the
# per-layer 2e-5 bound: earlier H100 runs read 2.1-2.3
FREE_RUNNING_X = 4.0
# free-running f32 logits, |kernel - plain| at every draw made from equal
# tokens, per page format: H100 readings 3.2e-5, 1.5e-3 and 1.1e-2 (the
# int4 slot that parts does so at a plain top-two gap of 3.8e-4)
FREE_RUNNING_LOGITS = {"fp": 1e-4, "int8": 5e-3, "int4": 3e-2}
KV_BYTES_PER_TOKEN = {"fp": 114_688, "int8": 59_136, "int4": 30_464}
MAIN = dict(S=8, C=128, Hq=16, Hkv=8, hd=128, page=16, n_pp=256)
MAIN_STARTS = [0, 896, 1536, 3071, 2000, 57, 4000, 0]
MAIN_NVALID = [128, 128, 1, 1, 1, 1, 1, 0]  # 2 prefills, 5 decodes, idle
MAIN_LENGTHS = [0, 1, 17, 777, 2048, 3100, 4000, 4096]
FORMATS = att.FORMATS  # "fp", "int8", "int4"
REPLACES = {
    "ragged_paged_attention": "tensorlink_tpu/ops/attention.py:711",
    "paged_attention": "tensorlink_tpu/ops/attention.py:899",
    "paged_prefill_attention": "tensorlink_tpu/ops/attention.py:451",
}
SOURCE = {
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "paged_attention": "ragged_paged_attention.cu",
    "paged_prefill_attention": "ragged_paged_attention.cu",
}
_RAGGED_DESIGN = (
    "bf16: tensor cores (mma.sync m16n8k16, f32 accumulators), 64-row "
    "tiles of one (slot, kv head), 64-position key stages gathered through "
    "the block table by cp.async into a 2- or 3-stage ring (2 for fp pages "
    "at hd 128: two blocks an SM), 512-position splits "
    "merged by a combine pass; int8/int4 codes widened exactly to bf16, K "
    "scales on score columns, V scales folded into P. f32: scalar f32 "
    "FMAs over 16-row tiles, 16 pages per block, dequantized at the load")
DESIGN = {
    "ragged_paged_attention": _RAGGED_DESIGN,
    "paged_prefill_attention": "the ragged kernel with S = 1; "
                               + _RAGGED_DESIGN,
    "paged_attention": (
        "the ragged kernel's one-row (C = 1) launch, each slot's row at its "
        "length - 1 read from lengths in the kernel; bf16: its tensor-core "
        "body on narrow tiles, all 4 warps on each 64-position stage (QK^T "
        "by key columns, P exchanged in shared memory, PV by output "
        "columns), bitwise equal to the ragged kernel's row at the same "
        "position; " + _RAGGED_DESIGN),
    "flash_attention": (
        "bf16: warpgroup tensor cores (wgmma m64nNk16 from 128B-swizzled "
        "shared tiles, f32 accumulators, P in registers as the PV A "
        "operand), 2 warpgroups x 64 rows over the G heads of a kv head, "
        "64-key K/V tiles through a 2-stage cp.async ring, 2 blocks per "
        "SM at hd <= 128, q tiles with the most keys first. f32: scalar "
        "f32 FMAs, 64-row x 32-key tiles per query head"),
}
# dense parity: f32 last-token logits, |kernel - plain| after 28 layers of
# a flash prefill: H100 reading 6.5e-6 (plain logits std 0.64)
DENSE_LOGITS = 2e-5
# bf16 parity: each full-width layer's attention output (before o_proj and
# the residual), the tensor-core kernel against its plain version on the
# same inputs, per row: max |diff| within this times the row's max
# |plain| (the kernels' own bf16 tolerance, per output row). A planted
# fault, the plain version with each row's own key masked (an off-by-one
# causal mask), must read above it
BF16_ATTN_TOL = 1.6e-2
DENSE_SEQ_BUCKETS = (128, 256, 512, 1024, 2048)
DENSE_NEW = 64  # new tokens per request in the dense serving run
SERVE_RUNS = (  # (page format, weight quant, requests)
    ("none", None, 16),
    ("int8", None, 16),
    ("int4", "int8", 8),
)


def log(*a):
    print(*a, flush=True)


def _fmt(kv_quant: str) -> str:
    return "fp" if kv_quant == "none" else kv_quant


# -- phase 1 -----------------------------------------------------------
def _smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = _smi()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


# -- phase 2 -----------------------------------------------------------
def build_phase() -> None:
    t0 = time.monotonic()
    secs = _build.build_all()
    log(f"build: {json.dumps(secs)} wall {time.monotonic() - t0:.2f}s")
    for name in _build.KERNELS:
        for fn, usage in _ptxas_usage(_build.build_log(name)):
            log(f"  ptxas {name} {fn}: {usage}")


def _ptxas_usage(text: str) -> list:
    """``(kernel<template args>, "registers, static shared memory;
    spills")`` per entry function in ``nvcc -Xptxas -v`` output. Dynamic
    shared memory is set at the launch (each source's shape structs)."""
    out, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = _kernel_name(m.group(1)), ""
        elif fn and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif fn and "registers" in line:
            out.append((fn, f"{line.split(':', 1)[-1].strip()}; {spill}"))
            fn = None
    return out


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel: its identifier and template
    arguments (dtype, integers)."""
    m = re.search(r"(flash_bf16_kernel|flash_kernel|attend_bf16|"
                  r"combine_bf16|attend_kernel|combine_kernel)(I.*)?",
                  mangled)
    if not m:
        return mangled
    targs = (m.group(2) or "")[1:]
    args = ["float"] if targs.startswith("f") else \
        ["bf16"] if targs.startswith("13__nv_bfloat16") else []
    ints = re.findall(r"Li(\d+)E", targs)
    return m.group(1) + (f"<{','.join(args + ints)}>" if targs else "")


# -- phase 3 -----------------------------------------------------------
def _pages(P, Hkv, page, hd, dtype, fmt, gen):
    """K and V page pools of random normals, in ``dtype`` for fp pages or
    quantized by the port's quantize_kv / quantize_kv4: ``(k, v, scales)``
    with ``scales`` the k_scale / v_scale keywords (empty for fp)."""
    dev = torch.device("cuda")
    out = []
    for _ in range(2):
        x = torch.randn((P, Hkv, page, hd), generator=gen, device=dev)
        if fmt == "fp":
            out.append((x.to(dtype), None))
        else:
            out.append((quantize_kv if fmt == "int8" else quantize_kv4)(x))
    (k, ks), (v, vs) = out
    return k, v, ({} if ks is None else dict(k_scale=ks, v_scale=vs))


def _case(rng, S, C, Hq, Hkv, hd, page, n_pp, starts, nv, lens, dtype,
          fmt="fp"):
    dev = torch.device("cuda")
    P = 1 + S * n_pp
    bt = rng.permutation(np.arange(1, P))[: S * n_pp].reshape(S, n_pp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    q = torch.from_numpy(rng.standard_normal((S, C, Hq, hd), np.float32))
    k, v, sc = _pages(P, Hkv, page, hd, dtype, fmt, gen)
    return dict(
        q=q.to(dev, dtype), k=k, v=v, sc=sc, bt=i32(bt), starts=i32(starts),
        nv=i32(nv), lens=i32(lens), scale=hd**-0.5,
    )


def _ragged(c, kernel):
    fn = att.ragged_paged_attention if kernel else \
        att.ragged_paged_attention_ref
    return fn(c["q"], c["k"], c["v"], c["bt"], c["starts"], c["nv"],
              scale=c["scale"], **c["sc"])


def _decode(c, kernel):
    fn = att.paged_attention if kernel else att.paged_attention_ref
    return fn(c["q"][:, 0].contiguous(), c["k"], c["v"], c["bt"], c["lens"],
              scale=c["scale"], **c["sc"])


def _prefill(c, kernel, slot=1):
    """Slot ``slot`` of a case as one paged_prefill_attention call: its
    whole query block at its start, over its block-table row."""
    fn = att.paged_prefill_attention if kernel else \
        att.paged_prefill_attention_ref
    return fn(c["q"][slot], c["k"], c["v"], c["bt"][slot],
              c["starts"][slot], scale=c["scale"], **c["sc"])


EDGE_CASES = [
    # S, C, Hq, Hkv, hd, page, n_pp, starts, n_valid, lengths
    (4, 8, 8, 2, 32, 8, 4, [13, 0, 11, 0], [1, 8, 5, 0], [0, 1, 9, 32]),
    (3, 16, 8, 1, 64, 4, 8, [0, 3, 17], [16, 16, 9], [5, 32, 0]),
    (2, 8, 4, 2, 32, 8, 2, [0, 0], [0, 0], [0, 0]),  # all idle
    (2, 8, 4, 2, 32, 8, 4, [13, 0], [5, 0], [14, 3]),  # verify-style rows
    (2, 4, 32, 2, 256, 16, 3, [20, 1], [4, 3], [47, 16]),  # G 16, hd 256
    (2, 3, 48, 2, 128, 32, 2, [5, 60], [3, 1], [63, 33]),  # G 24: 2 tiles
    # pages that neither divide the bf16 body's 64-position stages nor are
    # multiples of them: 24, 96, and 48 across a 512-position split
    (3, 16, 8, 2, 128, 24, 6, [0, 40, 100], [16, 16, 1], [24, 130, 101]),
    (2, 4, 8, 2, 64, 96, 3, [200, 5], [4, 1], [204, 6]),
    (2, 16, 4, 2, 32, 48, 12, [500, 0], [16, 3], [516, 575]),
    # head_dim 16: bf16 only (the scalar bodies need a multiple of 32, so
    # f32 and paged_attention skip these); the page-24 case's int4 rows
    # are 8 bytes
    (3, 8, 8, 1, 16, 8, 4, [0, 3, 17], [8, 8, 1], [5, 9, 18]),
    (2, 16, 4, 2, 16, 16, 3, [0, 20], [16, 1], [16, 21]),
    (2, 8, 4, 1, 16, 24, 4, [30, 3], [8, 1], [40, 90]),
]
# paged_prefill_attention: tests/test_ops.py's small cases, as (C, Hq, Hkv,
# hd, page, n_pp, start), plus MAIN's second slot (C 128 at start 896,
# n_pp 256) and a page of 24; its head_dim 16 case in bf16 only
PREFILL_CASES = [
    (8, 8, 2, 32, 8, 4, 0),
    (8, 8, 2, 32, 8, 4, 13),
    (4, 8, 1, 64, 4, 8, 27),
    (8, 8, 2, 128, 24, 4, 50),
    (16, 4, 4, 16, 16, 3, 16),
]


def _scalar_takes(hd: int) -> bool:
    """The scalar bodies (every f32 launch) need head_dim a multiple of
    32; the bf16 tensor-core bodies take any multiple of 16."""
    return hd % 32 == 0


def _err(a, b, tol):
    a, b = a.float().cpu(), b.float().cpu()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output is not finite")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    return float((a - b).abs().max())


def _variants():
    return [(n, f) for n in REPLACES for f in FORMATS]


def kernel_checks() -> dict:
    """Every kernel variant against its plain version; returns the max
    abs error per (kernel, format) and dtype."""
    rng = np.random.default_rng(0)
    m = MAIN
    errs = {v: {"float32": 0.0, "bfloat16": 0.0} for v in _variants()}
    cases = [(m["S"], m["C"], m["Hq"], m["Hkv"], m["hd"], m["page"],
              m["n_pp"], MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS)]
    cases += EDGE_CASES
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[1]

        def note(key, e):
            errs[key][dname] = max(errs[key][dname], e)

        for fmt in FORMATS:
            for i, spec in enumerate(cases):
                if dtype == torch.float32 and not _scalar_takes(spec[4]):
                    continue
                c = _case(rng, *spec, dtype=dtype, fmt=fmt)
                got, want = _ragged(c, True), _ragged(c, False)
                torch.cuda.synchronize()
                note(("ragged_paged_attention", fmt), _err(got, want, tol))
                for s, nv in enumerate(spec[8]):  # rows past n_valid: zeros
                    tail = got[s, nv:]
                    if tail.numel() and float(tail.abs().max()) != 0.0:
                        raise AssertionError("a row past n_valid is not zero")
                got, want = _decode(c, True), _decode(c, False)
                torch.cuda.synchronize()
                note(("paged_attention", fmt), _err(got, want, tol))
                if i == 0:  # MAIN's slot 1: C 128 at 896 over 256 pages
                    got, want = _prefill(c, True), _prefill(c, False)
                    torch.cuda.synchronize()
                    note(("paged_prefill_attention", fmt),
                         _err(got, want, tol))
            for C, Hq, Hkv, hd, page, n_pp, start in PREFILL_CASES:
                if dtype == torch.float32 and not _scalar_takes(hd):
                    continue
                # slot 1 of a 2-slot case: its table row, its start
                c = _case(rng, 2, C, Hq, Hkv, hd, page, n_pp, [0, start],
                          [C, C], [0, 0], dtype=dtype, fmt=fmt)
                got, want = _prefill(c, True), _prefill(c, False)
                torch.cuda.synchronize()
                note(("paged_prefill_attention", fmt), _err(got, want, tol))
    log("kernels vs plain versions: max abs err " + json.dumps(
        {f"{n}/{f}": e for (n, f), e in errs.items()}))
    return errs


def nibble_order_check() -> None:
    """Known answer for the int4 split-half layout inside both kernels:
    V row 0 of a one-page slot holds codes c_d = (d % 15) - 7 (packed by
    pack_int4, scale 1), the query sees only position 0, so the output
    must be c_d exactly. An interleaved unpack would give element 2b the
    code of element b."""
    dev = torch.device("cuda")
    hd, page = 128, 16
    codes = torch.randint(-7, 8, (2, 1, page, hd), device=dev,
                          dtype=torch.int32)
    want = torch.arange(hd, device=dev) % 15 - 7
    codes[1, 0, 0] = want
    v = pack_int4(codes)
    k = pack_int4(torch.zeros_like(codes))
    if not torch.equal(unpack_int4(v), codes):
        raise AssertionError("pack_int4/unpack_int4 do not round-trip")
    ones = torch.ones((2, 1, page), device=dev)
    sc = dict(k_scale=ones, v_scale=ones.clone())
    bt = torch.ones((1, 1), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.randn((1, 1, 2, hd), device=dev)  # 2 query heads, G 2
    outs = {
        "paged_attention": att.paged_attention(q[:, 0], k, v, bt, one,
                                               scale=1.0, **sc)[0],
        "ragged_paged_attention": att.ragged_paged_attention(
            q, k, v, bt, zero, one, scale=1.0, **sc)[0, 0],
        "paged_prefill_attention": att.paged_prefill_attention(
            q[0], k, v, bt[0], 0, scale=1.0, **sc)[0],
    }
    torch.cuda.synchronize()
    for name, out in outs.items():
        for h in range(out.shape[0]):
            if not torch.equal(out[h], want.float()):
                bad = int((out[h] != want.float()).sum())
                raise AssertionError(f"{name}: int4 nibble order wrong "
                                     f"({bad} of {hd} elements)")
    log("int4 nibble order (split-half) inside the kernels: exact")


# chunks of a 128-position prefill that framing_check runs on their own:
# wide tiles, and chunks of 1, 4 and 8 positions (2, 8 and 16 rows at G 2:
# narrow tiles, whose four warps split each key stage). At start 300 the
# whole chunk's warps hold positions 316..323 and 380..387, across the key
# stages at 320 and 384: the chunks [16, 20) and [80, 84) see no key of
# the later stage, which the whole chunk computes for them fully masked
FRAMINGS = ((0, 40), (40, 128), (0, 64), (64, 128), (0, 1), (127, 128),
            (40, 44), (62, 66), (56, 64), (120, 128), (16, 20), (80, 84))


def framing_check() -> None:
    """Chunk-framing invariance of the ragged kernel's bf16 body, which
    the prefix cache's bitwise reuse rests on: a prefill slot's 128 rows
    at start 300, run whole and as each chunk of FRAMINGS (each at its own
    start, beside an idle slot), give bitwise-equal rows in every page
    format."""
    dev = torch.device("cuda")
    for fmt in FORMATS:
        c = _case(np.random.default_rng(5), 2, 128, 16, 8, 128, 16, 64,
                  [300, 0], [128, 0], [0, 0], torch.bfloat16, fmt)
        full = _ragged(c, True)
        for a, b in FRAMINGS:
            part = att.ragged_paged_attention(
                c["q"][:, a:b].contiguous(), c["k"], c["v"], c["bt"],
                torch.tensor([300 + a, 0], dtype=torch.int32, device=dev),
                torch.tensor([b - a, 0], dtype=torch.int32, device=dev),
                scale=c["scale"], **c["sc"])
            if not torch.equal(part[0], full[0, a:b]):
                raise AssertionError(f"ragged {fmt}: rows [{a}, {b}) differ "
                                     "bitwise from the whole chunk's")
    log(f"ragged chunk framing (bf16; fp, int8, int4 pages): rows bitwise "
        f"equal over {len(FRAMINGS)} framings of a 128-row chunk (chunks of "
        f"1 to 88 positions)")


# decode_rows_check: (S, Hq, Hkv, hd, page, n_pp, lengths). MAIN's decode
# slots, then head_dim 16 (bf16 only: the f32 scalar body needs a multiple
# of 32; G 8 fills half a narrow tile) and pages of 24 and 96
DECODE_ROWS_CASES = [
    (MAIN["S"], MAIN["Hq"], MAIN["Hkv"], MAIN["hd"], MAIN["page"],
     MAIN["n_pp"], MAIN_LENGTHS),
    (3, 8, 1, 16, 8, 20, [5, 9, 150]),
    (2, 4, 1, 16, 24, 8, [40, 190]),
    (3, 8, 2, 128, 24, 8, [24, 130, 101]),
    (2, 8, 2, 64, 96, 3, [204, 6]),
]
# (C, valid rows) of the ragged launches a decode row is held to: a
# one-row slot and verify slots of 4 and of 9 positions (3 and 8 drafts;
# at G = 2 the 9-position slot is 18 rows, a wide tile), one valid row in
# a 128-row launch (a narrow tile of the general kernel, as the decode
# slots of the unified step), and a 128-row prefill chunk (wide tiles)
DECODE_ROW_CHUNKS = ((1, 1), (4, 4), (9, 9), (128, 1), (128, 128))
VERIFY_SLOTS = (4, 9)  # valid rows of the chunks whose every row is held


def decode_rows_check() -> int:
    """The contract speculative decoding's verify == sequential decode
    rests on: a paged_attention row at length p + 1 is bitwise the
    ragged kernel's row at position p, whether that row sits in a one-row
    slot, in a verify slot of 4 or 9 positions (each row checked), alone
    in a 128-row launch or in a 128-row prefill chunk (DECODE_ROW_CHUNKS),
    in bf16 (the tensor-core body: narrow and wide tiles) and in f32 (the
    scalar body), over fp, int8 and int4 pages. Returns the rows
    compared."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    n_rows = 0
    for dtype in (torch.bfloat16, torch.float32):
        for fmt in FORMATS:
            for S, Hq, Hkv, hd, page, n_pp, lens in DECODE_ROWS_CASES:
                if dtype == torch.float32 and not _scalar_takes(hd):
                    continue
                cap = n_pp * page
                c = _case(rng, S, 1, Hq, Hkv, hd, page, n_pp, [0] * S,
                          [0] * S, lens, dtype, fmt)
                for C, n_v in DECODE_ROW_CHUNKS:
                    C = min(C, cap)
                    n_v = min(n_v, C)
                    st = [min(max(n - n_v, 0), cap - n_v) for n in lens]
                    nv = [n_v if n > 0 else 0 for n in lens]
                    q = torch.from_numpy(rng.standard_normal(
                        (S, C, Hq, hd), np.float32)).to(dev, dtype)
                    rag = att.ragged_paged_attention(
                        q, c["k"], c["v"], c["bt"],
                        torch.tensor(st, dtype=torch.int32, device=dev),
                        torch.tensor(nv, dtype=torch.int32, device=dev),
                        scale=c["scale"], **c["sc"])
                    # the rows checked: every row of a verify slot, the
                    # last valid position's row otherwise
                    rows = range(n_v) if n_v in VERIFY_SLOTS else [None]
                    for j in rows:
                        at = [(n - 1 - a) if j is None else j
                              for n, a in zip(lens, st)]
                        at = [max(x, 0) for x in at]
                        dlen = [a + x + 1 if n > 0 else 0
                                for n, a, x in zip(lens, st, at)]
                        qd = q[torch.arange(S, device=dev),
                               torch.tensor(at, device=dev)].contiguous()
                        dec = att.paged_attention(
                            qd, c["k"], c["v"], c["bt"],
                            torch.tensor(dlen, dtype=torch.int32,
                                         device=dev),
                            scale=c["scale"], **c["sc"])
                        for s in range(S):
                            if dlen[s] == 0:
                                continue
                            if not torch.equal(dec[s], rag[s, at[s]]):
                                raise AssertionError(
                                    f"decode rows ({dtype}, {fmt}, hd {hd}, "
                                    f"page {page}, {n_v} of {C} rows): slot "
                                    f"{s} at length {dlen[s]} differs from "
                                    f"the ragged row at {dlen[s] - 1}")
                            n_rows += 1
    torch.cuda.synchronize()
    log(f"decode rows == ragged rows bitwise (bf16 and f32; fp, int8, int4 "
        f"pages; (C, valid rows) {DECODE_ROW_CHUNKS}): {n_rows} rows")
    return n_rows


def _time_ms(fn, runs=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _graph_ms(fn, reps=10, runs=30) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed between CUDA events (median of ``runs``
    replays after warm-up), divided by ``reps``. The wrappers' host work
    (checks, allocation, the launch itself) is outside the timed region,
    which _time_ms (eager) includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(ts)


def _gathered(c, rows=None):
    """Per-slot contiguous KV [S, Hkv, K, hd] of fp pages for the library
    yardstick (gathered once, outside the timed region); ``rows`` picks
    slots."""
    bt = c["bt"] if rows is None else c["bt"][rows]
    S, n_pp = bt.shape
    _, Hkv, page, hd = c["k"].shape

    def g(p):
        x = p[bt.long()]  # [S, n_pp, Hkv, page, hd]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Hkv, n_pp * page, hd)

    return g(c["k"]).contiguous(), g(c["v"]).contiguous()


def _kv_bytes_per_position(fmt, hd, elt):
    """Bytes of one position's K or V row of one kv head: the codes plus
    its f32 scale for quantized pages."""
    return {"fp": hd * elt, "int8": hd + 4, "int4": hd // 2 + 4}[fmt]


def kernel_timings() -> dict:
    """Each variant at the main path's shape in bfloat16 q: kernel, plain
    version and (fp pages only) one SDPA call, with the bound computed
    from this run's inputs."""
    m = MAIN
    dtype = torch.bfloat16
    S, C, Hq, Hkv, hd = m["S"], m["C"], m["Hq"], m["Hkv"], m["hd"]
    G, K, elt, page = Hq // Hkv, m["n_pp"] * m["page"], 2, m["page"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(K, device="cuda")
    starts, nvs, lens = MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS
    out = {}
    for fmt in FORMATS:
        c = _case(np.random.default_rng(1), S, C, Hq, Hkv, hd, page,
                  m["n_pp"], starts, nvs, lens, dtype, fmt)
        row = _kv_bytes_per_position(fmt, hd, elt)
        lib = {}
        if fmt == "fp":
            kg, vg = (x.repeat_interleave(G, dim=1) for x in _gathered(c))
            q_pos = torch.tensor(starts, device="cuda")[:, None] + \
                torch.arange(C, device="cuda")[None, :]
            mask = pos[None, None, :] <= q_pos[:, :, None]  # [S, C, K]
            mask[:, :, 0] = True  # idle rows: keep SDPA finite (timing only)
            qs = c["q"].permute(0, 2, 1, 3)  # [S, Hq, C, hd]
            lib["ragged_paged_attention"] = lambda: sdpa(
                qs, kg, vg, attn_mask=mask[:, None])
            dmask = pos[None, :] < torch.tensor(lens, device="cuda")[:, None]
            dmask[:, 0] = True  # length-0 slot: keep SDPA finite
            qd = c["q"][:, 0].contiguous()[:, :, None]  # [S, Hq, 1, hd]
            lib["paged_attention"] = lambda: sdpa(
                qd, kg, vg, attn_mask=dmask[:, None, None])
            # the prefill slot alone: its KV up to start + C, causal rows
            kp, vp = (x.repeat_interleave(G, dim=1)
                      for x in _gathered(c, rows=[1]))
            pmask = pos[None, :] <= (starts[1] + torch.arange(
                C, device="cuda"))[:, None]
            qp = c["q"][1:2].permute(0, 2, 1, 3)
            lib["paged_prefill_attention"] = lambda: sdpa(
                qp, kp, vp, attn_mask=pmask[None, None])

        # ragged: rows (s, c) valid when c < n_valid; row sees keys <= start+c
        live = sum(st + nv for st, nv in zip(starts, nvs) if nv > 0)
        pairs = sum(st + j + 1 for st, nv in zip(starts, nvs)
                    for j in range(nv))
        n_bytes = (sum(nvs) * Hq * hd * elt  # q: the valid rows only
                   + c["q"].numel() * elt  # every output row (zeros too)
                   + 2 * live * Hkv * row  # live K and V (+ scales), once
                   + sum(-(-(st + nv) // page) for st, nv in
                         zip(starts, nvs) if nv > 0) * 4 + 2 * S * 4)
        out[("ragged_paged_attention", fmt)] = dict(
            fn=lambda c=c: _ragged(c, True),
            plain=lambda c=c: _ragged(c, False),
            bytes=n_bytes, flops=4 * hd * Hq * pairs,
        )
        n_live = sum(1 for n in lens if n > 0)  # a length-0 slot reads no q
        n_bytes = ((n_live + S) * Hq * hd * elt + 2 * sum(lens) * Hkv * row
                   + sum(-(-n // page) for n in lens) * 4 + S * 4)
        out[("paged_attention", fmt)] = dict(
            fn=lambda c=c: _decode(c, True),
            plain=lambda c=c: _decode(c, False),
            bytes=n_bytes, flops=4 * hd * Hq * sum(lens),
        )
        st, n = starts[1], nvs[1]
        n_bytes = (2 * n * Hq * hd * elt + 2 * (st + n) * Hkv * row
                   + -(-(st + n) // page) * 4 + 2 * 4)
        out[("paged_prefill_attention", fmt)] = dict(
            fn=lambda c=c: _prefill(c, True),
            plain=lambda c=c: _prefill(c, False), bytes=n_bytes,
            flops=4 * hd * Hq * sum(st + j + 1 for j in range(n)),
        )
        for name in REPLACES:
            r = out[(name, fmt)]
            fn = r.pop("fn")
            r["ms"] = _time_ms(fn)
            r["device_ms"] = _graph_ms(fn)
            r["plain_ms"] = _time_ms(r.pop("plain"), runs=20)
            has = name in lib
            r["library_ms"] = _time_ms(lib[name]) if has else None
            r["library_device_ms"] = _graph_ms(lib[name]) if has else None
            t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = r["flops"] / PEAK_FLOPS[dtype] * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            lib_s, lib_d = ("null", "null") if not has else (
                f"{r['library_ms']:.4f}", f"{r['library_device_ms']:.4f}")
            log(f"{name}/{fmt} (bf16 q, main-path shape): kernel_ms "
                f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                f"{lib_s} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}: "
                f"{r['bytes']} B, {r['flops']} flop); device kernel_ms "
                f"{r['device_ms']:.4f} library_ms {lib_d}")
        del c
        torch.cuda.empty_cache()
    return out


def kernel_profile(runs: int = 20) -> dict:
    """Device time of each CUDA kernel that one paged_attention and one
    ragged_paged_attention call launch at MAIN's shapes in bfloat16 (the
    attend and combine passes apart), per page format: ``runs`` calls of
    each under torch.profiler, mean microseconds per call by kernel
    name."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for fmt in FORMATS:
        c = _case(np.random.default_rng(1), MAIN["S"], MAIN["C"], MAIN["Hq"],
                  MAIN["Hkv"], MAIN["hd"], MAIN["page"], MAIN["n_pp"],
                  MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS, torch.bfloat16,
                  fmt)
        for name, fn in (("paged_attention", lambda: _decode(c, True)),
                         ("ragged_paged_attention", lambda: _ragged(c, True))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
            times = {}
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", None)
                if t is None:
                    t = getattr(e, "cuda_time_total", 0.0)
                if t > 0:  # "void (anonymous namespace)::attend_bf16<..>(.."
                    key = re.sub(r"\(.*", "", e.key.replace(
                        "(anonymous namespace)::", "")).replace("void ", "")
                    times[key] = t / runs
            out[(name, fmt)] = times
            log(f"profile {name}/{fmt} (bf16 q, main-path shape): device us "
                f"per call by kernel {json.dumps(times)}")
        del c
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _patched_kernels(name: str, patches):
    """Launches inside use kernels built from a copy of ops/csrc under
    build/<name>/ in which each ``(old, new)`` of ``patches`` replaces
    its text, found exactly once, in ragged_paged_attention.cu."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / name
    src = root / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    cu = src / "ragged_paged_attention.cu"
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: patch target not found once: "
                                 f"{old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    saved = _build.CSRC, _build.BUILD_DIR, _build._libs
    _build.CSRC, _build.BUILD_DIR, _build._libs = src, root / "lib", {}
    try:
        yield
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._libs = saved


NARROW_TEST = "bool narrow_rows(int rows) { return rows <= NR; }"


def wide_tile_timings() -> dict:
    """kernel_timings() of the ragged kernel with its narrow tiles
    switched off (NARROW_TEST answering false): every tile wide, so a
    decode tile's products run on one warp while three wait (PR 4's
    tile). Not a phase of main(): run it beside kernel_timings() in one
    process to see what the narrow tiles buy."""
    off = NARROW_TEST.replace("rows <= NR", "false")
    with _patched_kernels("wide_tiles", [(NARROW_TEST, off)]):
        log("wide tiles only (narrow tiles off):")
        return kernel_timings()


# the attend pass with its products and softmax skipped (every stage's
# copies still made), and with its copies skipped (every stage computed on
# what shared memory holds): what each costs alone
ATTEND_PARTS_OFF = {
    "compute off": [
        ("    if (narrow) {\n      // Each warp takes",
         "    if (k0 < 0) {\n      // Each warp takes"),
        ("    } else if (warp_live && k0 <= lim_hi) {",
         "    } else if (k0 < 0) {"),
    ],
    "copies off": [
        ("  auto load_stage = [&](int k0, int st) {\n",
         "  auto load_stage = [&](int k0, int st) {\n"
         "    if (k0 >= 0) return;\n"),
    ],
}


def attend_parts_profile() -> dict:
    """kernel_profile() of builds with each part of the attend pass in
    ATTEND_PARTS_OFF switched off (their outputs are garbage; only the
    times count). Not a phase of main()."""
    out = {}
    for name, patches in ATTEND_PARTS_OFF.items():
        with _patched_kernels(name.replace(" ", "_"), patches):
            log(f"attend pass, {name}:")
            out[name] = kernel_profile()
    return out


# flash_attention: (B, T, Hq, Hkv, hd, window). The main shape first (k/v
# read in place from a longer cache, as the engine passes them), then
# tests/test_ops.py's shapes, its three windows, two T that are no
# multiple of the kernel's tiles, and head_dim 64 and 256; the head_dim 16
# shapes (test_ops.py's MQA shape, and windows 8 and 16 below a tile) run
# in bf16 only (the f32 scalar body needs a multiple of 32)
FLASH_MAIN = (4, 2048, 16, 8, 128, None)
FLASH_CASES = [
    FLASH_MAIN,
    (2, 256, 8, 2, 64, None), (1, 128, 4, 4, 32, None),
    (1, 64, 2, 2, 128, None),
    (1, 128, 4, 2, 32, 8), (1, 128, 4, 2, 32, 64), (1, 128, 4, 2, 32, 200),
    (2, 100, 16, 8, 128, None), (3, 37, 16, 8, 128, None),
    (2, 512, 8, 2, 64, 200), (1, 256, 8, 1, 256, None), (2, 37, 8, 4, 256, 16),
    (2, 128, 8, 1, 16, None), (1, 128, 4, 2, 16, 8), (2, 100, 8, 2, 16, 16),
]


def _flash_case(rng, B, T, Hq, Hkv, hd, window, dtype, pad=64):
    """Seeded q and k/v views ``[:, :T]`` of a ``[B, T + pad, Hkv, hd]``
    cache (the engine's layout), in ``dtype`` on the card."""
    dev = torch.device("cuda")

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    q = rand((B, T, Hq, hd))
    k = rand((B, T + pad, Hkv, hd))[:, :T]
    v = rand((B, T + pad, Hkv, hd))[:, :T]
    return dict(q=q, k=k, v=v, scale=hd**-0.5, window=window)


def _flash(c, kernel):
    fn = att.flash_attention if kernel else att.flash_attention_ref
    return fn(c["q"], c["k"], c["v"], scale=c["scale"], window=c["window"])


def flash_checks() -> dict:
    """flash_attention against its plain version on every FLASH_CASES
    shape in float32 (rtol = atol = 2e-5) and bfloat16 (1.6e-2); returns
    the max abs error per dtype."""
    rng = np.random.default_rng(11)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[1]
        for spec in FLASH_CASES:
            if dtype == torch.float32 and not _scalar_takes(spec[4]):
                continue
            c = _flash_case(rng, *spec, dtype=dtype)
            got, want = _flash(c, True), _flash(c, False)
            torch.cuda.synchronize()
            try:
                e = _err(got, want, tol)
            except AssertionError as exc:
                raise AssertionError(f"flash_attention {spec} {dname}: "
                                     f"{exc}") from None
            errs[dname] = max(errs[dname], e)
    try:
        c = _flash_case(rng, 1, 100, 4, 2, 32, None, torch.float32)
        att.flash_attention(c["q"], c["k"], c["v"], scale=1.0, block_q=64,
                            block_k=64)
        raise AssertionError("flash_attention took T 100 with 64-row blocks")
    except ValueError:
        pass
    log(f"flash_attention vs plain version over {len(FLASH_CASES)} shapes: "
        f"max abs err {json.dumps(errs)}")
    return errs


def flash_timing() -> dict:
    """flash_attention at FLASH_MAIN in bfloat16: kernel, plain version and
    one scaled_dot_product_attention call (causal, GQA), with the bound
    from this run's shape."""
    B, T, Hq, Hkv, hd, _ = FLASH_MAIN
    dtype = torch.bfloat16
    c = _flash_case(np.random.default_rng(12), *FLASH_MAIN, dtype=dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (c[n].transpose(1, 2) for n in ("q", "k", "v"))
    def kernel():
        return _flash(c, True)

    def library():
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    r = dict(
        ms=_time_ms(kernel), device_ms=_graph_ms(kernel),
        plain_ms=_time_ms(lambda: _flash(c, False), runs=10),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        # each input read once, the output written once; 4 * hd FLOPs per
        # visible (query head, key) pair: T (T + 1) / 2 pairs per head
        bytes=(2 * B * T * Hq * hd + 2 * B * T * Hkv * hd) * 2,
        flops=4 * hd * Hq * B * T * (T + 1) // 2,
    )
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r["flops"] / PEAK_FLOPS[dtype] * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"flash_attention (bf16, B {B} T {T} Hq {Hq} Hkv {Hkv} hd {hd}): "
        f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
        f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
        f"({r['bound_by']}: {r['bytes']} B, {r['flops']} flop); device "
        f"kernel_ms {r['device_ms']:.4f} library_ms "
        f"{r['library_device_ms']:.4f}")
    del c, qt, kt, vt
    torch.cuda.empty_cache()
    return r


# -- phase 4 -----------------------------------------------------------
def _fill_quantized(cache, packed, gen):
    """Seeded random codes and scales (about the scale of N(0, 1) rows)
    under every page of a quantized cache."""
    levels = 7 if packed else 127
    lo = -128 if packed else -127  # int4: any packed byte
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(lo, 128, t.shape, generator=gen,
                              device=t.device, dtype=torch.int8))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_((2.5 + torch.rand(t.shape, generator=gen, device=t.device))
                / levels)


def _codes(pages, packed):
    return unpack_int4(pages) if packed else pages.to(torch.int32)


def _teacher_forced_layers(cfg, params, cache, arrays) -> float:
    """Both attention paths through each layer from the SAME layer input
    (the plain path's output feeds the next layer): each layer's output
    within rtol = atol = 2e-5, fp pages within that bound, quantized
    pages and scales byte-equal (the same quantize code on the same
    k/v). Returns the worst |diff| / (2e-5 + 2e-5 |plain|) ratio (<= 1
    passes)."""
    blk, starts, nv = arrays
    page, n_pp = cache.page_size, cache.pages_per_slot
    bt = cache.block_tables
    write_pg, write_off, pos, _ = paged._ragged_write_indices(
        bt, starts, nv, page, n_pp, blk.shape[1]
    )
    x = paged._embed_tokens(params, blk.long(), cfg)
    cos, sin = paged.rope_tables(pos, paged._rope_dim(cfg), cfg.rope_theta)
    worst = 0.0
    for i, lp in enumerate(paged._layers(params)):
        outs = []
        for kernel in (True, False):
            kv = tuple(t.clone() for t in cache.layer_kv(i))
            y, kv = paged._ragged_block(x, lp, cfg, cos, sin, kv, write_pg,
                                        write_off, bt, starts, nv, kernel)
            outs.append((y, kv))
        (yk, kvk), (yp, kvp) = outs
        pairs = [(yk, yp)]
        # page 0 is scratch: padding rows race to write it, nothing reads it
        if cache.quantized:
            for a, b in zip(kvk, kvp):
                if not torch.equal(a[1:], b[1:]):
                    raise AssertionError(f"layer {i}: quantized pages or "
                                         "scales differ between the paths")
        else:
            pairs += [(kvk[0][1:], kvp[0][1:]), (kvk[1][1:], kvp[1][1:])]
        for a, b in pairs:
            d = (a - b).abs() / (2e-5 + 2e-5 * b.abs())
            worst = max(worst, float(d.max()))
        x = yp
    return worst


def _free_running_pages(cfg, cache_k, cache_p) -> str:
    """Compare the two paths' fp pages after free running: held to
    FREE_RUNNING_X times the per-layer bound."""
    worst, ratio = 0.0, 0.0
    for a, b in ((cache_k.k, cache_p.k), (cache_k.v, cache_p.v)):
        for layer in range(cfg.n_layers):
            x, y = a[layer, 1:], b[layer, 1:]
            if not torch.isfinite(x).all():
                raise AssertionError("pages are not finite")
            d = (x - y).abs()
            worst = max(worst, float(d.max()))
            ratio = max(ratio, float((d / (2e-5 + 2e-5 * y.abs())).max()))
    if ratio > FREE_RUNNING_X:
        raise AssertionError(
            f"step parity: free-running pages differ by {worst:.3e}, "
            f"{ratio:.2f}x the per-layer bound (> {FREE_RUNNING_X})"
        )
    return (f"free-running pages max abs diff {worst:.3e} ({ratio:.3f}x "
            f"the per-layer 2e-5 bound over {cfg.n_layers} layers, limit "
            f"{FREE_RUNNING_X}x)")


def _free_running_codes(cfg, cache_k, cache_p, upto) -> str:
    """Compare the two paths' quantized pages after free running, slot by
    slot over positions ``0 .. upto[s] - 1`` (read through the slot's
    block table): every code within 1. Returns a report: the share of
    codes that differ and the scales' worst relative difference."""
    packed = cache_k.k.shape[-1] != cfg.head_dim
    page = cache_k.page_size
    n_diff, n_all, dmax, srel = 0, 0, 0, 0.0
    for s, n in enumerate(upto):
        pos = torch.arange(n, device=cache_k.k.device)
        pg = cache_k.block_tables[s].long()[pos // page]
        off = pos % page
        for a, b in ((cache_k.k, cache_p.k), (cache_k.v, cache_p.v)):
            d = (_codes(a[:, pg, :, off], packed)
                 - _codes(b[:, pg, :, off], packed)).abs()
            dmax = max(dmax, int(d.max()))
            n_diff += int((d > 0).sum())
            n_all += d.numel()
        for a, b in ((cache_k.k_scale, cache_p.k_scale),
                     (cache_k.v_scale, cache_p.v_scale)):
            x, y = a[:, pg, :, off], b[:, pg, :, off]
            if not torch.isfinite(x).all():
                raise AssertionError("scales are not finite")
            srel = max(srel, float(((x - y).abs()
                                    / y.abs().clamp_min(1e-30)).max()))
    if dmax > 1:
        raise AssertionError(f"step parity: free-running codes differ by "
                             f"{dmax} (> 1)")
    return (f"free-running codes: {n_diff} of {n_all} differ "
            f"({n_diff / n_all:.3e}), all within 1; scales max rel diff "
            f"{srel:.3e}")


def _recording_sampler(store: list):
    """``paged._sample_rows`` unchanged, but keeping a copy of every
    logits batch it samples from, in draw order."""
    real = paged._sample_rows

    def rec(logits, *args):
        store.append(logits.clone())
        return real(logits, *args)

    return rec


def _stream_parity(trace_k, trace_p, logits_k, logits_p, n_steps) -> dict:
    """Walk both paths' draws in order (a chunk's column j is its j-th
    draw). Every draw a slot makes from equal inputs on both paths (its
    tokens equal so far) compares the logits it sampled from. Returns the
    worst |logit diff|, the draws compared, the plain logits' mean row
    std, and for each slot whose tokens differ: the position that gave
    the first differing token and both paths' top-2 gaps there."""
    S = len(trace_k[0][1])
    worst, n_cmp, stds, div = 0.0, 0, [], {}
    for ci, ((tk, nk, _, _), (tp, _, lens, _)) in enumerate(
            zip(trace_k, trace_p)):
        for j in range(n_steps):
            a, b = logits_k[ci * n_steps + j], logits_p[ci * n_steps + j]
            for s in range(S):
                if s in div or j >= nk[s]:
                    continue
                if not torch.isfinite(a[s]).all():
                    raise AssertionError("step parity: logits not finite")
                worst = max(worst, float((a[s] - b[s]).abs().max()))
                stds.append(float(b[s].std()))
                n_cmp += 1
                ta, tb = tk[s][j], tp[s][j]
                if ta != tb:
                    div[s] = dict(
                        pos=lens[s] - nk[s] + j,
                        gap_plain=float(b[s, tb] - b[s, ta]),
                        gap_kernel=float(a[s, ta] - a[s, tb]),
                    )
    return dict(worst=worst, draws=n_cmp, std=statistics.fmean(stds),
                div=div)


def step_parity(kv_quant: str = "none") -> None:
    cfg = config_presets()["qwen3-0p6b"].with_(dtype=torch.float32)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    params = init_params(cfg, g, device=dev)
    S, C, page, max_len, n_steps = 8, 128, 16, 2048, 8
    base = PagedKVCache.init(cfg, S, page_size=page, max_len=max_len,
                             kv_quant=kv_quant, device=dev)
    n_pp = base.pages_per_slot
    rng = np.random.default_rng(7)
    perm = rng.permutation(np.arange(1, base.n_pages))[: S * n_pp]
    base.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    # existing context: seeded random KV under every slot's pages
    gk = torch.Generator(device=dev)
    gk.manual_seed(99)
    if base.quantized:
        _fill_quantized(base, kv_quant == "int4", gk)
    else:
        base.k.normal_(generator=gk)
        base.v.normal_(generator=gk)
    lengths = [100, 250, 37, 300, 511, 1000, 1500, 1900]
    base.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    prompts = {s: rng.integers(0, cfg.vocab_size, size=3 * C) for s in (0, 1)}
    V = cfg.vocab_size

    def run(kernel):
        cache = base.clone()
        counts = torch.zeros((S, V), dtype=torch.int32, device=dev)
        cur = [int(t) for t in rng_tok]
        lens = list(lengths)
        fed = {0: 0, 1: 0}
        trace, logits = [], []
        real = paged._sample_rows
        paged._sample_rows = _recording_sampler(logits)
        try:
            for chunk in range(3):
                cache, counts, lens = _chunk(chunk, kernel, cache, counts,
                                             cur, lens, fed, trace)
        finally:
            paged._sample_rows = real
        if len(logits) != 3 * n_steps:
            raise AssertionError(f"step parity: {len(logits)} draws")
        return trace, cache, counts, logits

    def _chunk(chunk, kernel, cache, counts, cur, lens, fed, trace):
        blk = np.zeros((S, C), np.int32)
        starts = np.array(lens, np.int32)
        nv = np.zeros(S, np.int32)
        emit = np.zeros(S, bool)
        for s in range(S):
            if s in fed and fed[s] < 2 * C:  # prefill at an offset
                blk[s] = prompts[s][fed[s]:fed[s] + C]
                nv[s] = C
                fed[s] += C
                emit[s] = fed[s] >= 2 * C
            else:
                blk[s, 0] = cur[s]
                nv[s] = 1
                emit[s] = True
        if chunk == 0:
            first_block[:] = [blk.copy(), starts.copy(), nv.copy()]
        up = [torch.tensor(a, device=dev) for a in (
            blk, starts, nv, np.zeros(S, np.int32), emit,
            np.arange(S, dtype=np.int32), np.zeros(S, np.int32),
            np.zeros(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, np.float32), np.zeros(S, np.float32),
            np.zeros(S, np.float32))]
        blk_t, st_t, nv_t, ns_t, em_t, sd_t, stp_t, tmp_t, tk_t, tp_t, \
            pr_t, fq_t = up
        rem = torch.full((S,), 64, dtype=torch.int32, device=dev)
        eos = torch.full((S, 8), -1, dtype=torch.int32, device=dev)
        toks, n_tok, _m, n_exec, cache, _d, _s, counts, _r = \
            paged_ragged_step(
                params, blk_t, cache, st_t, nv_t, ns_t, em_t, sd_t,
                stp_t, tmp_t, tk_t, tp_t, pr_t, fq_t, counts, rem, eos,
                cfg, n_steps, 1, kernel=kernel,
            )
        toks, n_tok = toks.cpu().numpy(), n_tok.cpu().numpy()
        lens = cache.lengths.cpu().tolist()
        for s in range(S):
            if n_tok[s]:
                cur[s] = int(toks[s, n_tok[s] - 1])
        trace.append((toks.tolist(), n_tok.tolist(), lens, int(n_exec)))
        return cache, counts, lens

    rng_tok = rng.integers(0, V, size=S)
    first_block: list = []
    t0 = time.monotonic()
    att.reset_counts()
    trace_k, cache_k, counts_k, logits_k = run(True)
    fmt = _fmt(kv_quant)
    for fn in (att.ragged_paged_attention, att.paged_attention):
        if fn.launches_by_format[fmt] != fn.launches or not fn.launches:
            raise AssertionError(f"step parity ({fmt}): kernel launches "
                                 f"{fn.launches_by_format}")
    trace_p, cache_p, counts_p, logits_p = run(False)
    blk0, starts0, nv0 = first_block
    # (a) free running: per-layer differences add up over 28 layers. Token
    # counts, lengths and n_exec never depend on token values here (no EOS,
    # budget 64), so they are equal in every format.
    if [t[1:] for t in trace_k] != [t[1:] for t in trace_p]:
        raise AssertionError(f"step parity ({fmt}): counts or lengths "
                             f"differ\nkernel {trace_k}\nplain  {trace_p}")
    par = _stream_parity(trace_k, trace_p, logits_k, logits_p, n_steps)
    div, limit = par["div"], FREE_RUNNING_LOGITS[fmt]
    free = (f"logits of {par['draws']} draws from equal inputs within "
            f"{par['worst']:.3e} (limit {limit:.1e}; plain logits' row std "
            f"{par['std']:.3f})")
    if par["worst"] > limit:
        raise AssertionError(f"step parity ({fmt}): {free}")
    # int4 only: one code a level off moves its value by amax/7, and the
    # random-weight model's greedy argmax may then flip, but only at a
    # near-tie: the plain path's top two logits within the limit
    if fmt != "int4" or any(d["gap_plain"] > limit for d in div.values()):
        if div:
            raise AssertionError(
                f"step parity ({fmt}): tokens differ in slots {div} "
                f"(limit {limit:.1e})\nkernel {trace_k}\nplain  {trace_p}")
    held = [s for s in range(S) if s not in div]
    if not all(torch.equal(counts_k[s], counts_p[s]) for s in held):
        raise AssertionError(f"step parity ({fmt}): counts differ")
    if div:
        free += f"; tokens equal in slots {held}, diverged at {div}"
    if fmt == "fp":
        free += "; " + _free_running_pages(cfg, cache_k, cache_p)
    else:
        # positions 0 .. p (p's own KV included) were written from equal
        # tokens on both paths
        upto = [div[s]["pos"] + 1 if s in div else trace_p[-1][2][s]
                for s in range(S)]
        free += "; " + _free_running_codes(cfg, cache_k, cache_p, upto)
    # (b) teacher forced: every layer from the same input, rtol = atol =
    # 2e-5 on its output (the first chunk's mixed block)
    first = (torch.tensor(blk0, device=dev), torch.tensor(starts0, device=dev),
             torch.tensor(nv0, device=dev))
    tf_ratio = _teacher_forced_layers(cfg, params, base, first)
    if tf_ratio > 1.0:
        raise AssertionError(
            f"step parity ({fmt}): a layer's output or pages differ beyond "
            f"rtol = atol = 2e-5 ({tf_ratio:.2f}x the bound)"
        )
    pages = "pages and scales byte-equal" if base.quantized else \
        "output and pages"
    log(f"step parity (qwen3-0p6b f32, {fmt} pages, 3 chunks, kernel vs "
        f"plain): {free}; "
        f"teacher-forced per layer {pages}, output {tf_ratio:.3f}x the 2e-5 "
        f"bound; {time.monotonic() - t0:.1f}s")
    del params, base, cache_k, cache_p
    torch.cuda.empty_cache()


# -- phase 5 -----------------------------------------------------------
def _requests(cfg):
    rng = np.random.default_rng(2024)
    V = cfg.vocab_size
    warm = rng.integers(0, V, 64).tolist()
    shared = rng.integers(0, V, 512).tolist()
    reqs = []
    for i in range(16):
        n = int(rng.integers(64, 1537))
        if i in (0, 5, 10, 15):  # four requests share a 512-token prefix
            ids = shared + rng.integers(0, V, max(n - 512, 64)).tolist()
        else:
            ids = rng.integers(0, V, n).tolist()
        knobs = {} if i % 2 == 0 else dict(temperature=0.8, top_k=50,
                                           top_p=0.95)
        reqs.append((ids, knobs))
    return warm, reqs


def serving_phase(kv_quant: str = "none", quant: str | None = None,
                  n_req: int = 16) -> dict:
    cfg = config_presets()["qwen3-0p6b"]  # bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5678)
    params = init_params(cfg, g, device=dev)
    eng = GenerationEngine(cfg, params, max_seq_len=4096, quant=quant,
                           device="cuda")
    del params
    b = ContinuousBatcher(engine=eng, max_slots=8, page_size=16,
                          chunk_steps=8, prefill_chunk=128,
                          prefix_cache=True, kv_quant=kv_quant, seed=0)
    cont = b.engine
    fmt = _fmt(kv_quant)
    V = cfg.vocab_size
    warm, all_reqs = _requests(cfg)
    # 8 requests: thread 0 runs request 0 and then 5, a sharer of its prefix
    pick = range(16) if n_req == 16 else (0, 1, 2, 3, 5, 6, 7, 9)
    reqs = [all_reqs[i] for i in pick]
    b.generate(warm, max_new_tokens=8)  # warm-up
    results, ttft = {}, {}
    errors = []
    chunks0, skipped0 = cont.chunks, cont.stats["prefill_tokens_skipped"]
    att.reset_counts()

    def worker(t):
        try:
            for i in range(t, n_req, 4):
                ids, knobs = reqs[i]
                t_sub = time.monotonic()
                first = []

                def cb(toks, first=first, t_sub=t_sub):
                    if not first:
                        first.append(time.monotonic() - t_sub)

                results[i] = b.generate(ids, max_new_tokens=64, stream_cb=cb,
                                        timeout=600, **knobs)
                ttft[i] = first[0]
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(results) != n_req:
        raise AssertionError("serving: not every request finished")
    chunks = cont.chunks - chunks0
    launches = {n: getattr(att, n).launches for n in REPLACES}
    by_format = {n: dict(getattr(att, n).launches_by_format)
                 for n in REPLACES}
    plain_calls = sum(getattr(att, n + "_ref").calls for n in REPLACES)
    for i, toks in results.items():
        if len(toks) != 64 or not all(0 <= t < V for t in toks):
            raise AssertionError(f"request {i}: bad output {len(toks)} tokens")
    L = cfg.n_layers
    # paged_prefill_attention has no engine caller: the run launches it 0
    # times, and its entry in the kernels line says so from this count
    want = {"ragged_paged_attention": L * chunks,
            "paged_attention": L * (8 - 1) * chunks,
            "paged_prefill_attention": 0}
    for name, n in want.items():
        if launches[name] != n or by_format[name][fmt] != n:
            raise AssertionError(f"{name}: launches {launches[name]} "
                                 f"{by_format[name]} vs {n} in {fmt} for "
                                 f"{chunks} chunks")
    if plain_calls:
        raise AssertionError(f"plain attention ran {plain_calls} times")
    skipped = cont.stats["prefill_tokens_skipped"] - skipped0
    if skipped <= 0:
        raise AssertionError("serving: the prefix cache was never hit")
    cont.check_page_conservation()
    # determinism on the card: a greedy request re-run alone
    solo = b.generate(reqs[0][0], max_new_tokens=64)
    if solo != results[0]:
        raise AssertionError("serving: a greedy re-run alone differs from "
                             "its co-batched stream")
    snap = b.stats()["engine"]
    kv_bytes_per_token = snap["kv_page_bytes"] // cont.cache.page_size
    if kv_bytes_per_token != KV_BYTES_PER_TOKEN[fmt]:
        raise AssertionError(f"serving: {kv_bytes_per_token} KV bytes per "
                             f"token, not {KV_BYTES_PER_TOKEN[fmt]}")
    b.close()  # closes the engine, which checks page conservation again
    tt = sorted(ttft.values())
    gen_tokens = sum(len(t) for t in results.values())
    res = dict(
        kv_quant=kv_quant, weight_quant=snap["weight_quant"],
        requests=n_req, wall_s=wall, tokens_per_s=gen_tokens / wall,
        ttft_p50_s=tt[len(tt) // 2], ttft_p95_s=tt[int(0.95 * (len(tt) - 1))],
        chunks=chunks, launches=launches, launches_by_format=by_format,
        prefill_tokens_skipped=skipped,
        prompt_tokens=sum(len(r[0]) for r in reqs),
        decode_steps=snap["decode_steps"],
        kv_bytes_per_token=kv_bytes_per_token,
        kv_page_bytes=snap["kv_page_bytes"],
    )
    log(f"serving (qwen3-0p6b bf16, {fmt} pages, weights "
        f"{quant or 'bf16'}, 8 slots, {n_req} requests x 64 tokens): "
        f"{json.dumps(res)}")
    del eng, b, cont
    torch.cuda.empty_cache()
    return res


# -- phase 6 -----------------------------------------------------------
@contextlib.contextmanager
def _plain_flash():
    """The dense engine's flash calls take the plain version while inside
    (the parity phase's reference path; the engine reads the wrapper from
    ``ops.attention`` at each forward)."""
    real = att.flash_attention

    def plain(q, k, v, *, scale, window=None, **_blocks):
        return att.flash_attention_ref(q, k, v, scale=scale, window=window)

    att.flash_attention = plain
    try:
        yield
    finally:
        att.flash_attention = real


def _dense_teacher_forced(eng, toks, mask) -> float:
    """Each layer of a fresh-cache flash prefill run twice from the SAME
    input, through the kernel and through the plain version (the plain
    path's output feeds the next layer): returns the worst |diff| / (2e-5
    + 2e-5 |plain|) over the layers' outputs (<= 1 passes)."""
    cfg, params, dev = eng.cfg, eng.params, eng.device
    B, T = toks.shape
    cache = eng.new_cache(B)
    tok_t = torch.tensor(toks, device=dev).long()
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    cos, sin = ttr.rope_tables(pos, ttr._rope_dim(cfg), cfg.rope_theta)
    x = ttr._embed_tokens(params, tok_t, cfg)
    worst = 0.0
    for i, lp in enumerate(ttr._layers(params)):
        outs = []
        for fn in (att.flash_attention, att.flash_attention_ref):
            def attn(q, k, v, _bias, scale, fn=fn):
                return fn(q, k, v, scale=scale, window=cfg.sliding_window)

            kv = tuple(t.clone() for t in cache.layer_kv(i))
            outs.append(ttr._block(x, lp, cfg, cos, sin, None, kv,
                                   cache.length, attn, T))
        yk, yp = outs
        worst = max(worst, float(((yk - yp).abs()
                                  / (2e-5 + 2e-5 * yp.abs())).max()))
        x = yp
    return worst


def dense_parity() -> dict:
    """qwen3-0p6b at full width in float32 with flash_attention on: one
    prefill of two prompts (300 and 512 tokens, bucket 512) through the
    kernel and through the plain version — each layer from the same input
    within rtol = atol = 2e-5, the last-token logits within
    DENSE_LOGITS — and greedy generate_compiled, generate_beam and
    generate_lookahead token-equal on both paths (lookahead also equal to
    generate_compiled)."""
    cfg = config_presets()["qwen3-0p6b"].with_(dtype=torch.float32,
                                                flash_attention=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    params = init_params(cfg, g, device=dev)
    eng = GenerationEngine(cfg, params, max_seq_len=1024,
                           seq_buckets=(128, 256, 512), device="cuda")
    del params
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300,
                                                                      512)]
    toks = np.zeros((2, 512), np.int32)
    mask = np.zeros((2, 512), bool)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], mask[i, :len(p)] = p, True
    t0 = time.monotonic()
    att.reset_counts()
    tf_ratio = _dense_teacher_forced(eng, toks, mask)
    if tf_ratio > 1.0:
        raise AssertionError(f"dense parity: a layer's output differs beyond "
                             f"rtol = atol = 2e-5 ({tf_ratio:.2f}x the bound)")
    rep = (prompts[0][:40] * 5)[:200]  # repetitive: lookahead drafts hit

    def run():
        eng.flash_prefills = 0
        logits, _c, lens, _b = eng.prefill(prompts)
        out = dict(
            logits=logits[:len(lens)].float(),
            greedy=eng.generate_compiled(prompts, max_new_tokens=16).sequences,
            beam=eng.generate_beam([prompts[0]], num_beams=4,
                                   max_new_tokens=8).sequences,
            look=eng.generate_lookahead([rep], max_new_tokens=24).sequences,
            look_ref=eng.generate_compiled([rep],
                                           max_new_tokens=24).sequences,
            flash_prefills=eng.flash_prefills,
        )
        torch.cuda.synchronize()
        return out

    att.reset_counts()
    k = run()
    launches = att.flash_attention.launches
    with _plain_flash():
        p = run()
    if launches != cfg.n_layers * k["flash_prefills"] or not launches:
        raise AssertionError(f"dense parity: {launches} flash launches for "
                             f"{k['flash_prefills']} flash prefills")
    if not torch.isfinite(k["logits"]).all():
        raise AssertionError("dense parity: prefill logits not finite")
    dl = float((k["logits"] - p["logits"]).abs().max())
    if dl > DENSE_LOGITS:
        raise AssertionError(f"dense parity: last-token logits differ by "
                             f"{dl:.3e} (> {DENSE_LOGITS:.1e})")
    for name in ("greedy", "beam", "look"):
        if k[name] != p[name]:
            raise AssertionError(f"dense parity: {name} tokens differ\n"
                                 f"kernel {k[name]}\nplain  {p[name]}")
    if k["look"] != k["look_ref"]:
        raise AssertionError("dense parity: lookahead differs from "
                             "generate_compiled")
    res = dict(layer_ratio=tf_ratio, logits_max_abs_diff=dl,
               logits_std=float(p["logits"].std()),
               flash_launches=launches, flash_prefills=k["flash_prefills"],
               greedy_tokens=sum(len(s) for s in k["greedy"]))
    log(f"dense parity (qwen3-0p6b f32, flash kernel vs plain, prompts 300 + "
        f"512 in bucket 512): teacher-forced per layer {tf_ratio:.3f}x the "
        f"2e-5 bound; last-token logits max abs diff {dl:.3e} (limit "
        f"{DENSE_LOGITS:.1e}, plain logits std {res['logits_std']:.3f}); "
        f"greedy generate_compiled, beam 4 and lookahead token-equal; "
        f"{time.monotonic() - t0:.1f}s")
    del eng
    torch.cuda.empty_cache()
    return res


def _attn_ratio(got, want, tol) -> float:
    """The worst output row's max |got - want| over tol times that row's
    max |want| (<= 1 passes; a row of plain zeros must be zeros)."""
    d = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    return float((d / (tol * ref.clamp_min(1e-30))).max())


def _held(real, plain, fault, readings: list):
    """``real`` (a kernel wrapper) wrapped so that every call is also
    computed by ``plain`` and by ``fault`` on the same inputs, appending
    ``(the kernel's _attn_ratio, the fault's)`` to ``readings``."""

    def held(*a, **kw):
        out = real(*a, **kw)
        want = plain(*a, **kw)
        readings.append((_attn_ratio(out, want, BF16_ATTN_TOL),
                         _attn_ratio(fault(*a, **kw), want, BF16_ATTN_TOL)))
        return out

    return held


def _ragged_plain(q, kp, vp, bt, starts, nv, **kw):
    return att.ragged_paged_attention_ref(q, kp, vp, bt, starts, nv, **kw)


def _ragged_fault(q, kp, vp, bt, starts, nv, **kw):
    """The plain version with each row's own key masked: every row sits
    one position earlier."""
    return att.ragged_paged_attention_ref(q, kp, vp, bt, starts - 1, nv, **kw)


def _decode_plain(q, kp, vp, bt, lengths, **kw):
    return att.paged_attention_ref(q, kp, vp, bt, lengths, **kw)


def _decode_fault(q, kp, vp, bt, lengths, **kw):
    """The plain version with each row's own key masked: every slot one
    position shorter."""
    return att.paged_attention_ref(q, kp, vp, bt, lengths - 1, **kw)


def _decode_head_fault(q, kp, vp, bt, lengths, **kw):
    """The plain version with every query head group over the next kv
    head (a wrong GQA mapping)."""
    kw = {k: v.roll(-1, 1) for k, v in kw.items() if torch.is_tensor(v)} \
        | {k: v for k, v in kw.items() if not torch.is_tensor(v)}
    return att.paged_attention_ref(q, kp.roll(-1, 1), vp.roll(-1, 1), bt,
                                   lengths, **kw)


def _flash_plain(q, k, v, *, scale, window=None, **_blocks):
    return att.flash_attention_ref(q, k, v, scale=scale, window=window)


def _flash_fault(q, k, v, *, scale, window=None, **_blocks):
    """The plain version with each row's own key masked: row t over keys
    before t (row 0 sees none and gives zeros)."""
    rest = att.flash_attention_ref(q[:, 1:], k[:, :-1], v[:, :-1],
                                   scale=scale, window=window)
    return torch.cat([torch.zeros_like(q[:, :1]), rest], dim=1)


def bf16_parity() -> dict:
    """qwen3-0p6b at full width in bfloat16, where the tensor-core bodies
    run on the model's own (qk-normed) activations: (a) one ragged chunk's
    layers over MAIN's mixed block (2 prefills, 5 decodes, an idle slot)
    with fp pages of seeded random context, then one paged_decode_step of
    every slot after it (paged_attention's decode tiles), and (b) one
    flash prefill of the dense engine over two prompts (300 and 512
    tokens, bucket 512).
    Each layer's attention output, the kernel's against the plain
    version's on the same inputs, is held per row to BF16_ATTN_TOL; the
    planted fault (each row's own key masked) must read above it at every
    layer."""
    cfg = config_presets()["qwen3-0p6b"]  # bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    params = init_params(cfg, g, device=dev)
    S, C, page = MAIN["S"], MAIN["C"], MAIN["page"]
    cache = PagedKVCache.init(cfg, S, page_size=page,
                              max_len=MAIN["n_pp"] * page, device=dev)
    n_pp = cache.pages_per_slot
    rng = np.random.default_rng(8)
    perm = rng.permutation(np.arange(1, cache.n_pages))[: S * n_pp]
    cache.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    gk = torch.Generator(device=dev)
    gk.manual_seed(97)
    cache.k.normal_(generator=gk)
    cache.v.normal_(generator=gk)
    blk = torch.tensor(rng.integers(0, cfg.vocab_size, size=(S, C)),
                       dtype=torch.int32, device=dev)
    starts, nv = (torch.tensor(a, dtype=torch.int32, device=dev)
                  for a in (MAIN_STARTS, MAIN_NVALID))
    t0 = time.monotonic()
    att.reset_counts()
    paged_r: list = []
    real = paged.ragged_paged_attention  # what _ragged_block launches
    paged.ragged_paged_attention = _held(real, _ragged_plain, _ragged_fault,
                                         paged_r)
    try:
        bt = cache.block_tables
        write_pg, write_off, pos, _ = paged._ragged_write_indices(
            bt, starts, nv, page, n_pp, C)
        x = paged._embed_tokens(params, blk.long(), cfg)
        cos, sin = paged.rope_tables(pos, paged._rope_dim(cfg),
                                     cfg.rope_theta)
        for i, lp in enumerate(paged._layers(params)):
            x, _ = paged._ragged_block(x, lp, cfg, cos, sin,
                                       cache.layer_kv(i), write_pg,
                                       write_off, bt, starts, nv, True)
    finally:
        paged.ragged_paged_attention = real
    launches = att.ragged_paged_attention.launches_by_format["fp"]
    if launches != cfg.n_layers or len(paged_r) != cfg.n_layers:
        raise AssertionError(f"bf16 parity: {launches} ragged launches for "
                             f"{cfg.n_layers} layers")
    # one decode step of every slot after the chunk (the idle slot stays
    # idle), each layer's paged_attention held the same way
    lens = [st + n for st, n in zip(MAIN_STARTS, MAIN_NVALID)]
    cache.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=S),
                       dtype=torch.int32, device=dev)
    decode_r: list = []
    real_dec = paged.paged_attention  # what _paged_block launches
    paged.paged_attention = _held(real_dec, _decode_plain, _decode_fault,
                                  decode_r)
    try:
        logits, _ = paged.paged_decode_step(
            params, tok, cache, cache.lengths > 0, cfg, kernel=True)
    finally:
        paged.paged_attention = real_dec
    launches = att.paged_attention.launches_by_format["fp"]
    if launches != cfg.n_layers or len(decode_r) != cfg.n_layers:
        raise AssertionError(f"bf16 parity: {launches} paged_attention "
                             f"launches for {cfg.n_layers} layers")
    if not torch.isfinite(logits).all():
        raise AssertionError("bf16 parity: decode step logits not finite")
    del cache
    eng = GenerationEngine(cfg.with_(flash_attention=True), params,
                           max_seq_len=1024, seq_buckets=(128, 256, 512),
                           device="cuda")
    del params
    toks = np.zeros((2, 512), np.int32)
    for i, n in enumerate((300, 512)):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    att.reset_counts()
    dense_r: list = []
    flash = _held(att.flash_attention, _flash_plain, _flash_fault, dense_r)
    dcache = eng.new_cache(2)
    tok_t = torch.tensor(toks, device=dev).long()
    pos = torch.arange(512, device=dev)[None].expand(2, 512)
    cos, sin = ttr.rope_tables(pos, ttr._rope_dim(cfg), cfg.rope_theta)
    x = ttr._embed_tokens(eng.params, tok_t, cfg)

    def attn(q, k, v, _bias, scale):
        return flash(q, k, v, scale=scale, window=cfg.sliding_window)

    for i, lp in enumerate(ttr._layers(eng.params)):
        x = ttr._block(x, lp, cfg, cos, sin, None, dcache.layer_kv(i),
                       dcache.length, attn, 512)
    if att.flash_attention.launches != cfg.n_layers \
            or len(dense_r) != cfg.n_layers:
        raise AssertionError(f"bf16 parity: {att.flash_attention.launches} "
                             f"flash launches for {cfg.n_layers} layers")
    res = {}
    for key, r in (("ragged", paged_r), ("decode", decode_r),
                   ("flash", dense_r)):
        res[key] = max(k for k, _ in r)
        res[f"{key}_fault"] = min(f for _, f in r)
    log(f"bf16 parity (qwen3-0p6b bf16, each layer's attention output, "
        f"kernel vs plain on the same inputs, per row max |diff| within "
        f"{BF16_ATTN_TOL} x the row's max |plain|): ragged chunk over "
        f"MAIN's block {res['ragged']:.3f}x the bound (own-key fault, least "
        f"over layers: {res['ragged_fault']:.3f}x), the decode step after "
        f"it {res['decode']:.3f}x (fault {res['decode_fault']:.3f}x), flash "
        f"prefill {res['flash']:.3f}x (fault {res['flash_fault']:.3f}x); "
        f"{time.monotonic() - t0:.1f}s")
    if max(res["ragged"], res["decode"], res["flash"]) > 1.0:
        raise AssertionError(f"bf16 parity: an attention output differs "
                             f"beyond the bound: {res}")
    if min(res["ragged_fault"], res["decode_fault"],
           res["flash_fault"]) <= 1.0:
        raise AssertionError(f"bf16 parity: the planted fault passes the "
                             f"check, which then proves nothing: {res}")
    del eng
    torch.cuda.empty_cache()
    return res


# -- phase 7 -----------------------------------------------------------
def _sync_s(fn):
    """Run ``fn`` and return ``(its result, wall seconds to the device's
    end)``."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def dense_serving() -> dict:
    """qwen3-0p6b at full width in bfloat16 with flash_attention on,
    through GenerationEngine: generate_compiled and generate_chunked on 8
    of _requests' prompts (greedy and sampled) x DENSE_NEW tokens, equal
    to each other; a 3000-token prompt (chunked prefill, flash on its
    first chunk); generate_beam and generate_lookahead; and generate_compiled
    on an int8 weights + int8 dense cache engine. The kernel's launches
    must equal n_layers x the flash prefills the engines counted, and no
    plain attention runs."""
    cfg = config_presets()["qwen3-0p6b"].with_(flash_attention=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(8765)
    params = init_params(cfg, g, device=dev)
    kw = dict(max_seq_len=4096, seq_buckets=DENSE_SEQ_BUCKETS,
              batch_buckets=(1, 2, 4, 8), device="cuda")
    eng = GenerationEngine(cfg, params, **kw)
    eng8 = GenerationEngine(cfg, params, quant="int8+kv", **kw)
    del params
    V = cfg.vocab_size
    _warm, reqs = _requests(cfg)
    reqs = reqs[:8]
    prompts = [r[0] for r in reqs]
    sp = SamplingParams.stack([SamplingParams.make(**r[1]) for r in reqs],
                              pad_to=8)
    rng = np.random.default_rng(77)
    long = rng.integers(0, V, 3000).tolist()
    rep = (prompts[1][:48] * 6)[:256]
    eng.generate_compiled([prompts[0][:64]], max_new_tokens=4)  # warm-up
    eng8.generate_compiled([prompts[0][:64]], max_new_tokens=4)
    att.reset_counts()
    eng.flash_prefills = eng8.flash_prefills = 0
    new = DENSE_NEW
    comp, t_comp = _sync_s(lambda: eng.generate_compiled(
        prompts, max_new_tokens=new, sampling=sp, seed=3))
    first = []
    t_sub = time.monotonic()

    def cb(_toks):
        if not first:
            first.append(time.monotonic() - t_sub)

    chunked, t_chunk = _sync_s(lambda: eng.generate_chunked(
        prompts, max_new_tokens=new, sampling=sp, seed=3, chunk_steps=8,
        stream_cb=cb))
    n_flash_8 = eng.flash_prefills
    one, t_long = _sync_s(lambda: eng.generate_compiled(
        [long], max_new_tokens=16))
    n_flash_long = eng.flash_prefills - n_flash_8
    beam, t_beam = _sync_s(lambda: eng.generate_beam(
        [prompts[2]], num_beams=4, max_new_tokens=16))
    look, t_look = _sync_s(lambda: eng.generate_lookahead(
        [rep], max_new_tokens=32))
    q8, t_q8 = _sync_s(lambda: eng8.generate_compiled(
        prompts, max_new_tokens=new, sampling=sp, seed=3))
    launches = att.flash_attention.launches
    plain = {f.__name__: f.calls for f in att._REFS if f.calls}
    n_prefills = eng.flash_prefills + eng8.flash_prefills
    L = cfg.n_layers
    if launches != L * n_prefills or not launches:
        raise AssertionError(f"dense serving: {launches} flash launches for "
                             f"{n_prefills} flash prefills x {L} layers")
    if plain:
        raise AssertionError(f"dense serving: plain attention ran {plain}")
    if n_flash_8 != 2 or n_flash_long != 1:
        raise AssertionError(f"dense serving: flash prefills {n_flash_8} "
                             f"(8 prompts, twice) and {n_flash_long} (the "
                             "3000-token prompt, first chunk only)")
    if chunked.sequences != comp.sequences:
        raise AssertionError("dense serving: generate_chunked differs from "
                             "generate_compiled")
    for name, r, n in (("compiled", comp, new), ("int8+kv", q8, new),
                       ("long", one, 16), ("beam", beam, 16),
                       ("lookahead", look, 32)):
        for s in r.sequences:
            if len(s) != n or not all(0 <= t < V for t in s):
                raise AssertionError(f"dense serving {name}: bad output "
                                     f"{len(s)} tokens")
    gen = sum(len(s) for s in comp.sequences)
    res = dict(
        requests=len(prompts), prompt_tokens=sum(len(p) for p in prompts),
        new_tokens=new, compiled_s=t_comp, compiled_tokens_per_s=gen / t_comp,
        chunked_s=t_chunk, chunked_ttft_s=first[0],
        long_prompt_s=t_long, beam_s=t_beam, lookahead_s=t_look,
        lookahead=eng.last_lookahead_stats, int8_kv_s=t_q8,
        int8_kv_tokens_per_s=gen / t_q8,
        flash_prefills=n_prefills, launches=launches,
    )
    log(f"dense serving (qwen3-0p6b bf16, flash on, GenerationEngine): "
        f"{json.dumps(res)}")
    del eng, eng8
    torch.cuda.empty_cache()
    return res


# -- phase 8: the rest of the single-card engine -------------------------
# speculative decoding, live migration with drain and handoff, the
# host-RAM prefix tier and the fleet pull, co-hosting on a shared page
# pool, and live weight publish — all qwen3-0p6b in bf16 at full width,
# through the CUDA kernels
NEW_PATHS = ("ragged_paged_attention", "paged_attention")
# spec == plain on the card: a greedy stream may part only where the plain
# run's top-two logit gap is within this (bf16 logits; H100 readings: the
# streams that part do so at gaps of 0 and 0.015625, and the top logits
# of draws made from equal tokens differ by at most 0.03125)
SPEC_TIE = 0.0625
GEMM_ROWS_M = (8, 72, 1024)  # decode slots, 8 verify slots of 9, a block
_MODEL: dict = {}


def gemm_rows(device: str = "cuda") -> dict:
    """Whether a row's bits depend on the GEMM's height: the same rows
    through ``models/quant.py::matmul`` at M = 8 and 72 against the same
    rows inside M = 1024 (qwen3-0p6b's q, kv, MLP and output widths), and
    through one whole layer's non-attention work (norm, q/k/v projections
    with qk-norm and rope, output projection, MLP) as a [8, 1] decode
    batch against the same rows of an [8, 128] block. bf16 and f32 (TF32
    off); weights random from a seed. Returns and prints, per case, rows
    bitwise equal or the max |diff|. Runs on the card or, with
    ``device="cpu"``, on the host (python -c "import chip_smoke as c;
    c.gemm_rows('cpu')")."""
    from tensorlink_tpu_torch.models.quant import matmul

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    out: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        cfg = config_presets()["qwen3-0p6b"].with_(
            n_layers=1, vocab_size=1024, dtype=dtype)
        g = torch.Generator(device=dev)
        g.manual_seed(31)
        params = init_params(cfg, g, device=dev)
        lp = ttr._layers(params)[0]
        d = cfg.d_model
        for name, w in (("wq", lp["attn"]["wq"]), ("wk", lp["attn"]["wk"]),
                        ("w_up", lp["mlp"]["w_up"]),
                        ("w_down", lp["mlp"]["w_down"])):
            x = torch.randn((1024, w.shape[0]), generator=g, device=dev)
            x = x.to(dtype)
            full = matmul(x, w)
            for m in GEMM_ROWS_M[:-1]:
                part = matmul(x[:m], w)
                diff = (part.float() - full[:m].float()).abs().max().item()
                out[f"{dt} matmul {name} M={m} vs 1024"] = (
                    "bitwise" if torch.equal(part, full[:m]) else diff)
        S, C = 8, 128
        x = torch.randn((S, C, d), generator=g, device=dev).to(dtype)
        pos = torch.arange(C, device=dev)[None, :].expand(S, C) + 300
        cols = torch.arange(S, device=dev) * 13 % C
        rows = torch.arange(S, device=dev)

        def layer(xb, pb):
            cos, sin = ttr.rope_tables(pb, ttr._rope_dim(cfg),
                                       cfg.rope_theta)
            h = ttr._norm(xb, lp["ln1"], cfg)
            q, k, v = ttr._qkv(h, lp, cfg, cos, sin)
            return k, v, ttr._residual(xb, q, lp, cfg)

        blk = layer(x, pos)
        dec = layer(x[rows, cols][:, None].contiguous(),
                    pos[rows, cols][:, None].contiguous())
        for name, a, b in zip(("k", "v", "out"), dec, blk):
            a, b = a[:, 0], b[rows, cols]
            out[f"{dt} layer {name} [8,1] vs [8,128]"] = (
                "bitwise" if torch.equal(a, b)
                else (a.float() - b.float()).abs().max().item())
    log(f"gemm rows ({device}): {json.dumps(out)}")
    return out


def _model():
    """qwen3-0p6b in bf16 at full width, random weights from a seed (one
    copy for every engine of phase 8)."""
    if not _MODEL:
        cfg = config_presets()["qwen3-0p6b"]
        g = torch.Generator(device="cuda")
        g.manual_seed(4321)
        _MODEL.update(cfg=cfg, params=init_params(cfg, g, device="cuda"))
    return _MODEL["cfg"], _MODEL["params"]


def _gen(max_seq_len=4096, quant=None):
    cfg, params = _model()
    return GenerationEngine(cfg, params, max_seq_len=max_seq_len,
                            quant=quant, device="cuda")


def _cont(gen, **kw):
    from tensorlink_tpu_torch.engine.continuous import ContinuousEngine

    for k, v in dict(max_slots=8, page_size=16, chunk_steps=8,
                     prefill_chunk=128).items():
        kw.setdefault(k, v)
    return ContinuousEngine(gen, **kw)


class _Launches:
    """The kernel counts of one phase: reset on entry; on :meth:`check`,
    every engine of the phase took the CUDA kernels (one ragged launch a
    layer per chunk, chunk_steps - 1 decode launches a layer per chunk),
    in the expected page formats, and no plain version ran."""

    def __init__(self, label: str):
        self.label = label
        self.engines: list = []
        att.reset_counts()

    def add(self, ce):
        if not ce.use_kernel:
            raise AssertionError(f"{self.label}: an engine off the kernels")
        ce._chunks0 = ce.chunks
        self.engines.append(ce)
        return ce

    def check(self) -> dict:
        depths = {e.cfg.n_layers for e in self.engines}
        if len(depths) != 1:
            raise AssertionError(f"{self.label}: engines of depths {depths}")
        L = depths.pop()
        chunks = sum(e.chunks - e._chunks0 for e in self.engines)
        steps = {e.chunk_steps for e in self.engines}
        if chunks == 0 or len(steps) != 1:
            raise AssertionError(f"{self.label}: {chunks} chunks")
        want = {"ragged_paged_attention": L * chunks,
                "paged_attention": L * (steps.pop() - 1) * chunks}
        got = {n: getattr(att, n).launches for n in NEW_PATHS}
        plain = {f.__name__: f.calls for f in att._REFS if f.calls}
        if got != want or plain:
            raise AssertionError(f"{self.label}: launches {got} vs {want}, "
                                 f"plain versions {plain}")
        fmts = {n: {f: c for f, c in getattr(att, n).launches_by_format
                    .items() if c} for n in NEW_PATHS}
        return dict(chunks=chunks, launches=got, by_format=fmts)


def _equal_stream(label, got, want) -> bool:
    """A path that computes every row at the same GEMM heights as its
    reference must give the reference's greedy stream exactly."""
    if list(got) != list(want):
        i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        raise AssertionError(f"{label}: the stream parts at token {i}")
    return True


def _spec_prompts(cfg):
    """8 repetitive prompts (two-token and five-token cycles, and a
    "code-like" block repeated) and 8 of _requests' prompts with their
    knobs (half greedy, half sampled)."""
    rng = np.random.default_rng(99)
    V = cfg.vocab_size
    reps = []
    for i in range(8):
        unit = rng.integers(0, V, (2, 5, 24, 3)[i % 4]).tolist()
        reps.append(((unit * (600 // len(unit)))[: 200 + 50 * i], {}))
    _warm, reqs = _requests(cfg)
    return reps + [reqs[i] for i in range(8)]


def _draw_recorder(store: list):
    """Wrappers for ``paged._row_keys``/``paged._sample_rows`` that keep,
    per draw, each row's (seed, step) and its logits' top two values and
    ids — on the card, read once after the run."""
    real_keys, real_sample = paged._row_keys, paged._sample_rows
    cur = {}

    def keys(seeds, steps):
        cur["ids"] = (seeds, steps)
        return real_keys(seeds, steps)

    def sample(logits, *a):
        v, i = torch.topk(logits.float(), 2, dim=-1)
        store.append((*cur["ids"], v, i))
        return real_sample(logits, *a)

    return keys, sample


def _draws(store) -> dict:
    """(seed, step) → (top-two values, ids) of the draw made there: the
    LAST row recorded under that key (a row the verify walk stopped, or a
    finished slot's frozen row, is recorded earlier or under a step no
    draw uses)."""
    out = {}
    for seeds, steps, v, i in store:
        seeds, steps = seeds.tolist(), steps.tolist()
        v, i = v.tolist(), i.tolist()
        for r in range(len(seeds)):
            out[(seeds[r], steps[r])] = (v[r], i[r])
    return out


def _top_is(v, ids, tok) -> bool:
    """``tok`` is a greedy draw of these top two (ties both count)."""
    return ids[0] == tok or (ids[1] == tok and v[1] == v[0])


def spec_serving(kv_quant: str) -> dict:
    """Speculative decoding at full width: 16 requests x 64 tokens (8
    repetitive, 8 of _requests'), all opted in, on 8 slots with
    spec_draft 8, then the same requests with spec off, each draw's top
    two logits recorded. Greedy streams equal, or parted only where the
    plain run's top-two gap is within SPEC_TIE (logged with the largest
    |spec - plain| top logit over the draws made from equal tokens);
    spec_drafted > 0, more than one token per verify pass, and ragged
    launches whose verify slots carry 8 drafts (9 positions, 18 rows at
    G = 2)."""
    cfg, _ = _model()
    gen = _gen()
    prompts = _spec_prompts(cfg)
    runs = {}
    for spec in (True, False):
        ce = _cont(gen, kv_quant=kv_quant, spec_decode=spec, spec_draft=8)
        lc = _Launches(f"spec serving {kv_quant} spec={spec}")
        lc.add(ce)
        widest = [0]
        real = ce._pack_drafts

        def pack(blk, n_valid, remaining, real=real, widest=widest):
            n_spec = real(blk, n_valid, remaining)
            widest[0] = max(widest[0], int(n_spec.max()))
            return n_spec

        ce._pack_drafts = pack
        store: list = []
        real_fns = paged._row_keys, paged._sample_rows
        paged._row_keys, paged._sample_rows = _draw_recorder(store)
        try:
            reqs = [ce.submit(ids, max_new_tokens=64, seed=100 + i,
                              sampling=SamplingParams.make(**knobs),
                              speculative=True)
                    for i, (ids, knobs) in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            ce.run_until_idle()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            paged._row_keys, paged._sample_rows = real_fns
        if not all(r.finished and len(r.tokens) == 64 for r in reqs):
            raise AssertionError(f"spec serving {kv_quant}: a request "
                                 "did not finish")
        ce.check_page_conservation()
        snap = ce.serving_snapshot()
        runs[spec] = dict(
            streams=[list(r.tokens) for r in reqs], wall_s=wall,
            tokens_per_s=64 * len(reqs) / wall, widest=widest[0],
            launches=lc.check(), snap=snap, draws=_draws(store),
        )
        ce.close()
        del ce
    on, off = runs[True], runs[False]
    if not on["snap"]["spec_drafted"] > 0:
        raise AssertionError("spec serving: nothing was drafted")
    if not on["snap"]["spec_tokens_per_pass"] > 1:
        raise AssertionError("spec serving: tokens per pass "
                             f"{on['snap']['spec_tokens_per_pass']}")
    if on["widest"] != 8:
        raise AssertionError(f"spec serving: widest verify slot "
                             f"{on['widest']} drafts, not 8")
    parted, sampled, noise, n_cmp = [], [], 0.0, 0
    for i, ((ids, knobs), a, b) in enumerate(zip(prompts, on["streams"],
                                                 off["streams"])):
        if knobs:
            sampled.append(a == b)
            continue
        at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                  len(b))
        for n in range(at + (at < len(b))):
            (vs, ids_s), (vp, ids_p) = (on["draws"][(100 + i, n)],
                                        off["draws"][(100 + i, n)])
            if not (_top_is(vp, ids_p, b[n]) and _top_is(vs, ids_s, a[n])):
                raise AssertionError(f"spec serving: draw {n} of request "
                                     f"{i} not recorded")
            if n < at:
                noise = max(noise, abs(vs[0] - vp[0]))
                n_cmp += 1
        if at < len(b):
            gap = vp[0] - vp[1]
            parted.append(dict(request=i, at=at, gap=gap))
            log(f"spec serving {kv_quant} request {i}: parts at token {at} "
                f"of 64, plain top-two gap {gap:.6g}")
    worst = max((p["gap"] for p in parted), default=0.0)
    res = dict(
        kv_quant=kv_quant, requests=len(prompts),
        tokens_per_s_spec_on=on["tokens_per_s"],
        tokens_per_s_spec_off=off["tokens_per_s"],
        wall_s_spec_on=on["wall_s"], wall_s_spec_off=off["wall_s"],
        spec_drafted=on["snap"]["spec_drafted"],
        spec_accepted=on["snap"]["spec_accepted"],
        spec_verify_passes=on["snap"]["spec_verify_passes"],
        spec_killed=on["snap"]["spec_killed"],
        spec_tokens_per_pass=on["snap"]["spec_tokens_per_pass"],
        widest_verify_drafts=on["widest"],
        greedy_parted=parted,
        greedy_equal=f"{16 - len(sampled) - len(parted)} of "
                     f"{16 - len(sampled)}",
        top_logit_diff_at_equal_draws=noise, equal_draws=n_cmp,
        sampled_equal=f"{sum(sampled)} of {len(sampled)}",
        launches_on=on["launches"], launches_off=off["launches"],
    )
    log(f"spec serving (qwen3-0p6b bf16, {_fmt(kv_quant)} pages, 8 slots, "
        f"spec_draft 8; readings, not a claim): {json.dumps(res)}")
    if worst > SPEC_TIE:
        raise AssertionError(f"spec serving {kv_quant}: a greedy stream "
                             f"parts at a plain top-two gap {worst} > "
                             f"{SPEC_TIE}")
    del gen
    torch.cuda.empty_cache()
    return res

def _ship(src, dst, req, mig_id):
    """Freeze ``req``'s slot on ``src``, export through the TLTS frame,
    stage on ``dst``, commit, and resubmit with the ticket."""
    from tensorlink_tpu_torch.core import serialization as ser

    slot = req.slot
    src.freeze_slot(slot)
    src.check_page_conservation()
    chain, limit = src.migration_chain(slot)
    blob = src.export_slot(slot, n_skip=dst.resident_prefix_pages(chain,
                                                                  limit))
    blob = ser.decode(ser.encode(blob), copy=True)
    if not dst.stage_migration(mig_id, blob):
        raise AssertionError(f"migration {mig_id}: staging refused")
    moved = src.commit_migration(slot)
    return dst.submit(
        moved.prompt + moved.tokens,
        max_new_tokens=moved.budget - len(moved.tokens),
        sampling=moved.sampling, seed=moved.seed,
        start_step=moved.start_step + len(moved.tokens), adopt=mig_id,
    ), moved, int(blob["k"].shape[0])


def migration_phase() -> dict:
    """Two ContinuousEngines on the card, for fp, int8 and int4 pages: a
    greedy stream frozen mid-decode (with a neighbour decoding on each
    engine), exported, staged and adopted, equal to its uninterrupted
    run; pages in transit 0 and conservation on both; an int4 → int8
    staging refused. Then one prefill→decode handoff and a drain that
    sheds the queue onto the other engine. Streams are held equal token
    for token: every row runs at its reference's GEMM heights."""
    cfg, _ = _model()
    gen = _gen()
    rng = np.random.default_rng(55)
    prompt = rng.integers(0, cfg.vocab_size, 700).tolist()
    res: dict = {}
    exported: dict = {}
    for kv_quant in ("none", "int8", "int4"):
        lc = _Launches(f"migration {kv_quant}")
        ref = lc.add(_cont(gen, kv_quant=kv_quant))
        want = ref.submit(prompt, max_new_tokens=48, seed=3)
        ref.run_until_idle()
        src = lc.add(_cont(gen, kv_quant=kv_quant))
        dst = lc.add(_cont(gen, kv_quant=kv_quant))
        src.submit(prompt[:300], max_new_tokens=64, seed=4)
        dst.submit(prompt[100:500], max_new_tokens=64, seed=5)
        r = src.submit(prompt, max_new_tokens=48, seed=3)
        while len(r.tokens) < 20:
            src.step_chunk()
        dst.step_chunk()
        r2, moved, n_pages = _ship(src, dst, r, f"m-{kv_quant}")
        src.run_until_idle()
        dst.run_until_idle()
        got = moved.tokens + r2.tokens
        same = _equal_stream(f"migration {kv_quant}", got, want.tokens)
        for e in (src, dst):
            if e.serving_snapshot()["pages_in_transit"]:
                raise AssertionError("migration: pages left in transit")
            e.check_page_conservation()
        if dst.stats["migrations_adopted"] != 1:
            raise AssertionError("migration: the ticket was not adopted")
        exported[kv_quant] = src
        res[_fmt(kv_quant)] = dict(stream=same, pages_shipped=n_pages,
                                   launches=lc.check())
        for e in (ref, dst):
            e.close()
    # int4 pages cannot land in an int8 engine (same byte dtype)
    src, dst = exported["int4"], _cont(gen, kv_quant="int8")
    r = src.submit(prompt[:200], max_new_tokens=32, seed=6)
    while len(r.tokens) < 10:
        src.step_chunk()
    src.freeze_slot(r.slot)
    if dst.stage_migration("x", src.export_slot(r.slot)):
        raise AssertionError("migration: int4 pages staged into int8")
    dst.check_page_conservation()
    src.abort_migration(r.slot)
    src.run_until_idle()
    for e in list(exported.values()) + [dst]:
        e.close()
    res["int4_to_int8_refused"] = True

    # one prefill→decode handoff and one drain
    lc = _Launches("handoff and drain")
    ref = lc.add(_cont(gen))
    want = ref.submit(prompt[:400], max_new_tokens=32, seed=8)
    ref.run_until_idle()
    pre = lc.add(_cont(gen, handoff_after_prefill=True,
                       worker_role="prefill"))
    dec = lc.add(_cont(gen, worker_role="decode"))
    pre.submit(prompt[:400], max_new_tokens=32, seed=8, handoff=True)
    manifest = []
    while not manifest:
        pre.step_chunk()
        manifest = pre.handoff_manifest()
    (slot, req), = manifest
    chain, limit = pre.migration_chain(slot)
    blob = pre.export_slot(slot, n_skip=dec.resident_prefix_pages(chain,
                                                                  limit))
    if not dec.stage_migration("h", blob):
        raise AssertionError("handoff: staging refused")
    moved = pre.commit_handoff(slot)
    r2 = dec.submit(moved.prompt, max_new_tokens=moved.budget,
                    seed=moved.seed, adopt="h")
    dec.run_until_idle()
    hand = _equal_stream("handoff", r2.tokens, want.tokens)
    if pre.stats["handoffs_completed"] != 1 or moved.tokens:
        raise AssertionError("handoff: not completed at the boundary")
    queued = [pre.submit(prompt[i:i + 200], max_new_tokens=16, seed=i)
              for i in range(0, 80, 8)]
    pre.begin_drain()
    shed = pre.shed_queued()
    if len(shed) != len(queued) or pre.submit([1, 2],
                                              max_new_tokens=2).error is None:
        raise AssertionError("drain: the fence did not hold")
    moved_q = [dec.submit(q.prompt, max_new_tokens=q.budget, seed=q.seed)
               for q in shed]
    dec.run_until_idle()
    if not all(q.finished and len(q.tokens) == 16 for q in moved_q):
        raise AssertionError("drain: a shed request did not finish")
    for e in (pre, dec, ref):
        e.check_page_conservation()
        e.close()
    res["handoff"] = dict(stream=hand, launches=lc.check(),
                          drained=len(shed))
    log(f"migration (qwen3-0p6b bf16, 700-token prompt, frozen at 20 of 48 "
        f"tokens): {json.dumps(res)}")
    del gen
    torch.cuda.empty_cache()
    return res


def host_tier_phase() -> dict:
    """The host-RAM tier: 2 slots over a 512-position engine (65 pages),
    a 256-token shared prefix served, then three 400-token prompts of
    churn that force its pages out of the trie into the host tier; the
    re-request is promoted back (host_tier_hits > 0, prefill skipped) and
    equal to the first run. Then one fleet pull between two engines
    through make_fleet_fetcher over their router snapshots."""
    from tensorlink_tpu_torch.fleet.prefixmap import make_fleet_fetcher

    cfg, _ = _model()
    gen = _gen(max_seq_len=512)
    rng = np.random.default_rng(66)
    V = cfg.vocab_size
    shared = rng.integers(0, V, 256).tolist()
    oracle = shared + rng.integers(0, V, 40).tolist()
    churn = [rng.integers(0, V, 400).tolist() for _ in range(3)]
    lc = _Launches("host tier")
    ce = lc.add(_cont(gen, max_slots=2, host_tier_pages=64))
    first = ce.submit(oracle, max_new_tokens=32, seed=1)
    ce.run_until_idle()
    for i, p in enumerate(churn):
        ce.submit(p, max_new_tokens=32, seed=10 + i)
        ce.run_until_idle()
    demoted = ce.stats["prefix_demotions"]
    skipped0 = ce.stats["prefill_tokens_skipped"]
    again = ce.submit(oracle, max_new_tokens=32, seed=1)
    ce.run_until_idle()
    if demoted <= 0 or ce.stats["host_tier_hits"] <= 0 or \
            again.cache_tier != "host":
        raise AssertionError(f"host tier: demotions {demoted}, hits "
                             f"{ce.stats['host_tier_hits']}, tier "
                             f"{again.cache_tier}")
    skipped = ce.stats["prefill_tokens_skipped"] - skipped0
    if skipped <= 0:
        raise AssertionError("host tier: no prefill skipped")
    tier = _equal_stream("host tier", again.tokens, first.tokens)
    ce.check_page_conservation()
    snap = ce.serving_snapshot()
    ce.close()
    # the fleet pull: r1 served the prompt, r0 never saw it
    r0 = lc.add(_cont(gen, max_slots=2))
    r1 = lc.add(_cont(gen, max_slots=2))
    cold = r1.submit(oracle, max_new_tokens=32, seed=1)
    r1.run_until_idle()
    engines = {"r0": r0, "r1": r1}
    r0.fetch_prefix = make_fleet_fetcher(
        "r0", r0.page_size,
        lambda: {rid: e.router_snapshot() for rid, e in engines.items()},
        {rid: (lambda ch, lim, ns, e=e: e.export_prefix_pages(
            ch, lim, n_skip=ns)) for rid, e in engines.items()},
    )
    pulled = r0.submit(oracle, max_new_tokens=32, seed=1)
    r0.run_until_idle()
    if r0.stats["fleet_pulls"] != 1 or pulled.cache_tier != "fleet":
        raise AssertionError(f"fleet pull: {r0.stats['fleet_pulls']} pulls, "
                             f"tier {pulled.cache_tier}")
    pull = _equal_stream("fleet pull", pulled.tokens, cold.tokens)
    for e in (r0, r1):
        e.check_page_conservation()
        e.close()
    res = dict(
        demotions=demoted, host_tier_hits=snap["host_tier_hits"],
        prefill_tokens_skipped=skipped, stream=tier,
        tier_fetch_ms_count=snap["tier_fetch_ms_count"],
        tier_fetch_ms_sum=snap["tier_fetch_ms_sum"],
        fleet_pull=dict(stream=pull,
                        skipped=r0.stats["prefill_tokens_skipped"]),
        launches=lc.check(),
    )
    log(f"host tier (qwen3-0p6b bf16, fp pages, 64-page host tier): "
        f"{json.dumps(res)}")
    del gen
    torch.cuda.empty_cache()
    return res


def cohost_phase() -> dict:
    """Two tenants of one geometry on a SharedPagePool of 600 pages (bf16
    weights, and int8 weights over the same checkpoint), quotas 300 each,
    4 requests each stepped from one thread: each tenant's greedy streams
    equal its solo runs, each within its quota, the pool conserved at
    every boundary and whole at the end."""
    from tensorlink_tpu_torch.engine.paged import SharedPagePool

    cfg, _ = _model()
    gens = {"bf16": _gen(max_seq_len=2048),
            "int8": _gen(max_seq_len=2048, quant="int8")}
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (300, 700, 150, 1000)]
    lc = _Launches("co-hosting")
    solo = {}
    for name, gen in gens.items():
        ce = lc.add(_cont(gen, max_slots=4))
        rs = [ce.submit(p, max_new_tokens=32, seed=i)
              for i, p in enumerate(prompts)]
        ce.run_until_idle()
        solo[name] = [list(r.tokens) for r in rs]
        ce.close()
    pool = SharedPagePool(cfg, 600, page_size=16, device="cuda")
    tenants = {name: lc.add(_cont(gen, max_slots=4, pool=pool,
                                  model_id=name, page_quota=300))
               for name, gen in gens.items()}
    a, b = tenants.values()
    if a.cache.k is not b.cache.k:
        raise AssertionError("co-hosting: tenants hold separate pages")
    reqs = {name: [ce.submit(p, max_new_tokens=32, seed=i)
                   for i, p in enumerate(prompts)]
            for name, ce in tenants.items()}
    peak = {name: 0 for name in tenants}
    while a.step_chunk() | b.step_chunk():
        pool.check_page_conservation()
        for name, ce in tenants.items():
            peak[name] = max(peak[name], ce.alloc.used)
            if ce.alloc.used > ce.alloc.quota:
                raise AssertionError(f"co-hosting: {name} over its quota")
    streams = {}
    for name in tenants:
        streams[name] = [
            _equal_stream(f"co-hosting {name} request {i}", r.tokens,
                          solo[name][i])
            for i, r in enumerate(reqs[name])]
    for ce in tenants.values():
        ce.close()
    if pool.alloc.n_free != 600 or pool.tenants:
        raise AssertionError("co-hosting: pages not returned at close")
    res = dict(streams=streams, peak_pages_used=peak, quota=300,
               launches=lc.check())
    log(f"co-hosting (qwen3-0p6b bf16 + int8 weights, one pool): "
        f"{json.dumps(res)}")
    del gens
    torch.cuda.empty_cache()
    return res


def publish_phase() -> dict:
    """publish_weights of a perturbed copy while a stream decodes: the
    stream runs to its full length, weights_version grows, the prefix
    trie is fenced, and no parameter or page tensor changes shape, dtype
    or device."""
    cfg, params = _model()
    gen = _gen()
    lc = _Launches("publish")
    ce = lc.add(_cont(gen))
    rng = np.random.default_rng(88)
    warm = rng.integers(0, cfg.vocab_size, 300).tolist()
    ce.submit(warm, max_new_tokens=4, seed=1)
    ce.run_until_idle()
    resident = ce.prefix.n_resident
    live = ce.submit(rng.integers(0, cfg.vocab_size, 500).tolist(),
                     max_new_tokens=64, seed=2)
    while len(live.tokens) < 16:
        ce.step_chunk()

    def layout():
        leaves = []

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}/{k}")
            else:
                leaves.append((path, tuple(t.shape), t.dtype, t.device))

        walk(gen.params, "")
        c = ce.cache
        return leaves + [(n, tuple(t.shape), t.dtype, t.device)
                         for n, t in (("k", c.k), ("v", c.v),
                                      ("bt", c.block_tables))]

    before = layout()
    new = {k: v for k, v in params.items()}
    new["final_norm"] = {"scale": params["final_norm"]["scale"] * 1.01}
    version = ce.publish_weights(new)
    fenced = ce.prefix.n_resident == 0 and not ce.prefix.match(
        warm, len(warm) - 1)
    ce.run_until_idle()
    after = layout()
    if not (live.finished and len(live.tokens) == 64):
        raise AssertionError("publish: the live stream did not finish")
    if version != 2 or ce.weights_version != 2 or not fenced:
        raise AssertionError(f"publish: version {version}, fenced {fenced}")
    if before != after:
        raise AssertionError("publish: a tensor changed shape, dtype or "
                             "device")
    ce.check_page_conservation()
    ce.close()
    res = dict(weights_version=version, resident_before=resident,
               fenced=fenced, tensors=len(before), launches=lc.check())
    log(f"publish (qwen3-0p6b bf16, mid-stream): {json.dumps(res)}")
    del gen
    torch.cuda.empty_cache()
    return res


# -- phase 9 -----------------------------------------------------------
# checkpoints written and read back by the port's loader, under the
# git-ignored build/ directory, deleted at the end of the phase
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "checkpoints"
MIXTRAL_LAYERS = 2  # of 32: full depth is about 93 GB in bf16
# the bf16 MoE MLP against its f32 reference, per row: max |diff| within
# MOE_TOL x the row's max |reference| (bf16_parity's bound)
MOE_TOL = 1.6e-2
CKPT_REQUESTS = (0, 1, 2, 3, 5, 6, 7, 9)  # 8 of _requests', 0 greedy
CKPT_NEW = 32  # new tokens per request
QWEN3_SHARD_BYTES = 256 * 2**20  # qwen3-0p6b's 1.19 GB in several shards


def _hf_config(cfg) -> dict:
    """A Hugging Face config dict (Qwen3 or Mixtral field names) that
    config_from_hf parses back to ``cfg`` in bf16."""
    hf = dict(model_type=cfg.family, vocab_size=cfg.vocab_size,
              hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
              num_attention_heads=cfg.n_heads,
              num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
              intermediate_size=cfg.d_ff,
              max_position_embeddings=cfg.max_seq_len,
              rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
              tie_word_embeddings=cfg.tie_embeddings)
    if cfg.moe:
        hf.update(num_local_experts=cfg.n_experts,
                  num_experts_per_tok=cfg.n_experts_per_tok,
                  sliding_window=cfg.sliding_window)
    return hf


def _same_tree(label, got: dict, want: dict) -> int:
    """Every leaf of ``want`` bitwise in ``got`` (same dtype, shape and
    device); returns the bytes compared."""
    n = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            n += _same_tree(f"{label}/{k}", g, w)
            continue
        if g.dtype != w.dtype or g.shape != w.shape \
                or g.device != w.device or not torch.equal(g, w):
            raise AssertionError(f"{label}/{k}: the loaded leaf differs")
        n += w.numel() * w.element_size()
    if set(got) != set(want):
        raise AssertionError(f"{label}: leaves {sorted(got)} vs "
                             f"{sorted(want)}")
    return n


def _load(ckpt, **kw):
    """``load_params`` onto the card, timed to the device's end."""
    (cfg, params), secs = _sync_s(lambda: load_params(ckpt, device="cuda",
                                                      **kw))
    return cfg, params, secs


def _ckpt_serve(cfg, params, kv_quant, lc, solo=False) -> list:
    """8 of _requests' prompts through one ContinuousEngine on the
    kernels (engines join ``lc``); with ``solo``, also the greedy request
    alone on a fresh engine, which must equal its co-batched stream."""
    _, all_reqs = _requests(cfg)
    reqs = [all_reqs[i] for i in CKPT_REQUESTS]
    gen = GenerationEngine(cfg, params, max_seq_len=4096, device="cuda")
    ce = lc.add(_cont(gen, kv_quant=kv_quant))
    out = [ce.submit(ids, max_new_tokens=CKPT_NEW,
                     sampling=SamplingParams.make(**knobs), seed=i)
           for i, (ids, knobs) in enumerate(reqs)]
    ce.run_until_idle()
    if not all(r.finished and r.error is None
               and len(r.tokens) == CKPT_NEW for r in out):
        raise AssertionError(f"{lc.label}: a request did not finish")
    ce.close()  # checks page conservation
    streams = [list(r.tokens) for r in out]
    if solo:
        alone = lc.add(_cont(gen, kv_quant=kv_quant))
        r = alone.submit(reqs[0][0], max_new_tokens=CKPT_NEW, seed=0)
        alone.run_until_idle()
        alone.close()
        _equal_stream(f"{lc.label}: greedy alone vs co-batched", r.tokens,
                      streams[0])
    return streams


def _moe_reference(h, p, cfg):
    """The MoE MLP in float32 over only each token's top-k experts,
    gathered per expert. It routes apart from the program: the router
    product is the plain ``h @ router`` in the model's dtype (the JAX
    model's definition), and the top-k comes from numpy's stable argsort
    on the host (ties to the lower index, as ``lax.top_k``), which
    ``ttr.top_k`` on the card must match on the same logits."""
    d, E, K = cfg.d_model, cfg.n_experts, cfg.n_experts_per_tok
    x = h.reshape(-1, d).float()
    logits = (h @ p["router"]).float().reshape(-1, E)
    order = np.argsort(-logits.cpu().numpy(), axis=-1, kind="stable")
    topi = torch.from_numpy(order[:, :K].copy()).to(h.device)
    if not torch.equal(ttr.top_k(logits, K)[1], topi):
        raise AssertionError("MoE check: ttr.top_k picks other experts "
                             "than numpy's stable sort")
    w = torch.softmax(logits.gather(-1, topi), dim=-1)
    out = torch.zeros_like(x)
    for e in range(E):
        rows, rank = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = (ttr._act(xe @ p["w_gate"][e].float(), cfg.act)
             * (xe @ p["w_up"][e].float())) @ p["w_down"][e].float()
        out.index_add_(0, rows, y * w[rows, rank, None])
    return out.reshape(h.shape)


def _moe_check(cfg, chunk_calls) -> dict:
    """Each layer's dense-dispatch _moe_mlp of one ragged chunk (inputs
    and output recorded while the engine ran it) against
    _moe_reference, per row within MOE_TOL x the row's max; a third
    expert's gate switched on (top-3) must read above the bound; the
    capacity dispatch at capacity factor E/K within the same bound of the
    dense dispatch. Also reads how many tokens a float32 router product
    would route to another top-k set (not a gate)."""
    K = cfg.n_experts_per_tok
    res = dict(dense=0.0, fault=float("inf"), sparse=0.0,
               f32_router_rerouted=0, tokens=0)
    for h, p, out in chunk_calls:
        want = _moe_reference(h, p, cfg)
        res["dense"] = max(res["dense"], _attn_ratio(out, want, MOE_TOL))
        fault = ttr._moe_mlp(h, p, cfg.with_(n_experts_per_tok=K + 1))
        res["fault"] = min(res["fault"], _attn_ratio(fault, want, MOE_TOL))
        sparse = sparse_moe_mlp(h, p, cfg,
                                capacity_factor=cfg.n_experts / K)
        res["sparse"] = max(res["sparse"], _attn_ratio(sparse, out, MOE_TOL))
        bf = ttr.top_k(ttr._mm(h, p["router"]).float(), K)[1]
        f32 = ttr.top_k(h.float() @ p["router"].float(), K)[1]
        res["f32_router_rerouted"] += int(
            (bf.sort(-1).values != f32.sort(-1).values).any(-1).sum())
        res["tokens"] += h.shape[0] * h.shape[1]
    if res["dense"] > 1.0 or res["sparse"] > 1.0:
        raise AssertionError(f"MoE check: beyond the bound: {res}")
    if res["fault"] <= 1.0:
        raise AssertionError(f"MoE check: the planted third expert passes "
                             f"the check, which then proves nothing: {res}")
    return res


@contextlib.contextmanager
def _record_moe_chunk(calls: list, n_layers: int):
    """Record (h, layer params, output) of the first ``n_layers`` calls
    of the MoE MLP with more than one row per slot: one ragged chunk."""
    real = ttr._moe_mlp

    def rec(h, p, cfg):
        out = real(h, p, cfg)
        if h.shape[1] > 1 and len(calls) < n_layers:
            calls.append((h.clone(), p, out.clone()))
        return out

    ttr._moe_mlp = rec
    try:
        yield
    finally:
        ttr._moe_mlp = real


@contextlib.contextmanager
def _hold_attention(readings: dict, n_layers: int):
    """Hold the engine's first ``n_layers`` ragged launches with a valid
    row (the first chunk's layers) and its first ``n_layers`` decode
    launches with a slot of positive length (the first live decode
    step's) as bf16_parity does: each against its plain version on the
    same inputs and against a planted fault (the ragged launch's own key
    masked; the decode launch's query heads over the next kv head, since
    one key masked among a decode row's hundreds can read under the
    bound), into ``readings["ragged"]`` and ``readings["decode"]``, with
    the query and page shapes under ``readings["shapes"]``. The plain
    calls stay out of the counts that _Launches.check reads."""
    real = {"ragged": paged.ragged_paged_attention,
            "decode": paged.paged_attention}
    held = {"ragged": _held(real["ragged"], _ragged_plain, _ragged_fault,
                            readings["ragged"]),
            "decode": _held(real["decode"], _decode_plain,
                            _decode_head_fault, readings["decode"])}
    refs = (att.ragged_paged_attention_ref, att.paged_attention_ref)

    def hold(key):
        def call(q, kp, *a, **kw):
            # a[-1]: the ragged launch's n_valid, the decode's lengths
            if len(readings[key]) >= n_layers or not bool((a[-1] > 0).any()):
                return real[key](q, kp, *a, **kw)
            readings["shapes"].setdefault(
                key, dict(q=list(q.shape), pages=list(kp.shape)))
            calls = [r.calls for r in refs]
            try:
                return held[key](q, kp, *a, **kw)
            finally:
                for r, n in zip(refs, calls):
                    r.calls = n

        return call

    paged.ragged_paged_attention = hold("ragged")
    paged.paged_attention = hold("decode")
    try:
        yield
    finally:
        paged.ragged_paged_attention = real["ragged"]
        paged.paged_attention = real["decode"]


def _held_readings(label, readings: dict, n_layers: int) -> dict:
    """The worst kernel reading and the least fault reading of each held
    kernel; raises unless every layer was held, every kernel reading is
    within the bound and every fault reading above it."""
    res = {"shapes": readings["shapes"]}
    for key in ("ragged", "decode"):
        r = readings[key]
        if len(r) != n_layers:
            raise AssertionError(f"{label}: {len(r)} {key} launches held "
                                 f"for {n_layers} layers")
        res[key] = max(k for k, _ in r)
        res[f"{key}_fault"] = min(f for _, f in r)
    if max(res["ragged"], res["decode"]) > 1.0:
        raise AssertionError(f"{label}: an attention output differs beyond "
                             f"the bound: {res}")
    if min(res["ragged_fault"], res["decode_fault"]) <= 1.0:
        raise AssertionError(f"{label}: the planted fault passes the check, "
                             f"which then proves nothing: {res}")
    return res


def checkpoint_phase() -> dict:
    """qwen3-0p6b (phase 8's seeded tree) and a 2-layer full-width
    Mixtral written by export_hf and read back by load_params, bitwise;
    served through the kernels from the loaded trees."""
    smi = _smi()
    res: dict = {}
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    try:
        # qwen3-0p6b: several 256 MiB shards and the index
        cfg, params = _model()
        d = CKPT_ROOT / "qwen3-0p6b"
        _, export_s = _sync_s(lambda: export_hf(
            cfg, params, d, hf_config=_hf_config(cfg),
            max_shard_bytes=QWEN3_SHARD_BYTES))
        shards = sorted(f.name for f in d.glob("*.safetensors"))
        if len(shards) < 3 or not (d / "model.safetensors.index.json") \
                .exists():
            raise AssertionError(f"qwen3 export: {shards}")
        lcfg, lparams, load_s = _load(d)
        if lcfg != cfg:
            raise AssertionError(f"qwen3: loaded config {lcfg} != {cfg}")
        nbytes = _same_tree("qwen3", lparams, params)
        _, part, _ = _load(d, layer_range=(10, 14))
        want = {k: v for k, v in params.items() if k != "layers"}
        want["layers"] = {
            g: {k: v[10:14] for k, v in leaves.items()}
            for g, leaves in params["layers"].items()}
        _same_tree("qwen3 layers [10, 14)", part, want)
        del part, want
        res["qwen3"] = q = dict(shards=len(shards), bytes=nbytes,
                                export_s=export_s, load_s=load_s,
                                load_gb_per_s=nbytes / load_s / 1e9)
        lc = _Launches("checkpoint qwen3")
        got = _ckpt_serve(cfg, lparams, "none", lc)
        q["launches"] = lc.check()
        lc = _Launches("checkpoint qwen3 source")
        want = _ckpt_serve(cfg, params, "none", lc)
        q["launches_source"] = lc.check()
        for i, (a, b) in enumerate(zip(got, want)):
            _equal_stream(f"qwen3 loaded vs source, request {i}", a, b)
        del lparams
        shutil.rmtree(d)
        log(f"checkpoint qwen3-0p6b bf16 ({smi}): {json.dumps(q)}")

        # Mixtral at full width, 2 of its 32 layers, default 4 GiB shards
        cfg = config_presets()["mixtral-8x7b"].with_(
            n_layers=MIXTRAL_LAYERS)
        g = torch.Generator(device="cuda")
        g.manual_seed(1357)
        params = init_params(cfg, g, device="cuda")
        d = CKPT_ROOT / "mixtral-8x7b"
        _, export_s = _sync_s(lambda: export_hf(
            cfg, params, d, hf_config=_hf_config(cfg)))
        shards = sorted(f.name for f in d.glob("*.safetensors"))
        lcfg, lparams, load_s = _load(d)
        if lcfg != cfg:
            raise AssertionError(f"mixtral: loaded config {lcfg} != {cfg}")
        nbytes = _same_tree("mixtral", lparams, params)
        del params
        torch.cuda.empty_cache()
        res["mixtral"] = m = dict(layers=cfg.n_layers, shards=len(shards),
                                  bytes=nbytes, export_s=export_s,
                                  load_s=load_s,
                                  load_gb_per_s=nbytes / load_s / 1e9)
        calls: list = []
        for kv_quant in ("none", "int8"):
            fmt = _fmt(kv_quant)
            lc = _Launches(f"checkpoint mixtral {fmt}")
            readings: dict = dict(ragged=[], decode=[], shapes={})
            with _record_moe_chunk(calls, cfg.n_layers), \
                    _hold_attention(readings, cfg.n_layers):
                _ckpt_serve(cfg, lparams, kv_quant, lc, solo=True)
            m[f"launches_{fmt}"] = lc.check()
            m[f"attention_{fmt}"] = _held_readings(
                f"checkpoint mixtral {fmt} attention", readings,
                cfg.n_layers)
        m["moe"] = _moe_check(cfg, calls)
        del calls, lparams
        shutil.rmtree(d)
        log(f"checkpoint mixtral-8x7b widths, {cfg.n_layers} layers, bf16 "
            f"({smi}; MoE bound {MOE_TOL} and attention bound "
            f"{BF16_ATTN_TOL} x the row's max): {json.dumps(m)}")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


# -- phase 10 ----------------------------------------------------------
NODE_ROOT = Path(__file__).resolve().parent / "build" / "node"
NODE_MODEL = "qwen3-0p6b"
NODE_NEW = 64  # new tokens per request
NODE_GREEDY = 8  # concurrent greedy /v1/generate requests


@contextlib.contextmanager
def _clean_spawn():
    """Start node processes from the port's node modules alone: a spawned
    child re-runs the parent's main script unless ``__main__`` has no file,
    and this script imports torch and the whole port, which a node's
    network process must not."""
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main.__file__ = path


def _http(port, method, path, body=None, rid="", timeout=900.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body).encode() if body is not None else None
    headers = {"X-Request-Id": rid} if rid else {}
    if payload is not None:
        headers["Content-Type"] = "application/json"
    conn.request(method, path, body=payload, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"node: {method} {path} answered {resp.status}: "
                             f"{data[:300]!r}")
    if resp.getheader("Content-Type", "").startswith("application/json"):
        return json.loads(data)
    return data.decode()


def _sse(port, path, body, rid, timeout=900.0) -> list:
    """POST and read the whole server-sent event stream's data payloads."""
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    payload = json.dumps(body).encode()
    s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nX-Request-Id: {rid}\r\n"
              f"Content-Type: application/json\r\nContent-Length: "
              f"{len(payload)}\r\n\r\n".encode() + payload)
    buf = b""
    while chunk := s.recv(65536):
        buf += chunk
    s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    if b" 200 " not in head.split(b"\r\n")[0]:
        raise AssertionError(f"node: SSE {path} answered {head[:200]!r}")
    return [blk.strip()[len("data: "):] for blk in rest.decode().split("\n\n")
            if blk.strip().startswith("data: ")]


def _node_messages():
    """8 greedy prompts of 64 to 1536 printable bytes, a chat turn and a
    sampled prompt, from a seed."""
    rng = np.random.default_rng(31)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz ,.ABCDEFGH0123456789"))

    def text(n):
        return "".join(rng.choice(chars, n))

    return ([text(int(rng.integers(64, 1537))) for _ in range(NODE_GREEDY)],
            text(200), text(300))


def _first_token_ms(rid: str) -> float:
    from tensorlink_tpu_torch.core.trace import get_tracer

    spans = [s for s in get_tracer().collect(rid) if s["name"] == "first_token"]
    if len(spans) != 1:
        raise AssertionError(f"node: trace {rid} has {len(spans)} first_token "
                             "spans")
    return float(spans[0]["dur_ms"])


def _net_process_libraries(node) -> list:
    """torch or jax libraries mapped into a node's network process (its
    /proc maps): the network half must load neither."""
    maps = Path(f"/proc/{node._proc.pid}/maps").read_text()
    return sorted({line.split()[-1] for line in maps.splitlines()
                   if re.search(r"libtorch|libc10|jaxlib|xla_extension",
                                line)})


def _quantiles(xs) -> tuple:
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[int(0.95 * (len(xs) - 1))]


def _wait_idle(cont, rt) -> None:
    """Until the worker's slot engine has no work and its chunk count has
    stopped moving (the serial run loop may still hold a queued marker)."""
    deadline = time.monotonic() + 60
    last = -1
    while time.monotonic() < deadline:
        if not cont.has_work() and not rt.cont_scheduled and \
                cont.chunks == last:
            return
        last = cont.chunks
        time.sleep(0.2)
    raise AssertionError("node: the worker's engine never went idle")


def node_phase() -> dict:
    """The node path: a port validator (HTTP endpoint) and worker on
    127.0.0.1 host qwen3-0p6b at full width (seeded bf16, int8 KV pages
    by default) and serve 8 concurrent greedy /v1/generate requests, a
    streamed /v1/chat/completions and a sampled request through the
    worker's ContinuousEngine on the card. Holds every request finished,
    the greedy streams token-equal (and their texts equal) to an
    in-process ContinuousBatcher over the same seeded weights and knobs,
    the streamed deltas equal to the plain chat text, the worker engine's
    launch counts, /stats, /metrics and /healthz."""
    from tensorlink_tpu_torch.api.formatter import extract_reasoning_and_answer
    from tensorlink_tpu_torch.core.config import (
        MLConfig,
        ValidatorConfig,
        WorkerConfig,
    )
    from tensorlink_tpu_torch.nodes.runners import ValidatorNode, WorkerNode

    shutil.rmtree(NODE_ROOT, ignore_errors=True)
    ml = MLConfig()  # device None: the card
    common = dict(local_test=True, log_dir=str(NODE_ROOT / "logs"),
                  env_file=str(NODE_ROOT / ".env"), ml=ml)
    nodes = []
    try:
        with _clean_spawn():
            v = ValidatorNode(ValidatorConfig(
                endpoint=True, endpoint_port=0,
                key_dir=str(NODE_ROOT / "vkeys"), **common)).start()
            nodes.append(v)
            w = WorkerNode(WorkerConfig(
                seed_validators=[["127.0.0.1", v.port]],
                key_dir=str(NODE_ROOT / "wkeys"), **common)).start()
            nodes.append(w)
        deadline = time.monotonic() + 60
        while not v.status()["peers"]:
            if time.monotonic() > deadline:
                raise AssertionError("node: the worker never joined")
            time.sleep(0.1)
        for n in nodes:
            libs = _net_process_libraries(n)
            if libs:
                raise AssertionError(f"node: the {n.role}'s network process "
                                     f"mapped {libs}")
        port = v.api.port
        t0 = time.monotonic()
        host = _http(port, "POST", "/request-model", {"hf_name": NODE_MODEL})
        host_s = time.monotonic() - t0
        if host.get("status") != "ready":
            raise AssertionError(f"node: hosting answered {host}")
        job = v.executor.hosted[NODE_MODEL]
        if job.batcher.mode != "remote":
            raise AssertionError(f"node: batcher mode {job.batcher.mode}")
        rt = w.executor.jobs[job.replicas[0]["job_id"]]
        # each request's prompt ids and tokens as the validator's batcher
        # sees them, keyed by trace id (the X-Request-Id sent)
        seen = {}
        inner = job.batcher.generate

        def recording(ids, **kw):
            out = inner(ids, **kw)
            seen[kw.get("trace_id", "")] = (list(ids), list(out))
            return out

        job.batcher.generate = recording
        greedy, chat_msg, sampled_msg = _node_messages()
        _http(port, "POST", "/v1/generate", {
            "hf_name": NODE_MODEL, "message": "warm up the slot engine",
            "max_new_tokens": 8, "do_sample": False})
        cont = rt.cont
        if cont is None or cont.kv_quant != "int8":
            raise AssertionError("node: the worker serves no int8 slot engine")
        _wait_idle(cont, rt)
        lc = _Launches("node path")
        lc.add(cont)
        chat = {"model": NODE_MODEL, "max_tokens": NODE_NEW,
                "temperature": 0.0,
                "messages": [{"role": "user", "content": chat_msg}]}
        calls = {
            f"node-greedy-{i}": lambda m=m, i=i: _http(
                port, "POST", "/v1/generate",
                {"hf_name": NODE_MODEL, "message": m, "do_sample": False,
                 "max_new_tokens": NODE_NEW}, rid=f"node-greedy-{i}")
            for i, m in enumerate(greedy)
        }
        calls["node-chat"] = lambda: _sse(
            port, "/v1/chat/completions", {**chat, "stream": True},
            "node-chat")
        calls["node-sampled"] = lambda: _http(
            port, "POST", "/v1/generate",
            {"hf_name": NODE_MODEL, "message": sampled_msg,
             "max_new_tokens": NODE_NEW, "do_sample": True,
             "temperature": 0.8, "top_k": 50, "top_p": 0.95},
            rid="node-sampled")
        results, latency, errors = {}, {}, []

        def one(rid):
            try:
                t = time.monotonic()
                results[rid] = calls[rid]()
                latency[rid] = time.monotonic() - t
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(r,)) for r in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads) or len(results) != len(calls):
            raise AssertionError("node: not every request finished")
        _wait_idle(cont, rt)
        launches = lc.check()
        # the streamed deltas join to the same chat request's plain text
        events = results["node-chat"]
        if events[-1] != "[DONE]":
            raise AssertionError("node: the chat stream did not end in [DONE]")
        streamed = "".join(
            c["choices"][0]["delta"].get("content") or ""
            for c in map(json.loads, events[:-1]) if c.get("choices"))
        plain = _http(port, "POST", "/v1/chat/completions", chat,
                      rid="node-chat-plain")
        if streamed != plain["choices"][0]["message"]["content"] or \
                seen["node-chat"] != seen["node-chat-plain"]:
            raise AssertionError("node: the streamed chat differs from its "
                                 "plain run")
        stats = _http(port, "GET", "/stats")
        snap = next(m for m in stats["models"]
                    if m["name"] == NODE_MODEL)["serving"]["engine"]
        # 59,136 bytes a position: 2 x 28 layers x 8 kv heads x (128 codes
        # + a 4-byte scale), in pages of 16 positions
        if snap["kv_quant"] != "int8" or snap["kv_page_bytes"] != \
                KV_BYTES_PER_TOKEN["int8"] * ml.cont_page_size:
            raise AssertionError(f"node: /stats engine {snap['kv_quant']} "
                                 f"{snap['kv_page_bytes']}")
        if "tlink_engine_" not in _http(port, "GET", "/metrics"):
            raise AssertionError("node: /metrics carries no tlink_engine_*")
        if NODE_MODEL not in _http(port, "GET", "/healthz")["hosted_models"]:
            raise AssertionError("node: /healthz does not list the model")
        http_ttft = [_first_token_ms(f"node-greedy-{i}")
                     for i in range(NODE_GREEDY)]
        tok = job.tokenizer
        node = {f"node-greedy-{i}": seen[f"node-greedy-{i}"]
                for i in range(NODE_GREEDY)}
        node_tokens = sum(len(out) for _ids, out in node.values())
        v.executor.unhost_model(NODE_MODEL)
    finally:
        for n in reversed(nodes):
            n.stop()
        # drop the worker's engine before the in-process one is built
        nodes = v = w = job = rt = cont = lc = None
        torch.cuda.empty_cache()

    # the in-process reference: the same seeded tree, the worker's knobs
    cfg = config_presets()[NODE_MODEL]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)  # the hosted spec's seed
    eng = GenerationEngine(cfg, init_params(cfg, g, device="cuda"),
                           max_seq_len=min(cfg.max_seq_len, ml.max_seq_len),
                           seq_buckets=ml.seq_buckets,
                           batch_buckets=ml.batch_buckets, device="cuda")
    b = ContinuousBatcher(
        engine=eng, max_slots=ml.cont_max_slots, page_size=ml.cont_page_size,
        chunk_steps=ml.cont_chunk_steps, prefill_chunk=ml.prefill_chunk,
        prefix_cache=ml.prefix_cache, kv_quant=ml.kv_quant,
        spec_decode=ml.spec_decode, spec_draft=ml.spec_draft,
        default_priority=ml.default_priority, eos_ids=tok.eos_ids)
    ref, errors = {}, []

    def local(rid):
        try:
            ref[rid] = b.generate(node[rid][0], max_new_tokens=NODE_NEW,
                                  trace_id=f"inproc-{rid}")
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=local, args=(r,)) for r in node]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    local_wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    eos = set(tok.eos_ids)
    for rid, (_ids, out) in node.items():
        _equal_stream(f"node {rid}", out, ref[rid])
        want = extract_reasoning_and_answer(
            tok.decode([t for t in ref[rid] if t not in eos]))[1]
        if results[rid]["response"] != want:
            raise AssertionError(f"node {rid}: the HTTP text differs from the "
                                 "in-process run's")
    local_ttft = [_first_token_ms(f"inproc-{rid}") for rid in node]
    b.close()
    del eng, b
    torch.cuda.empty_cache()
    greedy_lat = [latency[r] for r in node]
    p50, p95 = _quantiles(http_ttft)
    l50, l95 = _quantiles(local_ttft)
    q50, q95 = _quantiles(greedy_lat)
    res = dict(
        card=_smi(), host_s=host_s, requests=len(calls), wall_s=wall,
        http_tokens_per_s=node_tokens / wall,
        http_first_token_ms_p50=p50, http_first_token_ms_p95=p95,
        http_latency_s_p50=q50, http_latency_s_p95=q95,
        local_wall_s=local_wall,
        local_tokens_per_s=sum(len(t) for t in ref.values()) / local_wall,
        local_first_token_ms_p50=l50, local_first_token_ms_p95=l95,
        host_gap_ms=snap["host_gap_ms"], kv_page_bytes=snap["kv_page_bytes"],
        chunks=launches["chunks"], launches=launches["launches"],
        by_format=launches["by_format"],
    )
    log(f"node path (qwen3-0p6b bf16, int8 pages, validator + worker on "
        f"127.0.0.1, {len(calls)} concurrent requests x {NODE_NEW} "
        f"tokens): {json.dumps(res)}")
    return res


def _phase(name, fn, *args):
    t0 = time.monotonic()
    out = fn(*args)
    log(f"phase {name}: {time.monotonic() - t0:.1f}s")
    return out


def main() -> None:
    _phase("device", device_phase)
    _phase("build", build_phase)
    errs = _phase("kernels", kernel_checks)
    _phase("nibble order", nibble_order_check)
    _phase("chunk framing", framing_check)
    _phase("decode rows", decode_rows_check)
    ferrs = _phase("flash kernel", flash_checks)
    times = _phase("kernel timings", kernel_timings)
    ftime = _phase("flash timing", flash_timing)
    for kv_quant in ("none", "int8", "int4"):
        _phase(f"step parity {kv_quant}", step_parity, kv_quant)
    _phase("dense parity", dense_parity)
    _phase("bf16 parity", bf16_parity)
    serving = {}
    for kv_quant, quant, n_req in SERVE_RUNS:
        serving[_fmt(kv_quant)] = _phase(f"serving {kv_quant}", serving_phase,
                                         kv_quant, quant, n_req)
    dense = _phase("dense serving", dense_serving)
    _phase("gemm rows", gemm_rows)
    new_paths = {}
    for kv_quant in ("none", "int8"):
        r = _phase(f"spec serving {kv_quant}", spec_serving, kv_quant)
        new_paths[f"spec {_fmt(kv_quant)}"] = r["launches_on"]
    mig = _phase("migration", migration_phase)
    for fmt in FORMATS:
        new_paths[f"migration {fmt}"] = mig[fmt]["launches"]
    new_paths["handoff and drain"] = mig["handoff"]["launches"]
    new_paths["host tier"] = _phase("host tier", host_tier_phase)["launches"]
    new_paths["co-hosting"] = _phase("co-hosting", cohost_phase)["launches"]
    new_paths["publish"] = _phase("publish", publish_phase)["launches"]
    ck = _phase("checkpoint", checkpoint_phase)
    new_paths["checkpoint qwen3"] = ck["qwen3"]["launches"]
    new_paths["checkpoint qwen3 source"] = ck["qwen3"]["launches_source"]
    for fmt in ("fp", "int8"):
        new_paths[f"checkpoint mixtral {fmt}"] = \
            ck["mixtral"][f"launches_{fmt}"]
    node = _phase("node", node_phase)
    kernels = []
    for name, fmt in _variants():
        t = times[(name, fmt)]
        on_path = name != "paged_prefill_attention"
        entry = {
            "name": name, "route": "cuda",
            "source": f"tensorlink_tpu_torch/ops/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name],
            "launches": serving[fmt]["launches_by_format"][name][fmt],
            "max_abs_err": errs[(name, fmt)]["float32"],
            "max_abs_err_bf16": errs[(name, fmt)]["bfloat16"],
            "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "design": DESIGN[name],
        }
        if fmt == "fp":
            entry["library_call"] = \
                "torch.nn.functional.scaled_dot_product_attention"
        else:
            entry["library_call"] = None
            entry["library_note"] = ("no single PyTorch call consumes int8 "
                                     "or packed-int4 pages")
        if name in NEW_PATHS:
            entry["launches_new_paths"] = {
                label: r["by_format"][name].get(fmt, 0)
                for label, r in new_paths.items()
                if r["by_format"][name].get(fmt, 0)
            }
            # the validator + worker run of phase 10 (int8 pages)
            entry["launches_node_path"] = node["by_format"][name].get(fmt, 0)
        if name != "paged_prefill_attention" and fmt == "fp":
            kernels.append(entry)  # PR 1's two entries, as they were
            continue
        entry["format"] = fmt
        if not on_path:
            entry["launches_note"] = ("no engine caller: the main path "
                                      "never launches it")
        kernels.append(entry)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "tensorlink_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "tensorlink_tpu/ops/attention.py:151",
        "launches": dense["launches"],
        "max_abs_err": ferrs["float32"], "max_abs_err_bf16": ferrs["bfloat16"],
        "ms": ftime["ms"], "kernel_ms": ftime["ms"],
        "device_ms": ftime["device_ms"],
        "plain_ms": ftime["plain_ms"], "bound_ms": ftime["bound_ms"],
        "bound_by": ftime["bound_by"], "library_ms": ftime["library_ms"],
        "library_device_ms": ftime["library_device_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "design": DESIGN["flash_attention"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
