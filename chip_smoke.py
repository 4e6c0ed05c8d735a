"""Drive the PyTorch/CUDA port's serving main path on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Device: a CUDA card is required; prints its name and power limit and
   turns TF32 off for float32 products and convolutions.
2. Build: compiles the CUDA kernels from tensorlink_tpu_torch/ops/csrc/
   (one nvcc per source, started together) into build/tensorlink_tpu_torch/.
3. Kernels: each kernel against its plain PyTorch version at the main
   path's shapes and at small edge cases (float32 rtol = atol = 2e-5;
   bfloat16 compared in float32 at 1.6e-2), then timed at the main path's
   shape (CUDA events, median of 30 runs after warm-up) beside its plain
   version, torch's scaled_dot_product_attention over pre-gathered KV,
   and its bound on the card.
4. Step parity: qwen3-0p6b at full width in float32, three
   paged_ragged_step chunks on a mixed block with the kernels and with
   their plain versions — tokens, counts and lengths equal; every layer,
   fed the same input on both paths, within rtol = atol = 2e-5 on its
   output and pages; the free-running pages, where the per-layer
   differences add up over 28 layers, within 4 times that bound.
5. Serving: qwen3-0p6b at full width in bfloat16 behind a
   ContinuousBatcher — 16 requests from 4 threads — with the kernels'
   launch counts checked against the chunks run, the plain versions
   never called, and a greedy request re-run alone equal to its
   co-batched stream.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from tensorlink_tpu_torch.engine.generate import GenerationEngine
from tensorlink_tpu_torch.engine import paged
from tensorlink_tpu_torch.engine.paged import PagedKVCache, paged_ragged_step
from tensorlink_tpu_torch.ml.batching import ContinuousBatcher
from tensorlink_tpu_torch.models import config_presets, init_params
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.ops import attention as att

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# free-running f32 pages after 3 chunks over 28 layers, in units of the
# per-layer 2e-5 bound: earlier H100 runs read 2.1-2.3
FREE_RUNNING_X = 4.0
MAIN = dict(S=8, C=128, Hq=16, Hkv=8, hd=128, page=16, n_pp=256)
MAIN_STARTS = [0, 896, 1536, 3071, 2000, 57, 4000, 0]
MAIN_NVALID = [128, 128, 1, 1, 1, 1, 1, 0]  # 2 prefills, 5 decodes, idle
MAIN_LENGTHS = [0, 1, 17, 777, 2048, 3100, 4000, 4096]
REPLACES = {
    "ragged_paged_attention": "tensorlink_tpu/ops/attention.py:711",
    "paged_attention": "tensorlink_tpu/ops/attention.py:899",
}


def log(*a):
    print(*a, flush=True)


# -- phase 1 -----------------------------------------------------------
def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 3 -----------------------------------------------------------
def _case(rng, S, C, Hq, Hkv, hd, page, n_pp, starts, nv, lens, dtype):
    dev = torch.device("cuda")
    P = 1 + S * n_pp
    bt = rng.permutation(np.arange(1, P))[: S * n_pp].reshape(S, n_pp)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)
        ).to(dev, dtype)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    return dict(
        q=randn(S, C, Hq, hd), k=randn(P, Hkv, page, hd),
        v=randn(P, Hkv, page, hd), bt=i32(bt), starts=i32(starts),
        nv=i32(nv), lens=i32(lens), scale=hd**-0.5,
    )


def _ragged(c, kernel):
    fn = att.ragged_paged_attention if kernel else \
        att.ragged_paged_attention_ref
    return fn(c["q"], c["k"], c["v"], c["bt"], c["starts"], c["nv"],
              scale=c["scale"])


def _decode(c, kernel):
    fn = att.paged_attention if kernel else att.paged_attention_ref
    return fn(c["q"][:, 0].contiguous(), c["k"], c["v"], c["bt"], c["lens"],
              scale=c["scale"])


EDGE_CASES = [
    # S, C, Hq, Hkv, hd, page, n_pp, starts, n_valid, lengths
    (4, 8, 8, 2, 32, 8, 4, [13, 0, 11, 0], [1, 8, 5, 0], [0, 1, 9, 32]),
    (3, 16, 8, 1, 64, 4, 8, [0, 3, 17], [16, 16, 9], [5, 32, 0]),
    (2, 8, 4, 2, 32, 8, 2, [0, 0], [0, 0], [0, 0]),  # all idle
    (2, 8, 4, 2, 32, 8, 4, [13, 0], [5, 0], [14, 3]),  # verify-style rows
    (2, 4, 32, 2, 256, 16, 3, [20, 1], [4, 3], [47, 16]),  # G 16, hd 256
    (2, 3, 48, 2, 128, 32, 2, [5, 60], [3, 1], [63, 33]),  # G 24: 2 tiles
]


def _err(a, b, tol):
    a, b = a.float().cpu(), b.float().cpu()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output is not finite")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    return float((a - b).abs().max())


def kernel_checks() -> dict:
    rng = np.random.default_rng(0)
    m = MAIN
    errs = {n: {"float32": 0.0, "bfloat16": 0.0} for n in REPLACES}
    cases = [(m["S"], m["C"], m["Hq"], m["Hkv"], m["hd"], m["page"],
              m["n_pp"], MAIN_STARTS, MAIN_NVALID, MAIN_LENGTHS)]
    cases += EDGE_CASES
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for spec in cases:
            c = _case(rng, *spec, dtype=dtype)
            got, want = _ragged(c, True), _ragged(c, False)
            torch.cuda.synchronize()
            e = _err(got, want, tol)
            for s, nv in enumerate(spec[8]):  # rows past n_valid: zeros
                tail = got[s, nv:]
                if tail.numel() and float(tail.abs().max()) != 0.0:
                    raise AssertionError("a row past n_valid is not zero")
            name = str(dtype).split(".")[1]
            errs["ragged_paged_attention"][name] = max(
                errs["ragged_paged_attention"][name], e)
            got, want = _decode(c, True), _decode(c, False)
            torch.cuda.synchronize()
            e = _err(got, want, tol)
            errs["paged_attention"][name] = max(
                errs["paged_attention"][name], e)
    log(f"kernels vs plain versions: max abs err {json.dumps(errs)}")
    return errs


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


def _gathered(c):
    """Per-slot contiguous KV [S, Hkv, K, hd] for the library yardstick
    (gathered once, outside the timed region)."""
    S, n_pp = c["bt"].shape
    _, Hkv, page, hd = c["k"].shape

    def g(p):
        x = p[c["bt"].long()]  # [S, n_pp, Hkv, page, hd]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Hkv, n_pp * page, hd)

    return g(c["k"]).contiguous(), g(c["v"]).contiguous()


def kernel_timings() -> dict:
    m = MAIN
    dtype = torch.bfloat16
    c = _case(np.random.default_rng(1), m["S"], m["C"], m["Hq"], m["Hkv"],
              m["hd"], m["page"], m["n_pp"], MAIN_STARTS, MAIN_NVALID,
              MAIN_LENGTHS, dtype)
    S, C, Hq, Hkv, hd = m["S"], m["C"], m["Hq"], m["Hkv"], m["hd"]
    G, K, elt = Hq // Hkv, m["n_pp"] * m["page"], 2
    kg, vg = (x.repeat_interleave(G, dim=1) for x in _gathered(c))
    pos = torch.arange(K, device="cuda")
    out = {}

    # ragged: rows (s, c) valid when c < n_valid; row sees keys <= start+c
    starts, nvs = MAIN_STARTS, MAIN_NVALID
    q_pos = torch.tensor(starts, device="cuda")[:, None] + \
        torch.arange(C, device="cuda")[None, :]
    mask = pos[None, None, :] <= q_pos[:, :, None]  # [S, C, K]
    mask[:, :, 0] = True  # idle rows: keep SDPA finite (timing only)
    mask = mask[:, None]
    qs = c["q"].permute(0, 2, 1, 3)  # [S, Hq, C, hd]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = sum(st + nv for st, nv in zip(starts, nvs) if nv > 0)
    pairs = sum(st + j + 1 for st, nv in zip(starts, nvs) for j in range(nv))
    n_bytes = (sum(nvs) * Hq * hd * elt  # q: the valid rows only
               + c["q"].numel() * elt  # every output row (zeros included)
               + 2 * live * Hkv * hd * elt  # live K and V, read once
               + sum(-(-(st + nv) // m["page"]) for st, nv in
                     zip(starts, nvs) if nv > 0) * 4 + 2 * S * 4)
    flops = 4 * hd * Hq * pairs
    out["ragged_paged_attention"] = dict(
        ms=_time_ms(lambda: _ragged(c, True)),
        plain_ms=_time_ms(lambda: _ragged(c, False), runs=20),
        library_ms=_time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)),
        bytes=n_bytes, flops=flops,
    )

    lens = MAIN_LENGTHS
    dmask = (pos[None, :] < torch.tensor(lens, device="cuda")[:, None])
    dmask[:, 0] = True  # length-0 slot: keep SDPA finite (timing only)
    qd = c["q"][:, 0].contiguous()[:, :, None]  # [S, Hq, 1, hd]
    n_live = sum(1 for n in lens if n > 0)  # a length-0 slot reads no q
    n_bytes = ((n_live + S) * Hq * hd * elt + 2 * sum(lens) * Hkv * hd * elt
               + sum(-(-n // m["page"]) for n in lens) * 4 + S * 4)
    out["paged_attention"] = dict(
        ms=_time_ms(lambda: _decode(c, True)),
        plain_ms=_time_ms(lambda: _decode(c, False), runs=20),
        library_ms=_time_ms(lambda: sdpa(qd, kg, vg,
                                          attn_mask=dmask[:, None, None])),
        bytes=n_bytes, flops=4 * hd * Hq * sum(lens),
    )
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / PEAK_FLOPS[dtype] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"{name} (bf16, main-path shape): kernel_ms {r['ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']}: "
            f"{r['bytes']} B, {r['flops']} flop)")
    return out


# -- phase 4 -----------------------------------------------------------
def _teacher_forced_layers(cfg, params, cache, arrays) -> float:
    """Both attention paths through each layer from the SAME layer input
    (the plain path's output feeds the next layer): each layer's output
    and pages within rtol = atol = 2e-5. Returns the worst
    |diff| / (2e-5 + 2e-5 |plain|) ratio (<= 1 passes)."""
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
            kv = (cache.k[i].clone(), cache.v[i].clone())
            y, kv = paged._ragged_block(x, lp, cfg, cos, sin, kv, write_pg,
                                        write_off, bt, starts, nv, kernel)
            outs.append((y, kv))
        (yk, (kk, vk)), (yp, (kp, vp)) = outs
        # page 0 is scratch: padding rows race to write it, nothing reads it
        for a, b in ((yk, yp), (kk[1:], kp[1:]), (vk[1:], vp[1:])):
            d = (a - b).abs() / (2e-5 + 2e-5 * b.abs())
            worst = max(worst, float(d.max()))
        x = yp
    return worst


def step_parity() -> None:
    cfg = config_presets()["qwen3-0p6b"].with_(dtype=torch.float32)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    params = init_params(cfg, g, device=dev)
    S, C, page, max_len = 8, 128, 16, 2048
    base = PagedKVCache.init(cfg, S, page_size=page, max_len=max_len,
                             device=dev)
    n_pp = base.pages_per_slot
    rng = np.random.default_rng(7)
    perm = rng.permutation(np.arange(1, base.n_pages))[: S * n_pp]
    base.block_tables.copy_(torch.from_numpy(
        perm.reshape(S, n_pp).astype(np.int32)))
    # existing context: seeded random KV under every slot's pages
    gk = torch.Generator(device=dev)
    gk.manual_seed(99)
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
        trace = []
        for chunk in range(3):
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
                    cfg, 8, 1, kernel=kernel,
                )
            toks, n_tok = toks.cpu().numpy(), n_tok.cpu().numpy()
            lens = cache.lengths.cpu().tolist()
            for s in range(S):
                if n_tok[s]:
                    cur[s] = int(toks[s, n_tok[s] - 1])
            trace.append((toks.tolist(), n_tok.tolist(), lens,
                          int(n_exec)))
        return trace, cache

    rng_tok = rng.integers(0, V, size=S)
    first_block: list = []
    t0 = time.monotonic()
    trace_k, cache_k = run(True)
    trace_p, cache_p = run(False)
    blk0, starts0, nv0 = first_block
    if trace_k != trace_p:
        raise AssertionError(f"step parity: tokens/lengths differ\n"
                             f"kernel {trace_k}\nplain  {trace_p}")
    # (a) free running: per-layer differences add up over 28 layers; the
    # pages (scratch page 0 excluded) read 2.1-2.3x the per-layer bound
    # |a - b| <= 2e-5 + 2e-5 |b| on the H100, so they are held to
    # FREE_RUNNING_X times it
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
    # (b) teacher forced: every layer from the same input, rtol = atol =
    # 2e-5 on its output and its pages (the first chunk's mixed block)
    first = (torch.tensor(blk0, device=dev), torch.tensor(starts0, device=dev),
             torch.tensor(nv0, device=dev))
    tf_ratio = _teacher_forced_layers(cfg, params, base, first)
    if tf_ratio > 1.0:
        raise AssertionError(
            f"step parity: a layer's output or pages differ beyond rtol = "
            f"atol = 2e-5 ({tf_ratio:.2f}x the bound)"
        )
    log(f"step parity (qwen3-0p6b f32, 3 chunks, kernel vs plain): tokens, "
        f"n_tok, lengths equal; free-running pages max abs diff "
        f"{worst:.3e} ({ratio:.3f}x the per-layer 2e-5 bound over "
        f"{cfg.n_layers} layers, limit {FREE_RUNNING_X}x); teacher-forced "
        f"per layer "
        f"{tf_ratio:.3f}x the 2e-5 bound; {time.monotonic() - t0:.1f}s")
    del params, base, cache_k, cache_p
    torch.cuda.empty_cache()


# -- phase 5 -----------------------------------------------------------
def serving_phase() -> dict:
    cfg = config_presets()["qwen3-0p6b"]  # bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5678)
    params = init_params(cfg, g, device=dev)
    eng = GenerationEngine(cfg, params, max_seq_len=4096, device="cuda")
    b = ContinuousBatcher(engine=eng, max_slots=8, page_size=16,
                          chunk_steps=8, prefill_chunk=128,
                          prefix_cache=True, seed=0)
    cont = b.engine
    rng = np.random.default_rng(2024)
    V = cfg.vocab_size
    b.generate(rng.integers(0, V, 64).tolist(), max_new_tokens=8)  # warm-up
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
    results, ttft = {}, {}
    errors = []
    chunks0, skipped0 = cont.chunks, cont.stats["prefill_tokens_skipped"]
    att.reset_counts()

    def worker(t):
        try:
            for i in range(t, 16, 4):
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
    if any(t.is_alive() for t in threads) or len(results) != 16:
        raise AssertionError("serving: not every request finished")
    chunks = cont.chunks - chunks0
    launches = {"ragged_paged_attention": att.ragged_paged_attention.launches,
                "paged_attention": att.paged_attention.launches}
    plain_calls = att.ragged_paged_attention_ref.calls + \
        att.paged_attention_ref.calls
    for i, toks in results.items():
        if len(toks) != 64 or not all(0 <= t < V for t in toks):
            raise AssertionError(f"request {i}: bad output {len(toks)} tokens")
    L = cfg.n_layers
    if launches["ragged_paged_attention"] != L * chunks:
        raise AssertionError(f"ragged launches {launches} vs {chunks} chunks")
    if launches["paged_attention"] != L * (8 - 1) * chunks:
        raise AssertionError(f"decode launches {launches} vs {chunks} chunks")
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
    b.close()  # closes the engine, which checks page conservation again
    tt = sorted(ttft.values())
    gen_tokens = sum(len(t) for t in results.values())
    res = dict(
        requests=16, wall_s=wall, tokens_per_s=gen_tokens / wall,
        ttft_p50_s=tt[len(tt) // 2], ttft_p95_s=tt[int(0.95 * (len(tt) - 1))],
        chunks=chunks, launches=launches,
        prefill_tokens_skipped=skipped,
        prompt_tokens=sum(len(r[0]) for r in reqs),
        decode_steps=snap["decode_steps"],
    )
    log(f"serving (qwen3-0p6b bf16, 8 slots, 16 requests x 64 tokens): "
        f"{json.dumps(res)}")
    return res


def main() -> None:
    device_phase()
    build_phase()
    errs = kernel_checks()
    times = kernel_timings()
    step_parity()
    serving = serving_phase()
    kernels = []
    for name in ("ragged_paged_attention", "paged_attention"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tensorlink_tpu_torch/ops/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": serving["launches"][name],
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": "torch.nn.functional.scaled_dot_product_attention",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
