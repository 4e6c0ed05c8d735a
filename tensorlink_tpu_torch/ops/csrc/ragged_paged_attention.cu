// Ragged paged attention for Hopper (sm_90a): the unified prefill+decode
// step's attention, one call per layer per chunk; and, as its one-row
// launch, the decode continuation's paged attention, one call per layer
// per decode step.
//
// Replaces: tensorlink_tpu/ops/attention.py:ragged_paged_attention (the
// Pallas kernel _ragged_kernel; with quantized=True for int8 and packed
// int4 pages). Same function: query row r of a kv head is block position
// c = r / G and group member r % G; a row at starts[s] + c sees keys up to
// that position through the slot's block table; rows at or past
// n_valid[s] (and idle slots) write exact zeros; pages past a tile's last
// visible position are neither read nor computed.
//
// paged_prefill_attention (tensorlink_tpu/ops/attention.py, the Pallas
// kernel _paged_prefill_kernel) is a launch of this kernel with S = 1,
// starts = [start] and n_valid = [C], in all three formats.
// paged_attention (the same file, the Pallas kernel _paged_kernel) is its
// C = 1 launch through the second entry point, tl_paged_attention: each
// slot's one row at lengths[s] - 1, read from lengths inside the kernel.
// A decode row thus runs the body that computes the same position's row
// of a ragged launch, and the two agree bitwise (speculative decoding's
// verify rows == sequential decode rests on it).
//
// What bounds it on the card: for decode-heavy blocks the bytes of live
// K/V (plus 8 B of scales per live position and kv head when quantized);
// for prefill-heavy blocks the FLOPs of QK^T and PV (4 * hd per visible
// (row, key) pair), which the tensor cores serve.
//
// bf16 design (attend_bf16 + combine_bf16, here): two passes, flash-
// decoding style.
//  - attend: one block of 4 warps per (slot, tile of 64 query rows, split
//    of 512 key positions, kv head); in a wide tile each warp owns 16
//    rows. A prefill chunk of C rows reads each page C * G / 64 times per
//    kv head. A narrow tile, whose valid rows fit in 16 (every decode
//    tile, verify-style slots with C * G <= 16), puts all four warps on
//    each stage: S = Q K^T split by key columns (16 a warp), the row
//    maxima and P exchanged through shared memory, and O += P V split by
//    output columns (hd / 4 a warp). Keys are staged 64 positions at a
//    time, each position's row found through the block table (so any
//    page size works) and copied by 16-byte cp.async (8-byte for packed
//    int4 rows that are no multiple of 16) into a ring of 3 stages, two
//    in flight while one is computed, or of 2 where a third would leave
//    room for only one block an SM (fp pages at hd 128, every format at
//    256); a stage's copies are issued after the barrier that opens the
//    stage before, which frees their slot. fp pages land in XOR-swizzled
//    bf16 tiles; int8 and packed-int4 pages land as raw codes with their
//    f32 scales (4-byte cp.async) and are widened in shared memory into
//    one bf16 tile per stage (in a narrow tile each warp widens the K
//    rows and V columns it reads): the codes are exact in bf16.
//    S = Q K^T and O += P V run on tensor cores
//    (mma.sync m16n8k16, f32 accumulators); for quantized pages each
//    score column is multiplied by its position's K scale in f32, and
//    each position's V scale is folded into P's column before P rounds to
//    bf16, so no element carries a code x scale rounding. A wide tile
//    masks only stages that straddle a row's limit. The block writes its
//    valid rows' partial (m, l, unnormalised acc) to a workspace.
//  - combine: one block per 8 rows of a (slot, tile, kv head) (one for a
//    decode tile), one warp per row, merges the used splits' partials in
//    split order and writes acc / max(l, 1e-30) in bf16; invalid rows
//    write zeros.
// hd is any multiple of 16 up to 256, run at the next width of 16, 32,
// 64, 128 or 256 (dims past hd are zeros); the page size is free.
//
// Invariants the engine's bitwise contracts rest on (chunk-framing
// invariance of the prefix cache, greedy re-run alone == co-batched,
// generate_chunked == generate_compiled):
//  1. A row's output depends only on its own (slot, position) and that
//     slot's pages: never on other slots, the tile or chunk it was packed
//     into, or how many blocks run. Key stages and split boundaries sit at
//     absolute key positions (multiples of 64 and 512 from 0); the number
//     of splits follows the block table's width, never the traffic. A
//     stage or split past a row's limit is the identity for that row
//     (alpha 1, p 0; weight 0 in the combine), masked keys contribute
//     exact zeros, splits merge in a fixed order, and no atomics are used.
//  2. A product's result for one row never depends on other rows' values
//     (each mma output element is a sum over its own row of A).
//  3. Narrow and wide tiles give a row the same bits: each score, P and
//     output element is the same mma chain in the same k order, the row
//     max is exact, the softmax arithmetic uses rounding intrinsics the
//     compiler never fuses, and a narrow tile's l is summed from P in
//     shared memory over the columns and in the order a wide tile's
//     thread sums them.
//
// f32 design (paged_common.cuh, unchanged scalar body, for both entry
// points through a RaggedRows or DecodeRows policy): 16-row tiles, 16
// pages per block, pages dequantized into f32 shared tiles at the load,
// scalar f32 FMAs; hd a multiple of 32. Tensor cores would round f32 to
// TF32, and the f32 path serves the parity checks held at 2e-5.

#include "mma_common.cuh"
#include "paged_common.cuh"

namespace {

// The f32 scalar body's rows of a decode launch: the G query heads of a
// kv head at the slot's length - 1 (16 a tile), or none for length 0.
struct DecodeRows {
  const int* lengths;
  int Hq, G, hd;

  __device__ int setup(int s, int h, int tile, long long* row_off,
                       int* limit, int& n_rows) const {
    const int r0 = tile * tl::TILE_ROWS;
    n_rows = min(tl::TILE_ROWS, G - r0);
    const int len = lengths[s];
    for (int r = threadIdx.x; r < tl::TILE_ROWS; r += blockDim.x) {
      row_off[r] = ((long long)s * Hq + (long long)h * G + r0 + r) * hd;
      limit[r] = (r < n_rows && len > 0) ? len - 1 : -1;
    }
    return len > 0 ? len - 1 : -1;
  }
};

struct RaggedRows {
  const int* starts;
  const int* n_valid;
  int C, Hq, G, hd;

  __device__ int setup(int s, int h, int tile, long long* row_off,
                       int* limit, int& n_rows) const {
    const int R = C * G, r0 = tile * tl::TILE_ROWS;
    n_rows = min(tl::TILE_ROWS, R - r0);
    const int start = starts[s], nv = n_valid[s];
    for (int r = threadIdx.x; r < tl::TILE_ROWS; r += blockDim.x) {
      const int rr = r0 + r, c = rr / G, g = rr - c * G;
      row_off[r] = (((long long)s * C + c) * Hq + (long long)h * G + g) * hd;
      limit[r] = (r < n_rows && c < nv) ? start + c : -1;
    }
    // the tile's last visible position: its last valid row's own position
    const int c_last = min((r0 + n_rows - 1) / G, nv - 1);
    return (nv > 0 && r0 / G < nv) ? start + c_last : -1;
  }
};

// ---- bf16 ---------------------------------------------------------------

// A slot's rows in the bf16 body: its first query position and how many
// of its C rows are valid. A ragged launch reads starts / n_valid; a
// decode launch (C = 1) reads lengths, one valid row at length - 1 when
// the length is positive, so its wrapper builds no per-call tensors.
struct Slots {
  const int* starts;
  const int* n_valid;
  const int* lengths;  // non-null: a decode launch

  __device__ __forceinline__ void get(int s, int& start, int& nv) const {
    if (lengths != nullptr) {
      const int len = lengths[s];
      start = len > 0 ? len - 1 : 0;
      nv = len > 0 ? 1 : 0;
    } else {
      start = starts[s];
      nv = n_valid[s];
    }
  }
};

constexpr int BM = 64;            // query rows per tile
constexpr int KB = 64;            // key positions per stage
constexpr int SPLIT_KEYS = 512;   // key positions per split (8 stages)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NR = 16;          // rows of a narrow tile (one warp's)
static_assert(WARPS == 4, "a narrow tile merges four warps' row maxima");
constexpr int PF = KB + 8;      // f32 row stride of a narrow tile's P

// A tile is narrow when its valid rows fit in one warp's 16.
__device__ __forceinline__ bool narrow_rows(int rows) { return rows <= NR; }

template <int HD, int FMT>
struct RShape {
  static constexpr int CH = HD / 8;
  // bytes of one stage's K (or V) codes and scales
  static constexpr int RAW = FMT == tl::FMT_FP   ? KB * HD * 2
                             : FMT == tl::FMT_I8 ? KB * HD
                                                 : KB * HD / 2;
  static constexpr int SC = FMT == tl::FMT_FP ? 0 : KB * 4;
  static constexpr int STAGE = 2 * (RAW + SC);
  static constexpr int TILES = FMT == tl::FMT_FP ? 0 : 2 * KB * HD * 2;
  // a narrow tile's exchange: P in f32 and in bf16, and each warp's row
  // maxima
  static constexpr int NARROW = NR * PF * 4 + NR * KB * 2 + WARPS * NR * 4;
  static constexpr size_t BASE = (size_t)BM * HD * 2 + TILES + NARROW;
  // three stages where two blocks still fit an SM's 228 KB (less 1 KB a
  // block and the static page-id table), else two: at hd 128 fp pages
  // three stages left room for one block an SM, and two stages with two
  // blocks ran the main shape in 0.078 ms against 0.119 (H100)
  static constexpr int STAGES =
      2 * (BASE + 3 * (size_t)STAGE + 4 * (SPLIT_KEYS + 1) + 1024) <= 233472
          ? 3
          : 2;
  static constexpr size_t SMEM = BASE + (size_t)STAGES * STAGE;
  static constexpr bool Q_IN_REGS = HD <= 128;
};

// The tile's rows: the last visible key + 1 (0: no valid row).
__device__ __forceinline__ int tile_keys(int start, int nv, int R, int G,
                                         int r0, int n_keys_max) {
  if (nv <= 0 || r0 / G >= nv) return 0;
  const int c_last = min((min(r0 + BM, R) - 1) / G, nv - 1);
  return min(start + c_last + 1, n_keys_max);
}

__device__ __forceinline__ long long part_index(int s, int h, int tile,
                                                int split, int Hkv,
                                                int n_tiles, int n_splits) {
  return (((long long)s * Hkv + h) * n_tiles + tile) * n_splits + split;
}

// A code (|x| <= 128) as a float without a conversion instruction:
// 1.5 * 2^23 + x carries x in its low mantissa bits, so both steps are
// exact.
__device__ __forceinline__ float code_float(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.f;
}

// Eight codes (8 bytes of int8, or the low or high nibbles of 8 packed
// bytes) as one 16-byte chunk of bf16; exact. A float holding an integer
// of at most 8 significant bits has zeros in its low 16 bits, so its bf16
// is its upper half: a byte permute packs two, and no conversion
// instruction runs (sm_90 converts 16 results a clock per SM, a quarter
// of its integer adds).
template <int FMT>
__device__ __forceinline__ uint4 widen8(uint2 raw, bool high) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
  uint32_t w[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    int lo, hi;
    if constexpr (FMT == tl::FMT_I8) {
      lo = (signed char)b[2 * x];
      hi = (signed char)b[2 * x + 1];
    } else {
      const int s0 = high ? b[2 * x] >> 4 : b[2 * x];
      const int s1 = high ? b[2 * x + 1] >> 4 : b[2 * x + 1];
      lo = ((s0 & 0xF) ^ 8) - 8;
      hi = ((s1 & 0xF) ^ 8) - 8;
    }
    w[x] = __byte_perm(__float_as_uint(code_float(lo)),
                       __float_as_uint(code_float(hi)), 0x7632);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The online softmax's arithmetic, written with rounding intrinsics that
// the compiler never fuses or reorders: a row's rescale factor and
// probabilities (scores in the log2 domain) must come out the same bits in
// every tile shape that computes them.
__device__ __forceinline__ float row_alpha(float m_old, float m_new) {
  // a row with no visible key yet keeps m == NEG_INF; exp(0) there must
  // not enter the denominator. An unchanged max gives exactly 1, so a
  // stage that a row sees nothing of is the identity for it, computed or
  // skipped.
  if (m_old == tl::NEG_INF) return 0.f;
  return m_old == m_new ? 1.f
                        : tl::mma::exp2_fast(__fsub_rn(m_old, m_new));
}

__device__ __forceinline__ float prob(float x, float m_new) {
  return x == tl::NEG_INF ? 0.f : tl::mma::exp2_fast(__fsub_rn(x, m_new));
}

template <int HD, int FMT>
__global__ void __launch_bounds__(THREADS)
    attend_bf16(const __nv_bfloat16* __restrict__ q,
                const char* __restrict__ k_pages,
                const char* __restrict__ v_pages,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ block_tables, Slots slots,
                float* __restrict__ ws_acc,
                float* __restrict__ ws_ml, int C, int Hq, int Hkv, int hd,
                int page, int n_pp, int n_tiles, int n_splits, float scale) {
  using Sh = RShape<HD, FMT>;
  using namespace tl::mma;
  constexpr int CH = Sh::CH, NT = KB / 8, DT = HD / 8;
  constexpr bool QUANT = FMT != tl::FMT_FP;
  __shared__ int pids[SPLIT_KEYS + 1];
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + (size_t)BM * HD * 2;
  // quantized: the widened K and V tiles of the stage being computed
  __nv_bfloat16* kt_q =
      reinterpret_cast<__nv_bfloat16*>(ring + (size_t)Sh::STAGES * Sh::STAGE);
  __nv_bfloat16* vt_q = kt_q + KB * HD;
  // a narrow tile's P (f32 [NR][PF], and bf16 [NR][KB] swizzled as the PV
  // A operand) and row maxima [WARPS][NR]
  unsigned char* nar = ring + (size_t)Sh::STAGES * Sh::STAGE + Sh::TILES;
  float* pf = reinterpret_cast<float*>(nar);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(nar + NR * PF * 4);
  float* red = reinterpret_cast<float*>(nar + NR * PF * 4 + NR * KB * 2);

  const int split = blockIdx.x % n_splits;
  const int tile = (blockIdx.x / n_splits) % n_tiles;
  const int s = blockIdx.x / (n_splits * n_tiles), h = blockIdx.y;
  const int G = Hq / Hkv, R = C * G, r0 = tile * BM;
  int start, nv;
  slots.get(s, start, nv);
  const int n_keys = tile_keys(start, nv, R, G, r0, n_pp * page);
  const int kb_lo = split * SPLIT_KEYS;
  if (kb_lo >= n_keys) return;  // nothing visible in this split
  const int kb_hi = min(kb_lo + SPLIT_KEYS, n_keys);  // exclusive
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = FMT == tl::FMT_FP ? hd * 2 : (FMT == tl::FMT_I8 ? hd : hd / 2);
  const int hd_ch = hd / 8;
  // the tile's valid rows fit in one warp's 16 (every decode tile, and a
  // ragged slot with C * G <= 16): a narrow tile, whose four warps split
  // each key stage between them
  const bool narrow = narrow_rows(min(R, nv * G) - r0);

  // the split's page ids, from the first page it touches
  const int pg0 = kb_lo / page;
  const int n_pg = (kb_hi - 1) / page - pg0 + 1;
  const int* bt_row = block_tables + (long long)s * n_pp;
  for (int i = tid; i < n_pg; i += THREADS) pids[i] = bt_row[pg0 + i];
  // position pos's row of this kv head in the page pool (by shifts for a
  // power-of-two page)
  const int pshift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  auto page_row = [&](int pos) -> long long {
    const int pg = pshift >= 0 ? pos >> pshift : pos / page;
    return ((long long)pids[pg - pg0] * Hkv + h) * page + (pos - pg * page);
  };

  // Q tile (rows past R or n_valid are zeros; a narrow tile's first 16)
  for (int e = tid; e < (narrow ? NR : BM) * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    const int rr = r0 + r, cq = rr / G, g = rr - cq * G;
    const bool ok = rr < R && cq < nv && c < hd_ch;
    const __nv_bfloat16* src =
        ok ? q + (((long long)s * C + cq) * Hq + (long long)h * G + g) * hd +
                 c * 8
           : q;
    cp_async16(qs + tile_off<CH>(r, c), src, ok);
  }
  if constexpr (QUANT) {  // the widened tiles' padding dims stay zero
    for (int e = tid; e < 2 * KB * HD / 8; e += THREADS)
      reinterpret_cast<uint4*>(kt_q)[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();  // pids

  // one stage: key positions [k0, k0 + KB) of this (slot, kv head)
  auto load_stage = [&](int k0, int st) {
    unsigned char* base = ring + (size_t)st * Sh::STAGE;
    if constexpr (!QUANT) {
      for (int e = tid; e < 2 * KB * CH; e += THREADS) {
        const int which = e / (KB * CH), rem = e - which * KB * CH;
        const int j = rem / CH, c = rem - j * CH;
        const int pos = k0 + j;
        const bool ok = pos < kb_hi && c < hd_ch;
        const char* pages = which ? v_pages : k_pages;
        const char* src = ok ? pages + page_row(pos) * rb + c * 16 : pages;
        __nv_bfloat16* dst =
            reinterpret_cast<__nv_bfloat16*>(base + which * Sh::RAW);
        cp_async16(dst + tile_off<CH>(j, c), src, ok);
      }
    } else {
      // raw codes, row-major [KB][rb], in units that never cross a
      // position's row: 16 bytes, or 8 where the row is no multiple of 16
      // (packed int4 at hd % 32 == 16); so any page size works
      constexpr int RBM = FMT == tl::FMT_I8 ? HD : HD / 2;  // rb at hd HD
      if (RBM % 16 == 0 && rb == RBM) {  // units per row known here
        constexpr int UR = RBM % 16 == 0 ? RBM / 16 : 1;
        for (int e = tid; e < 2 * KB * UR; e += THREADS) {
          const int which = e / (KB * UR), rem = e - which * KB * UR;
          const int j = rem / UR, byte = rem * 16;
          const int pos = k0 + j;
          const bool ok = pos < kb_hi;
          const char* pages = which ? v_pages : k_pages;
          const char* src =
              ok ? pages + page_row(pos) * RBM + (byte - j * RBM) : pages;
          cp_async16(base + which * (Sh::RAW + Sh::SC) + byte, src, ok);
        }
      } else {
        const int ub = rb % 16 ? 8 : 16;
        const int units = KB * rb / ub;
        for (int e = tid; e < 2 * units; e += THREADS) {
          const int which = e / units, u = e - which * units;
          const int byte = u * ub, j = byte / rb, b = byte - j * rb;
          const int pos = k0 + j;
          const bool ok = pos < kb_hi;
          const char* pages = which ? v_pages : k_pages;
          const char* src = ok ? pages + page_row(pos) * rb + b : pages;
          unsigned char* dst = base + which * (Sh::RAW + Sh::SC) + byte;
          if (ub == 16)
            cp_async16(dst, src, ok);
          else
            cp_async8(dst, src, ok);
        }
      }
      for (int e = tid; e < 2 * KB; e += THREADS) {
        const int which = e / KB, j = e - which * KB;
        const int pos = k0 + j;
        const bool ok = pos < kb_hi;
        const float* sc = which ? v_scale : k_scale;
        cp_async4(base + which * (Sh::RAW + Sh::SC) + Sh::RAW + j * 4,
                  ok ? sc + page_row(pos) : sc, ok);
      }
    }
  };

  const int n_st = (kb_hi - kb_lo + KB - 1) / KB;
#pragma unroll
  for (int i = 0; i < Sh::STAGES - 1; ++i) {
    if (i < n_st) load_stage(kb_lo + i * KB, i);
    cp_async_commit();  // group i (group 0 also holds Q)
  }

  // this warp's rows (a narrow tile's 16 in every warp); the two this
  // thread holds in the C fragments
  const int rw = narrow ? 0 : 16 * warp, g4 = lane >> 2, tq = lane & 3;
  const int rw0 = r0 + rw;
  const bool warp_live = rw0 < R && rw0 / G < nv;
  const bool warp_full = rw0 + 15 < R && (rw0 + 15) / G < nv;
  const int lim_lo = start + rw0 / G;  // the warp's first row's limit
  const int lim_hi = start + min((min(rw0 + 15, R - 1)) / G, nv - 1);
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = rw0 + g4 + 8 * i, cq = rr / G;
    lim[i] = (rr < R && cq < nv) ? start + cq : -1;
  }

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[d][x] = 0.f;
  float m[2] = {tl::NEG_INF, tl::NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[Sh::Q_IN_REGS ? HD / 16 : 1][4];
  const float sl = scale * LOG2E;  // scores in the log2 domain

  for (int i = 0; i < n_st; ++i) {
    const int st = i % Sh::STAGES;
    cp_async_wait<Sh::STAGES - 2>();  // stage i (and Q) have landed
    // every thread's copies of stage i are visible, and every reader of
    // stage i - 1 is done: its slot takes stage i + STAGES - 1
    __syncthreads();
    const int nxt = i + Sh::STAGES - 1;
    if (nxt < n_st) load_stage(kb_lo + nxt * KB, nxt % Sh::STAGES);
    cp_async_commit();
    const unsigned char* base = ring + (size_t)st * Sh::STAGE;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (!QUANT) {
      ks = reinterpret_cast<const __nv_bfloat16*>(base);
      vs = reinterpret_cast<const __nv_bfloat16*>(base + Sh::RAW);
    } else {
      // widen this stage's codes into the bf16 tiles: output chunk c of
      // row j holds dims 8c..8c+7; int4 dims d < hd/2 are the low nibbles
      // of bytes d, dims d >= hd/2 the high nibbles of bytes d - hd/2
      auto widen = [&](int which, int j, int c) {
        if (c >= hd_ch) return;  // padding dims stay zero
        const unsigned char* raw = base + which * (Sh::RAW + Sh::SC);
        bool high = false;
        int b = c * 8;
        if constexpr (FMT == tl::FMT_I4) {
          high = b >= hd / 2;
          if (high) b -= hd / 2;
        }
        const uint2 u = *reinterpret_cast<const uint2*>(raw + j * rb + b);
        __nv_bfloat16* dst = which ? vt_q : kt_q;
        *reinterpret_cast<uint4*>(dst + tile_off<CH>(j, c)) =
            widen8<FMT>(u, high);
      };
      if (narrow) {
        // each warp widens what it reads: its 16 K rows, and V's chunks
        // of its output columns
        constexpr int VC = 2 * ((HD / 16 + WARPS - 1) / WARPS);
        for (int e = lane; e < NR * CH; e += 32)
          widen(0, 16 * warp + e / CH, e % CH);
        for (int e = lane; e < KB * VC; e += 32)
          widen(1, e / VC, warp * VC + e % VC);
        __syncwarp();
      } else {
        for (int e = tid; e < 2 * KB * CH; e += THREADS) {
          const int which = e / (KB * CH), rem = e - which * KB * CH;
          widen(which, rem / CH, rem % CH);
        }
        __syncthreads();
      }
      ksc = reinterpret_cast<const float*>(base + Sh::RAW);
      vsc = reinterpret_cast<const float*>(base + 2 * Sh::RAW + Sh::SC);
      ks = kt_q;
      vs = vt_q;
    }
    if constexpr (Sh::Q_IN_REGS) {
      if (i == 0) {
#pragma unroll
        for (int x = 0; x < HD / 16; ++x) load_a<CH>(qf[x], qs, rw, x, lane);
      }
    }
    const int k0 = kb_lo + i * KB;
    if (narrow) {
      // Each warp takes the 16 rows against its own 16 key columns (QK^T)
      // and the whole P against its own output columns (PV). A row comes
      // out with the same bits as in a wide tile: each score, P and output
      // element is the same mma chain in the same k order, the row max is
      // exact, and warp 0 sums l as a wide tile's thread does, over the
      // same 16 columns in the same order.
      constexpr int PAIRS = HD / 16, PW = (PAIRS + WARPS - 1) / WARPS;
      const int kc = 16 * warp;
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[n][x] = 0.f;
#pragma unroll
      for (int x = 0; x < HD / 16; ++x) {
        if (x * 2 >= hd_ch) break;  // zero dims past hd
        uint32_t a[4];
        if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
          for (int y = 0; y < 4; ++y) a[y] = qf[x][y];
        } else {
          load_a<CH>(a, qs, 0, x, lane);
        }
        uint32_t bb[4];
        load_b_rows<CH>(bb, ks, kc, x, lane);
        mma_bf16(sc[0], a, bb[0], bb[1]);
        mma_bf16(sc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = tl::NEG_INF;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = kc + n * 8 + 2 * tq + e;
            float x = sc[n][2 * r + e];
            if constexpr (QUANT) x = __fmul_rn(x, ksc[j]);
            x = __fmul_rn(x, sl);
            if (k0 + j > lim[r]) x = tl::NEG_INF;
            sc[n][2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (tq == 0) red[warp * NR + g4 + 8 * r] = mx;
      }
      __syncthreads();  // every warp's row maxima
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g4 + 8 * r;
        const float mx = fmaxf(fmaxf(red[row], red[NR + row]),
                               fmaxf(red[2 * NR + row], red[3 * NR + row]));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = row_alpha(m[r], m_new);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = kc + n * 8 + 2 * tq;
          float p0 = prob(sc[n][2 * r], m_new);
          float p1 = prob(sc[n][2 * r + 1], m_new);
          *reinterpret_cast<float2*>(pf + row * PF + col) =
              make_float2(p0, p1);
          if constexpr (QUANT) {
            p0 = __fmul_rn(p0, vsc[col]);
            p1 = __fmul_rn(p1, vsc[col + 1]);
          }
          *reinterpret_cast<uint32_t*>(ps + tile_off<KB / 8>(row, col >> 3) +
                                       (col & 7)) = pack_bf16(p0, p1);
        }
        m[r] = m_new;
      }
      __syncthreads();  // the whole P
      if (warp == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* pr = pf + (g4 + 8 * r) * PF + 2 * tq;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 p = *reinterpret_cast<const float2*>(pr + n * 8);
            sum = __fadd_rn(sum, p.x);
            sum = __fadd_rn(sum, p.y);
          }
          l[r] = __fmaf_rn(l[r], alpha[r], sum);
        }
      }
#pragma unroll
      for (int d = 0; d < 2 * PW; ++d) {
        o[d][0] *= alpha[0];
        o[d][1] *= alpha[0];
        o[d][2] *= alpha[1];
        o[d][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t a[4];
        load_a<KB / 8>(a, ps, 0, kk, lane);
#pragma unroll
        for (int x = 0; x < PW; ++x) {
          const int dp = warp * PW + x;
          if (dp >= PAIRS || dp * 2 >= hd_ch) break;
          uint32_t bb[4];
          load_b_trans<CH>(bb, vs, kk * 16, dp, lane);
          mma_bf16(o[2 * x], a, bb[0], bb[1]);
          mma_bf16(o[2 * x + 1], a, bb[2], bb[3]);
        }
      }
    } else if (warp_live && k0 <= lim_hi) {
      // a wide tile's warp whose rows see none of this stage's keys skips
      // it: for its rows that is the identity (alpha 1, p 0)
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[n][x] = 0.f;
#pragma unroll
      for (int x = 0; x < HD / 16; ++x) {
        if (x * 2 >= hd_ch) break;  // zero dims past hd
        uint32_t a[4];
        if constexpr (Sh::Q_IN_REGS) {
#pragma unroll
          for (int y = 0; y < 4; ++y) a[y] = qf[x][y];
        } else {
          load_a<CH>(a, qs, rw, x, lane);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          load_b_rows<CH>(bb, ks, np * 16, x, lane);
          mma_bf16(sc[2 * np], a, bb[0], bb[1]);
          mma_bf16(sc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      const bool masked = !warp_full || k0 + KB - 1 > lim_lo;
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = tl::NEG_INF;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = n * 8 + 2 * tq + e;
            float x = sc[n][2 * r + e];
            if constexpr (QUANT) x = __fmul_rn(x, ksc[j]);
            x = __fmul_rn(x, sl);
            if (masked && k0 + j > lim[r]) x = tl::NEG_INF;
            sc[n][2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = row_alpha(m[r], m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = prob(sc[n][2 * r + e], m_new);
            sum = __fadd_rn(sum, p);
            if constexpr (QUANT) p = __fmul_rn(p, vsc[n * 8 + 2 * tq + e]);
            sc[n][2 * r + e] = p;
          }
        l[r] = __fmaf_rn(l[r], alpha[r], sum);
        m[r] = m_new;
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= alpha[0];
        o[d][1] *= alpha[0];
        o[d][2] *= alpha[1];
        o[d][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          if (dp * 2 >= hd_ch) break;
          uint32_t bb[4];
          load_b_trans<CH>(bb, vs, kk * 16, dp, lane);
          mma_bf16(o[2 * dp], a, bb[0], bb[1]);
          mma_bf16(o[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the valid rows' partials: [BM][hd] accumulators, [BM][2] (m, l)
  const long long part = part_index(s, h, tile, split, Hkv, n_tiles, n_splits);
  float* pa = ws_acc + part * BM * hd;
  float* pml = ws_ml + part * BM * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (lim[r] < 0) continue;
    const int row = rw + g4 + 8 * r;
    if (narrow) {  // this warp's output columns; warp 0 holds (m, l)
      constexpr int PAIRS = HD / 16, PW = (PAIRS + WARPS - 1) / WARPS;
#pragma unroll
      for (int d = 0; d < 2 * PW; ++d) {
        const int col = (2 * warp * PW + d) * 8 + 2 * tq;
        if (col >= min(hd, PAIRS * 16)) break;
        *reinterpret_cast<float2*>(pa + row * hd + col) =
            make_float2(o[d][2 * r], o[d][2 * r + 1]);
      }
    } else {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = d * 8 + 2 * tq;
        if (col >= hd) break;
        *reinterpret_cast<float2*>(pa + row * hd + col) =
            make_float2(o[d][2 * r], o[d][2 * r + 1]);
      }
    }
    if (tq == 0 && (!narrow || warp == 0)) {
      pml[2 * row] = m[r];
      pml[2 * row + 1] = lt;
    }
  }
}

// One warp per row, lanes over head dims (up to 8 each), a block per 8
// rows of a tile (n_groups blocks cover a tile's min(BM, C * G) rows: one
// for a decode tile's G <= 8): the used splits' (m, l) are read one split
// a lane and shared by shuffles, and merged in split order, so all lanes
// hold the same weights and denominator. (A warp that walked several rows
// one after another waited on each row's loads in turn; one that read the
// splits one after another, on each split's.)
constexpr int COMBINE_WARPS = 8;

__global__ void __launch_bounds__(32 * COMBINE_WARPS)
    combine_bf16(__nv_bfloat16* __restrict__ out, Slots slots,
                 const float* __restrict__ ws_acc,
                 const float* __restrict__ ws_ml, int C, int Hq, int Hkv,
                 int hd, int page, int n_pp, int n_tiles, int n_splits,
                 int n_groups) {
  const int st = blockIdx.x / n_groups;
  const int s = st / n_tiles, tile = st % n_tiles;
  const int h = blockIdx.y;
  const int G = Hq / Hkv, R = C * G, r0 = tile * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = (blockIdx.x % n_groups) * COMBINE_WARPS + warp;
  if (r >= min(BM, R - r0)) return;
  int start, nv;
  slots.get(s, start, nv);
  const int n_keys = tile_keys(start, nv, R, G, r0, n_pp * page);
  const int n_used = (n_keys + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const long long part0 = part_index(s, h, tile, 0, Hkv, n_tiles, n_splits);
  {
    const int rr = r0 + r, cq = rr / G, g = rr - cq * G;
    __nv_bfloat16* o =
        out + (((long long)s * C + cq) * Hq + (long long)h * G + g) * hd;
    if (cq >= nv) {  // rows past n_valid: exact zeros
      for (int d = lane; d < hd; d += 32) o[d] = __float2bfloat16(0.f);
      return;
    }
    // split sp's (m, l) at ml[sp * BM * 2], its accumulators at
    // acc[sp * BM * hd]
    const float* ml = ws_ml + part0 * BM * 2 + 2 * r;
    const float* acc = ws_acc + part0 * BM * hd + (long long)r * hd;
    // the max over splits is exact in any order: lanes read the splits'
    // maxima at once
    float m_max = tl::NEG_INF;
    for (int sp = lane; sp < n_used; sp += 32)
      m_max = fmaxf(m_max, ml[(long long)sp * BM * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, off));
    // the sums run in split order: 32 splits at a time, lane k holding
    // split sp0 + k's weight and l, their accumulators read SB splits at a
    // time before any of them is summed
    constexpr int SB = 4;
    float den = 0.f, num[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) num[x] = 0.f;
    for (int sp0 = 0; sp0 < n_used; sp0 += 32) {
      const int n = min(32, n_used - sp0);
      float w_l = 0.f, l_l = 0.f;
      if (lane < n) {
        const float* p = ml + (long long)(sp0 + lane) * BM * 2;
        w_l = tl::mma::exp2_fast(__fsub_rn(p[0], m_max));
        l_l = p[1];
      }
      for (int k0 = 0; k0 < n; k0 += SB) {
        float v[SB][8];
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const float* a = acc + (long long)(sp0 + k0 + u) * BM * hd;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int d = lane + 32 * x;
            v[u][x] = (k0 + u < n && d < hd) ? a[d] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          if (k0 + u >= n) break;
          const float w = __shfl_sync(0xffffffffu, w_l, k0 + u);
          den = fmaf(__shfl_sync(0xffffffffu, l_l, k0 + u), w, den);
#pragma unroll
          for (int x = 0; x < 8; ++x) num[x] = fmaf(v[u][x], w, num[x]);
        }
      }
    }
    const float dd = fmaxf(den, 1e-30f);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int d = lane + 32 * x;
      if (d < hd) o[d] = __float2bfloat16(num[x] / dd);
    }
  }
}

template <int HD, int FMT>
cudaError_t launch_bf16_fmt(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* bt, Slots slots, void* out,
                            void* ws_acc, void* ws_ml, int S, int C, int Hq,
                            int Hkv, int hd, int page, int n_pp, float scale,
                            cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_tiles = (C * G + BM - 1) / BM;
  const int n_splits = (n_pp * page + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const int rows = C * G < BM ? C * G : BM;  // a tile's rows
  const int n_groups = (rows + COMBINE_WARPS - 1) / COMBINE_WARPS;
  using Sh = RShape<HD, FMT>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = tl::mma::smem_limit_once(attend_bf16<HD, FMT>,
                                             (int)Sh::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  attend_bf16<HD, FMT><<<dim3(S * n_tiles * n_splits, Hkv), THREADS,
                         Sh::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const char*)k, (const char*)v,
      (const float*)k_scale, (const float*)v_scale, (const int*)bt, slots,
      (float*)ws_acc, (float*)ws_ml, C, Hq, Hkv, hd, page, n_pp, n_tiles,
      n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_bf16<<<dim3(S * n_tiles * n_groups, Hkv), 32 * COMBINE_WARPS, 0,
                 stream>>>((__nv_bfloat16*)out, slots, (const float*)ws_acc,
                           (const float*)ws_ml, C, Hq, Hkv, hd, page, n_pp,
                           n_tiles, n_splits, n_groups);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_bf16_hd(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* bt, Slots slots, void* out,
                           void* ws_acc, void* ws_ml, int S, int C, int Hq,
                           int Hkv, int hd, int page, int n_pp, float scale,
                           cudaStream_t stream) {
#define TL_RAGGED_BF16(HD)                                                 \
  return launch_bf16_fmt<HD, FMT>(q, k, v, k_scale, v_scale, bt, slots,   \
                                  out, ws_acc, ws_ml, S, C, Hq, Hkv, hd,  \
                                  page, n_pp, scale, stream)
  if (hd <= 16) TL_RAGGED_BF16(16);
  if (hd <= 32) TL_RAGGED_BF16(32);
  if (hd <= 64) TL_RAGGED_BF16(64);
  if (hd <= 128) TL_RAGGED_BF16(128);
  TL_RAGGED_BF16(256);
#undef TL_RAGGED_BF16
}

// Any page size: every copy addresses one position's row through the
// block table.
bool bf16_shape_ok(int Hq, int Hkv, int hd, int page) {
  return Hkv > 0 && Hq % Hkv == 0 && hd > 0 && hd % 16 == 0 && hd <= 256 &&
         page > 0;
}

// Both entry points: bf16 q runs the tensor-core body over `slots` (C
// rows a slot), f32 q the scalar body over `rows` (a RaggedRows or
// DecodeRows policy, C * G rows a slot in 16-row tiles).
template <typename Rows>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* block_tables,
           Slots slots, Rows rows, void* out, void* ws_acc, void* ws_ml,
           int dtype, int kv_format, int S, int C, int Hq, int Hkv, int hd,
           int page, int n_pp, float scale, void* stream) {
  if (S <= 0 || C <= 0 || n_pp <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (kv_format != tl::FMT_FP && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (!bf16_shape_ok(Hq, Hkv, hd, page))
      return (int)cudaErrorInvalidValue;
#define TL_RAGGED_FMT(F)                                                   \
  return (int)launch_bf16_hd<F>(q, k_pages, v_pages, k_scale, v_scale,    \
                                block_tables, slots, out, ws_acc, ws_ml,  \
                                S, C, Hq, Hkv, hd, page, n_pp, scale, st)
    if (kv_format == tl::FMT_FP) TL_RAGGED_FMT(tl::FMT_FP);
    if (kv_format == tl::FMT_I8) TL_RAGGED_FMT(tl::FMT_I8);
    if (kv_format == tl::FMT_I4) TL_RAGGED_FMT(tl::FMT_I4);
#undef TL_RAGGED_FMT
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 || !tl::shape_ok(Hq, Hkv, hd, page))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (C * (Hq / Hkv) + tl::TILE_ROWS - 1) / tl::TILE_ROWS;
#define TL_RAGGED_F32(F)                                                   \
  return (int)tl::launch_two_pass<float, F, Rows>(                        \
      q, k_pages, v_pages, k_scale, v_scale, block_tables, rows, out,     \
      (float*)ws_acc, (float*)ws_ml, S, Hkv, hd, page, n_pp, n_tiles,     \
      scale, st)
  if (kv_format == tl::FMT_FP) TL_RAGGED_F32(tl::FMT_FP);
  if (kv_format == tl::FMT_I8) TL_RAGGED_F32(tl::FMT_I8);
  if (kv_format == tl::FMT_I4) TL_RAGGED_F32(tl::FMT_I4);
#undef TL_RAGGED_F32
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and fp pages). kv_format: 0
// = pages in q's dtype [P, Hkv, page, hd] (scales null), 1 = int8
// [P, Hkv, page, hd], 2 = packed int4 [P, Hkv, page, hd/2], both with f32
// k_scale / v_scale [P, Hkv, page]. q/out [S, C, Hq, hd]; block_tables
// int32 [S, n_pp]; starts, n_valid int32 [S]; all contiguous on the
// current device. ws_acc / ws_ml: f32 workspaces of
// S * Hkv * n_tiles * n_splits partials of TILE x hd and TILE x 2 floats:
// float32 TILE 16, n_tiles = ceil(C*G/16), n_splits = ceil(n_pp/16);
// bfloat16 TILE 64, n_tiles = ceil(C*G/64), n_splits =
// ceil(n_pp*page/512). Returns a cudaError_t.
extern "C" int tl_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* starts, const void* n_valid, void* out, void* ws_acc,
    void* ws_ml, int dtype, int kv_format, int S, int C, int Hq, int Hkv,
    int hd, int page, int n_pp, float scale, void* stream) {
  if (Hkv <= 0) return (int)cudaErrorInvalidValue;
  const Slots slots{(const int*)starts, (const int*)n_valid, nullptr};
  const RaggedRows rows{(const int*)starts, (const int*)n_valid, C, Hq,
                        Hq / Hkv, hd};
  return launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, slots,
                rows, out, ws_acc, ws_ml, dtype, kv_format, S, C, Hq, Hkv,
                hd, page, n_pp, scale, stream);
}

// paged_attention (tensorlink_tpu/ops/attention.py:paged_attention, the
// Pallas kernel _paged_kernel): one query per slot, slot s attending
// positions < lengths[s] through its block table; a length-0 slot writes
// zeros and reads no page. It is this kernel's C = 1 launch, each slot's
// row at lengths[s] - 1 (valid when the length is positive), so a decode
// row and the same position's row of a ragged launch run one body.
// q/out [S, Hq, hd]; lengths int32 [S]; workspaces as above with C = 1.
// The other arguments as tl_ragged_paged_attention's.
extern "C" int tl_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale,
                                  const void* block_tables,
                                  const void* lengths, void* out,
                                  void* ws_acc, void* ws_ml, int dtype,
                                  int kv_format, int S, int Hq, int Hkv,
                                  int hd, int page, int n_pp, float scale,
                                  void* stream) {
  if (Hkv <= 0) return (int)cudaErrorInvalidValue;
  const Slots slots{nullptr, nullptr, (const int*)lengths};
  const DecodeRows rows{(const int*)lengths, Hq, Hq / Hkv, hd};
  return launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, slots,
                rows, out, ws_acc, ws_ml, dtype, kv_format, S, 1, Hq, Hkv,
                hd, page, n_pp, scale, stream);
}
