// Flash attention for Hopper (sm_90a): causal offset-0 attention over
// dense [B, T, H, hd] tensors, the dense engine's fresh-cache prefill.
//
// Replaces: tensorlink_tpu/ops/attention.py:flash_attention (the Pallas
// kernel _flash_kernel). Same function: query i of a sequence sees keys
// j <= i, and with a sliding window also j > i - window; scores, softmax
// and PV accumulated in f32 with the Pallas kernel's online-softmax
// recurrence and guards (a row that has seen no key keeps m = NEG_INF and
// alpha = 0; the denominator is floored at 1e-30); the output rounds once
// to q's dtype. In bf16 the probabilities enter the PV product as bf16.
// GQA: query head h reads kv head h / G, and no kv head is repeated in
// memory.
//
// What bounds it on the card: at the engine's prefill shapes it is bound
// by operations (4 * hd FLOPs per visible (query head, key) pair against
// 2 * hd bytes of K/V per key and kv head), which Hopper serves from its
// tensor cores.
//
// On the TPU the grid's innermost k axis ran in order and carried the
// running max, denominator and accumulator in VMEM from step to step;
// here that carried state lives in registers and a loop over key tiles
// runs inside the block, from the first tile the window can reach to
// the causal diagonal. Key tiles start at multiples of the tile width
// from key 0, so a row's sums never depend on the tile it was packed in.
//
// bf16 design (flash_bf16_kernel): one block of 2 warpgroups per (128
// query rows, kv head, batch row); row i is position i / G of query head
// hk * G + i % G, so each K/V tile is loaded once for the G heads that
// share it. Each warpgroup owns 64 rows. S = Q K^T and O += P V run on Hopper's warpgroup tensor-core product
// (wgmma m64nNk16, f32 accumulators in registers): Q and K are read from
// shared memory through matrix descriptors, P is rounded to bf16 in
// registers and is the A operand of the PV product as it stands, V is
// read from shared memory as an MN-major operand. K and V tiles of 64
// keys arrive through a 2-stage ring of 16-byte cp.async copies from the
// tensors in place, through their batch and token strides, into
// 128-byte-swizzled tiles: the next tile is in flight while the current
// one is computed. At hd <= 128 two blocks share an SM (each held to 128
// registers a thread), so one block's softmax runs beside the other's
// products; at hd 256, where O alone takes 128 registers, one block.
// The softmax takes the row max over raw scores and forms each
// probability with one FFMA and one exp2. A warpgroup skips a tile none
// of its rows can see, and masks only a tile that straddles the
// diagonal, the window's edge or T. Blocks are launched with the q tiles
// that reach the most keys first. Rows and keys past T, and head dims
// past hd (hd is any multiple of 16 up to 256, run at the next width of
// 64, 128 or 256), load as zeros. The online softmax keeps the Pallas
// kernel's guards in f32. ptxas must report no wgmma serialization
// (C7515): registers a wgmma reads or writes are pinned (fence_regs)
// around each issue.
//
// f32 design (flash_kernel, unchanged scalar body): one block per (64
// query rows, query head, batch row), 32-key tiles staged as f32, scalar
// f32 FMAs; hd a multiple of 32. Tensor cores would round f32 operands to
// TF32, and the f32 path serves the parity checks held at 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the JAX kernel's masking value
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile
constexpr int ROWS = 4;            // query rows per thread
constexpr int GROUPS = BQ / ROWS;  // row groups per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
struct Shape {
  static constexpr int TX = HD > 128 ? 16 : 8;  // lanes per row group
  static constexpr int THREADS = GROUPS * TX;   // 128 or 256
  static constexpr int NJ = BK / TX;            // keys per thread per tile
  static constexpr int ND = HD / TX;            // head dims per thread
  static constexpr int QP = HD + 1;             // padded q and K row pitch
  static constexpr int PP = BK + 1;             // padded probability pitch
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * QP + (size_t)BK * QP + (size_t)BK * HD +
                       (size_t)BQ * PP);
};

// Rows [0, n_rows) of `src` (row r at src + r * stride) into shared memory
// as f32 at `pitch` floats per row; rows at or past n_valid are zeros. HD
// is a multiple of 32, so a 16-byte vector never crosses a row.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          long long stride, int n_valid,
                                          int n_rows, float* dst, int pitch,
                                          int nthreads) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int i = threadIdx.x; i < n_rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i - r * VPR) * VEC;
    float* d = dst + r * pitch + c;
    if (r < n_valid) {
      const uint4 u =
          __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < VEC; ++x) d[x] = to_f32(t[x]);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) d[x] = 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int T_len,
                 int Hq, int G, long long q_sb, long long q_st,
                 long long k_sb, long long k_st, long long v_sb,
                 long long v_st, int window, float scale) {
  using S = Shape<HD>;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][QP] query tile
  float* ks = qs + BQ * S::QP;   // [BK][QP] key tile
  float* vs = ks + BK * S::QP;   // [BK][HD] value tile
  float* ps = vs + BK * HD;      // [BQ][PP] the tile's probabilities
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int ty = tid / S::TX, tx = tid - ty * S::TX;
  const int n_q = min(BQ, T_len - q0);
  const T* kb = k + b * k_sb + (long long)hk * HD;
  const T* vb = v + b * v_sb + (long long)hk * HD;
  load_rows<T, HD>(q + b * q_sb + (long long)q0 * q_st + (long long)h * HD,
                   q_st, n_q, BQ, qs, S::QP, S::THREADS);

  float m[ROWS], l[ROWS], acc[ROWS][S::ND];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < S::ND; ++jd) acc[i][jd] = 0.f;
  }

  const int last = q0 + n_q - 1;  // the tile's last row: the causal reach
  int k_begin = 0;
  if (window > 0) {  // the first key the tile's first row can see
    k_begin = max(0, q0 - window + 1);
    k_begin -= k_begin % BK;
  }
  for (int k0 = k_begin; k0 <= last; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int n_k = min(BK, T_len - k0);
    load_rows<T, HD>(kb + (long long)k0 * k_st, k_st, n_k, BK, ks, S::QP,
                     S::THREADS);
    load_rows<T, HD>(vb + (long long)k0 * v_st, v_st, n_k, BK, vs, HD,
                     S::THREADS);
    __syncthreads();

    float s[ROWS][S::NJ];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kv[S::NJ];
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) kv[j] = ks[(tx + S::TX * j) * S::QP + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = qs[(ty * ROWS + i) * S::QP + d];
#pragma unroll
        for (int j = 0; j < S::NJ; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

    // online softmax: the TX lanes of a row group hold a row's keys
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = q0 + ty * ROWS + i;
      bool ok[S::NJ];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) {
        const int c = k0 + tx + S::TX * j;
        ok[j] = c <= r && c < T_len && (window <= 0 || c > r - window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = S::TX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key yet keeps m == NEG_INF; exp(0) there
      // must not enter the denominator
      const float alpha = m[i] == NEG_INF ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * ROWS + i) * S::PP + tx + S::TX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = S::TX / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < S::ND; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();  // the tile's probabilities are visible

    for (int c = 0; c < BK; ++c) {
      float p[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) p[i] = ps[(ty * ROWS + i) * S::PP + c];
#pragma unroll
      for (int jd = 0; jd < S::ND; ++jd) {
        const float vv = vs[c * HD + tx + S::TX * jd];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][jd] = fmaf(p[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty * ROWS + i;
    if (r >= T_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * T_len + r) * Hq + h) * HD;
#pragma unroll
    for (int jd = 0; jd < S::ND; ++jd)
      o[tx + S::TX * jd] = from_f32<T>(acc[i][jd] / den);
  }
}

// ---- bf16: warpgroup tensor-core tiles fed by a cp.async ring ---------
//
// One block per (tile of BM rows, kv head, batch row); row i of a
// (batch row, kv head) is position i / G and query head hk * G + i % G,
// so one K/V tile serves all G heads of the kv head. Each warpgroup (4
// warps) owns 64 rows. HD is the head_dim rounded up to 64, 128 or 256;
// dims past hd load as zeros and are not written.
template <int HD>
struct Bf16Shape {
  static constexpr int WG = 2;          // warpgroups
  static constexpr int BM = 64 * WG;    // rows per block
  static constexpr int BK = 64;         // keys per tile
  static constexpr int CH = HD / 8;     // 16-byte chunks per row
  static constexpr int THREADS = 128 * WG;
  static constexpr int STAGES = 2;
  // two blocks an SM (128 registers a thread) where O fits: one block's
  // softmax then overlaps the other's products
  static constexpr int BLOCKS_PER_SM = HD > 128 ? 1 : 2;
  // + 1024: the swizzled tiles start 1024-byte aligned
  static constexpr size_t SMEM =
      1024 + sizeof(__nv_bfloat16) *
                 ((size_t)BM * HD + (size_t)STAGES * 2 * BK * HD);
};

constexpr float LOG2E = 1.4426950408889634f;

// Pins registers that an asynchronous wgmma reads or writes: the
// compiler may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int HD>
__global__ void __launch_bounds__(Bf16Shape<HD>::THREADS,
                                  Bf16Shape<HD>::BLOCKS_PER_SM)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int T_len, int Hq,
                      int G, int hd, long long q_sb, long long q_st,
                      long long k_sb, long long k_st, long long v_sb,
                      long long v_st, int window, float scale, int n_tiles) {
  using S = Bf16Shape<HD>;
  using namespace tl::mma;
  constexpr int BM = S::BM, BK = S::BK, CH = S::CH;
  constexpr int NS = BK / 2;  // S accumulators per thread
  constexpr int NO = HD / 2;  // O accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* kv0 = qs + BM * HD;  // STAGES x (K tile, V tile)

  const int Hkv = Hq / G;
  const int h_kv = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int tile = n_tiles - 1 - blockIdx.y;  // most keys first
  const int i0 = tile * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd_ch = hd / 8;  // chunks holding data

  // Q tile: row r is position (i0 + r) / G, head h_kv * G + (i0 + r) % G
  for (int e = tid; e < BM * CH; e += S::THREADS) {
    const int r = e / CH, c = e - r * CH;
    const int i = i0 + r, t = i / G, gh = i - t * G;
    const bool ok = t < T_len && c < hd_ch;
    const __nv_bfloat16* src =
        ok ? q + b * q_sb + (long long)t * q_st +
                 ((long long)h_kv * G + gh) * hd + c * 8
           : q;
    cp_async16(qs + sw128_off<BM>(r, c), src, ok);
  }

  const int t_min = i0 / G;
  const int t_max = min((i0 + BM - 1) / G, T_len - 1);
  int k_first = 0;
  if (window > 0) k_first = max(0, t_min - window + 1);
  const int kt_lo = k_first / BK, kt_hi = t_max / BK;

  const __nv_bfloat16* kb = k + b * k_sb + (long long)h_kv * hd;
  const __nv_bfloat16* vb = v + b * v_sb + (long long)h_kv * hd;
  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* ks = kv0 + stage * 2 * BK * HD;
    __nv_bfloat16* vs = ks + BK * HD;
    const int k0 = kt * BK;
    for (int e = tid; e < 2 * BK * CH; e += S::THREADS) {
      const int which = e / (BK * CH), rem = e - which * BK * CH;
      const int j = rem / CH, c = rem - j * CH;
      const int key = k0 + j;
      const bool ok = key < T_len && c < hd_ch;
      const __nv_bfloat16* base_kv = which ? vb : kb;
      const long long st = which ? v_st : k_st;
      const __nv_bfloat16* src = ok ? base_kv + key * st + c * 8 : base_kv;
      cp_async16((which ? vs : ks) + sw128_off<BK>(j, c), src, ok);
    }
  };
  const int n_kt = kt_hi - kt_lo + 1;
#pragma unroll
  for (int i = 0; i < S::STAGES - 1; ++i) {
    if (i < n_kt) load_kv(kt_lo + i, i);
    cp_async_commit();  // group i (group 0 also holds Q)
  }

  // this warpgroup's 64 rows; the two rows this thread holds
  const int rg = 64 * (warp >> 2), rw = rg + 16 * (warp & 3);
  const int tg_lo = (i0 + rg) / G, tg_hi = (i0 + rg + 63) / G;
  const bool wg_live = tg_lo < T_len;
  const int g = lane >> 2, tq = lane & 3;
  const int tr[2] = {(i0 + rw + g) / G, (i0 + rw + g + 8) / G};

  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl = scale * LOG2E;  // scores in the log2 domain

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int i = kt - kt_lo, stage = i % S::STAGES;
    const int nxt = i + S::STAGES - 1;
    if (nxt < n_kt) load_kv(kt_lo + nxt, nxt % S::STAGES);
    cp_async_commit();
    cp_async_wait<S::STAGES - 1>();  // this tile (and Q) have landed
    fence_proxy_async();             // visible to wgmma's reads
    __syncthreads();
    const __nv_bfloat16* ks = kv0 + stage * 2 * BK * HD;
    const __nv_bfloat16* vs = ks + BK * HD;
    const int k0 = kt * BK;
    // a warpgroup whose rows see none of this tile's keys skips it: for
    // its rows that is the identity (alpha 1, p 0)
    const bool skip = !wg_live || k0 > tg_hi ||
                      (window > 0 && k0 + BK - 1 <= tg_lo - window);
    if (!skip) {
      // S = Q K^T: 64 x 64 per warpgroup, depth 16 per instruction
      float s[NS];
#pragma unroll
      for (int x = 0; x < NS; ++x) s[x] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < HD / 16; ++x) {  // dims past hd are zeros
        // depth 16x..16x+15: column block x / 4, 32 bytes x % 4 into it
        const int blk = x >> 2, off = (x & 3) * 16;
        wgmma_ss_n64(
            s, sw128_desc(qs + blk * BM * 64 + rg * 64 + off, 16, 1024),
            sw128_desc(ks + blk * BK * 64 + off, 16, 1024), x > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // masking only where a row of this warpgroup misses a key
      const bool masked = k0 + BK - 1 > tg_lo ||
                          (window > 0 && k0 <= tg_hi - window);
      // the row max is taken over the raw scores (scaling by sl > 0 keeps
      // the order and commutes with rounding); p = 2^(s sl - m) is one
      // FFMA and one exp2 per score, masked or not
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * n + 2 * r + e];
            if (masked) {
              const int c = k0 + n * 8 + 2 * tq + e;
              const bool ok = c <= tr[r] && c < T_len &&
                              (window <= 0 || c > tr[r] - window);
              x = ok ? x : -INFINITY;
              s[4 * n + 2 * r + e] = x;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * sl);
        // a row with no visible key yet keeps m == NEG_INF; exp(0) there
        // must not enter the denominator
        alpha[r] = m[r] == NEG_INF ? 0.f : exp2_fast(m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // a masked score is -inf: 2^-inf = 0
            const float p = exp2_fast(fmaf(s[4 * n + 2 * r + e], sl, -m_new));
            s[4 * n + 2 * r + e] = p;
            sum += p;
          }
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[4 * d] *= alpha[0];
        o[4 * d + 1] *= alpha[0];
        o[4 * d + 2] *= alpha[1];
        o[4 * d + 3] *= alpha[1];
      }
      // O += P V: P rounds to bf16 in registers, the A operand as it is
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk],
                     sw128_desc(vs + kk * 16 * 64, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();  // this stage's readers are done before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = i0 + rw + g + 8 * r, t = tr[r];
    if (t >= T_len) continue;
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow =
        out + (((long long)b * T_len + t) * Hq + (long long)h_kv * G +
               (row - t * G)) * hd;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int col = d * 8 + 2 * tq;
      if (col >= hd) break;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          o[4 * d + 2 * r] / den, o[4 * d + 2 * r + 1] / den);
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int T_len, int Hq, int Hkv, int hd,
                        long long q_sb, long long q_st, long long k_sb,
                        long long k_st, long long v_sb, long long v_st,
                        int window, float scale, cudaStream_t stream) {
  using S = Bf16Shape<HD>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = tl::mma::smem_limit_once(
      flash_bf16_kernel<HD>, (int)S::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const int n_tiles = (int)(((long long)T_len * G + S::BM - 1) / S::BM);
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * Hkv, n_tiles);
  flash_bf16_kernel<HD><<<grid, S::THREADS, S::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, T_len, Hq, G, hd, q_sb,
      q_st, k_sb, k_st, v_sb, v_st, window, scale, n_tiles);
  return cudaGetLastError();
}

cudaError_t launch_bf16_any(int hd, const void* q, const void* k,
                            const void* v, void* out, int B, int T_len,
                            int Hq, int Hkv, long long q_sb, long long q_st,
                            long long k_sb, long long k_st, long long v_sb,
                            long long v_st, int window, float scale,
                            cudaStream_t stream) {
  if (hd <= 0 || hd % 16 || hd > 256) return cudaErrorInvalidValue;
#define TL_FLASH_BF16(HD)                                                   \
  return launch_bf16<HD>(q, k, v, out, B, T_len, Hq, Hkv, hd, q_sb, q_st,  \
                         k_sb, k_st, v_sb, v_st, window, scale, stream)
  if (hd <= 64) TL_FLASH_BF16(64);
  if (hd <= 128) TL_FLASH_BF16(128);
  TL_FLASH_BF16(256);
#undef TL_FLASH_BF16
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int T_len, int Hq, int Hkv, long long q_sb,
                      long long q_st, long long k_sb, long long k_st,
                      long long v_sb, long long v_st, int window,
                      float scale, cudaStream_t stream) {
  using S = Shape<HD>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T_len + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, HD><<<grid, S::THREADS, S::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, T_len, Hq, Hq / Hkv,
      q_sb, q_st, k_sb, k_st, v_sb, v_st, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int hd, const void* q, const void* k, const void* v,
                   void* out, int B, int T_len, int Hq, int Hkv,
                   long long q_sb, long long q_st, long long k_sb,
                   long long k_st, long long v_sb, long long v_st,
                   int window, float scale, cudaStream_t stream) {
#define TL_FLASH(HD)                                                       \
  case HD:                                                                 \
    return launch_hd<T, HD>(q, k, v, out, B, T_len, Hq, Hkv, q_sb, q_st,  \
                            k_sb, k_st, v_sb, v_st, window, scale, stream)
  switch (hd) {
    TL_FLASH(32);
    TL_FLASH(64);
    TL_FLASH(96);
    TL_FLASH(128);
    TL_FLASH(160);
    TL_FLASH(192);
    TL_FLASH(224);
    TL_FLASH(256);
  }
#undef TL_FLASH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). q [B, T, Hq, hd],
// k / v [B, T, Hkv, hd], each read in place: element (b, t, h, d) at
// b * sb + t * st + h * hd + d (strides in elements, rows 16-byte
// aligned); out [B, T, Hq, hd] contiguous. window: 0 = none, else the
// sliding window. hd up to 256, a multiple of 32 (float32) or of 16
// (bfloat16). Returns a cudaError_t.
extern "C" int tl_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int dtype, int B,
                                  int T_len, int Hq, int Hkv, int hd,
                                  long long q_sb, long long q_st,
                                  long long k_sb, long long k_st,
                                  long long v_sb, long long v_st, int window,
                                  float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(hd, q, k, v, out, B, T_len, Hq, Hkv, q_sb, q_st,
                              k_sb, k_st, v_sb, v_st, window, scale, s);
  if (dtype == 1)
    return (int)launch_bf16_any(hd, q, k, v, out, B, T_len, Hq, Hkv, q_sb,
                                q_st, k_sb, k_st, v_sb, v_st, window, scale,
                                s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
