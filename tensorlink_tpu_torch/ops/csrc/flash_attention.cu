// Flash attention for Hopper (sm_90a): causal offset-0 attention over
// dense [B, T, H, hd] tensors, the dense engine's fresh-cache prefill.
//
// Replaces: tensorlink_tpu/ops/attention.py:flash_attention (the Pallas
// kernel _flash_kernel). Same function: query i of a sequence sees keys
// j <= i, and with a sliding window also j > i - window; scores, softmax
// and PV in f32 with the Pallas kernel's online-softmax recurrence and
// guards (a row that has seen no key keeps m = NEG_INF and alpha = 0; the
// denominator is floored at 1e-30); the output rounds once to q's dtype.
// GQA: query head h reads kv head h / G, and no kv head is repeated in
// memory.
//
// Design: one thread block per (q tile of 64 rows, query head, batch
// row). On the TPU the grid's innermost k axis ran in order and carried
// the running max, denominator and accumulator in VMEM from step to step;
// here that carried state lives in registers and a loop over 32-key tiles
// runs inside the block. The loop starts at the first tile the window can
// reach and stops at the causal diagonal (the tile holding the q tile's
// last row), so a block does the causal half of the work, not all of it.
// Each tile of K and V is staged in shared memory as f32 (16-byte vector
// loads from the tensors in place, through their batch and token
// strides); the query tile is staged once. A thread owns 4 query rows and
// keys tx, tx + TX, .. of a tile for the scores (the TX lanes of a row
// group reduce the row max and sum with warp shuffles), then 4 rows and
// head dims tx, tx + TX, .. of the accumulator; the tile's probabilities
// go through shared memory between the two products. Rows and keys past T
// (a T that is no multiple of the tile) load as zeros and are masked, so
// any T works.
//
// What bounds it on the card: at the engine's prefill shapes it is bound
// by operations (4 * hd FLOPs per visible (query head, key) pair against
// 2 * hd bytes of K/V per key and kv head), which Hopper serves fastest
// from its tensor cores. This first design does every product as scalar
// f32 FMAs out of shared memory, so it runs far below the bf16
// tensor-core bound; mma/wgmma tiles fed by TMA are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// sliding window. hd a multiple of 32 up to 256. Returns a cudaError_t.
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
    return (int)launch<__nv_bfloat16>(hd, q, k, v, out, B, T_len, Hq, Hkv,
                                      q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
