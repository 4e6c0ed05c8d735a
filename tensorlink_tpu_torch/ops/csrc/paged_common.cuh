// The scalar f32 body of the paged attention kernels (sm_90a): every
// float32 launch of ragged_paged_attention.cu's two entry points.
//
// A query-row TILE is up to TILE_ROWS query rows of one (slot, kv head);
// row r carries the element offset of its query (and output) row and
// `limit[r]`, the last key position it may see (inclusive), or -1 for a
// row that must come out as zeros. The ragged and decode launches differ
// only in how they lay rows out (a `Rows` policy: RaggedRows and
// DecodeRows in ragged_paged_attention.cu); everything else is here.
//
// Two passes, flash-decoding style:
//  1. attend_kernel: one thread block per (slot, tile, split, kv head),
//     where a split is SPLIT_PAGES consecutive pages of the slot's block-
//     table row. The block stages each K/V page tile (page x hd) in shared
//     memory as f32 and runs the online softmax of the Pallas kernels in
//     tensorlink_tpu/ops/attention.py (running max m, denominator l,
//     hd-wide accumulator) over its own pages only, then writes its
//     partial (m, l, unnormalized acc) to a workspace. Splits past the
//     tile's last visible page exit at once: work follows start + n_valid
//     (or the length), never the slot's page capacity. Where the TPU ran
//     its page axis in order on one core, the splits run in parallel.
//  2. combine_kernel: one block per (slot, tile, kv head) merges the
//     used splits' partials (rescaled to a common max) and writes
//     acc / max(l, 1e-30) in the output dtype. A row that never saw an
//     unmasked key keeps l = 0 and writes exact zeros, as the TPU
//     kernels do.
//
// Pages are full precision (q's dtype), int8 or packed int4 (PageFormat
// below); quantized pages dequantize into the f32 tiles at the load, so
// everything after the load is one code path for the three formats.
//
// All arithmetic is f32 with scalar FMAs; the output rounds once.

#pragma once

#include <cuda_runtime.h>

namespace tl {

constexpr float NEG_INF = -1e30f;  // the JAX kernels' masking value
constexpr int TILE_ROWS = 16;      // query rows per tile
constexpr int SPLIT_PAGES = 16;    // pages per attend block
constexpr int THREADS = 128;       // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Dynamic shared memory of one attend block, in bytes. K and q rows are
// padded to hd + 1 floats so that the score loop (thread per (row, key)
// pair, each reading along d) hits distinct banks for neighbouring keys.
inline size_t tile_smem_bytes(int hd, int page) {
  const size_t floats = (size_t)TILE_ROWS * (hd + 1)  // q rows
                        + (size_t)page * (hd + 1)     // K page tile
                        + (size_t)page * hd           // V page tile
                        + (size_t)TILE_ROWS * page    // scores, then probs
                        + (size_t)TILE_ROWS * hd      // accumulators
                        + 3 * (size_t)TILE_ROWS;      // m, l, alpha
  return floats * sizeof(float);
}

// Pages a tile must visit: up to its last visible position.
__device__ __forceinline__ int tile_pages(int max_limit, int page, int n_pp) {
  const int n = max_limit < 0 ? 0 : max_limit / page + 1;
  return n < n_pp ? n : n_pp;
}

// Page storage formats (the C entry points' `kv_format` argument):
// full precision in q's dtype, int8 codes, or packed int4 codes (two per
// byte, split-half: byte b of a row holds element b in its low nibble and
// element b + hd/2 in its high nibble). Quantized pages carry one f32
// scale per (page, position, head) in [P, Hkv, page] arrays.
enum PageFormat { FMT_FP = 0, FMT_I8 = 1, FMT_I4 = 2 };

// Bytes of one stored page row (hd values of one position and head).
template <typename T, int FMT>
__host__ __device__ __forceinline__ int row_bytes(int hd) {
  return FMT == FMT_FP ? hd * (int)sizeof(T) : (FMT == FMT_I8 ? hd : hd / 2);
}

// Sign-extends a 4-bit two's-complement code, as models/quant.py's
// unpack_int4 does.
__device__ __forceinline__ float nibble(int x) {
  return (float)(((x & 0xF) ^ 8) - 8);
}

// Loads one K and one V page tile (`page` rows of `row_bytes` each) as f32
// into shared memory, 16 bytes per thread per load (hd is a multiple of
// 32, so a vector never crosses a row); K rows are padded to hd + 1
// floats. Quantized pages dequantize here, at the load: element d of row
// j becomes float(code) * scale[j], the reference's f32 product. A
// 16-byte vector holds 16 int8 codes, or 16 packed bytes = 32 int4 codes
// (elements b..b+15 in the low nibbles, b+hd/2..b+hd/2+15 in the high).
// All of a thread's loads are issued before any is stored.
template <typename T, int FMT>
__device__ __forceinline__ void load_page(const char* __restrict__ k_src,
                                          const char* __restrict__ v_src,
                                          const float* __restrict__ k_sc,
                                          const float* __restrict__ v_sc,
                                          float* ks, float* vs, int page,
                                          int hd) {
  constexpr int PER = 4;  // vectors in flight per thread and array
  const int rb = row_bytes<T, FMT>(hd);
  const int n_vec = page * rb / 16;
  const int hp = hd + 1;
  const uint4* kv = reinterpret_cast<const uint4*>(k_src);
  const uint4* vv = reinterpret_cast<const uint4*>(v_src);
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += PER * blockDim.x) {
    uint4 kr[PER], vr[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int vi = v0 + u * blockDim.x;
      if (vi < n_vec) {
        kr[u] = __ldg(kv + vi);
        vr[u] = __ldg(vv + vi);
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int vi = v0 + u * blockDim.x;
      if (vi >= n_vec) break;
      const int byte = vi * 16, j = byte / rb, b = byte - j * rb;
      if constexpr (FMT == FMT_FP) {
        constexpr int VEC = 16 / sizeof(T);
        const int d = b / (int)sizeof(T);
        const T* kt = reinterpret_cast<const T*>(&kr[u]);
        const T* vt = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
        for (int x = 0; x < VEC; ++x) {
          ks[j * hp + d + x] = to_f32(kt[x]);
          vs[j * hd + d + x] = to_f32(vt[x]);
        }
      } else if constexpr (FMT == FMT_I8) {
        const float sk = __ldg(k_sc + j), sv = __ldg(v_sc + j);
        const signed char* kt = reinterpret_cast<const signed char*>(&kr[u]);
        const signed char* vt = reinterpret_cast<const signed char*>(&vr[u]);
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          ks[j * hp + b + x] = (float)kt[x] * sk;
          vs[j * hd + b + x] = (float)vt[x] * sv;
        }
      } else {
        const float sk = __ldg(k_sc + j), sv = __ldg(v_sc + j);
        const unsigned char* kt =
            reinterpret_cast<const unsigned char*>(&kr[u]);
        const unsigned char* vt =
            reinterpret_cast<const unsigned char*>(&vr[u]);
        const int h2 = hd / 2;
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int kb = kt[x], vb = vt[x];
          ks[j * hp + b + x] = nibble(kb) * sk;
          ks[j * hp + b + h2 + x] = nibble(kb >> 4) * sk;
          vs[j * hd + b + x] = nibble(vb) * sv;
          vs[j * hd + b + h2 + x] = nibble(vb >> 4) * sv;
        }
      }
    }
  }
}

struct TileRows {
  long long row_off[TILE_ROWS];
  int limit[TILE_ROWS];
};

// Workspace layout: per (slot, head, tile, split) one partial of
// TILE_ROWS x hd accumulators and TILE_ROWS x 2 (m, l); the wrapper
// allocates S * Hkv * n_tiles * n_splits partials.
__device__ __forceinline__ long long part_index(int s, int h, int tile,
                                                int split, int Hkv,
                                                int n_tiles, int n_splits) {
  return (((long long)s * Hkv + h) * n_tiles + tile) * n_splits + split;
}

template <typename T, int FMT, typename Rows>
__global__ void __launch_bounds__(THREADS)
    attend_kernel(const T* __restrict__ q, const char* __restrict__ k_pages,
                  const char* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ block_tables, Rows rows,
                  float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                  int Hkv, int hd, int page, int n_pp, int n_tiles,
                  int n_splits, float scale) {
  __shared__ TileRows tr;
  extern __shared__ float smem[];
  // blockIdx.x = (slot, tile, split), row-major; blockIdx.y = kv head
  const int split = blockIdx.x % n_splits;
  const int tile = (blockIdx.x / n_splits) % n_tiles;
  const int s = blockIdx.x / (n_splits * n_tiles), h = blockIdx.y;
  int n_rows;
  const int max_limit = rows.setup(s, h, tile, tr.row_off, tr.limit, n_rows);
  const int n_pages = tile_pages(max_limit, page, n_pp);
  const int p_lo = split * SPLIT_PAGES;
  if (p_lo >= n_pages) return;  // nothing visible in this split
  const int p_hi = min(p_lo + SPLIT_PAGES, n_pages);
  __syncthreads();  // tr is visible

  const int hp = hd + 1;
  float* qs = smem;
  float* ks = qs + TILE_ROWS * hp;
  float* vs = ks + page * hp;
  float* sc = vs + page * hd;
  float* acc = sc + TILE_ROWS * page;
  float* m = acc + TILE_ROWS * hd;
  float* l = m + TILE_ROWS;
  float* alpha = l + TILE_ROWS;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* bt_row = block_tables + (long long)s * n_pp;
  const int rb = row_bytes<T, FMT>(hd);

  for (int e = tid; e < n_rows * hd; e += nt) {
    const int r = e / hd, d = e - r * hd;
    qs[r * hp + d] = tr.limit[r] >= 0 ? to_f32(q[tr.row_off[r] + d]) : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < n_rows; r += nt) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  for (int i = p_lo; i < p_hi; ++i) {
    // (page, kv head) index: page rows and scales are [P, Hkv, page, ..]
    const long long ph = ((long long)bt_row[i] * Hkv + h) * page;
    __syncthreads();  // the previous page's readers are done
    load_page<T, FMT>(k_pages + ph * rb, v_pages + ph * rb,
                      FMT == FMT_FP ? nullptr : k_scale + ph,
                      FMT == FMT_FP ? nullptr : v_scale + ph, ks, vs, page,
                      hd);
    __syncthreads();
    const int k0 = i * page;
    for (int pr = tid; pr < n_rows * page; pr += nt) {
      const int r = pr / page, j = pr - r * page;
      float s_val = NEG_INF;
      if (k0 + j <= tr.limit[r]) {
        const float* qr = qs + r * hp;
        const float* kr = ks + j * hp;
        // four independent chains (hd is a multiple of 32)
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        for (int d = 0; d < hd; d += 4) {
          d0 = fmaf(qr[d], kr[d], d0);
          d1 = fmaf(qr[d + 1], kr[d + 1], d1);
          d2 = fmaf(qr[d + 2], kr[d + 2], d2);
          d3 = fmaf(qr[d + 3], kr[d + 3], d3);
        }
        s_val = ((d0 + d1) + (d2 + d3)) * scale;
      }
      sc[pr] = s_val;
    }
    __syncthreads();
    // online-softmax update: one warp per row, lanes over the page's keys
    const int lane = tid & 31;
    for (int r = tid >> 5; r < n_rows; r += nt >> 5) {
      float* row = sc + r * page;
      const float m_prev = m[r];
      float mx = m_prev;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float p = (k0 + j <= tr.limit[r]) ? expf(row[j] - mx) : 0.f;
        row[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = (m_prev == NEG_INF) ? 0.f : expf(m_prev - mx);
        l[r] = l[r] * a + sum;
        m[r] = mx;
        alpha[r] = a;
      }
    }
    __syncthreads();
    for (int e = tid; e < n_rows * hd; e += nt) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = sc + r * page;
      float a = acc[e] * alpha[r];
      for (int j = 0; j < page; ++j) a = fmaf(pr[j], vs[j * hd + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();
  const long long part = part_index(s, h, tile, split, Hkv, n_tiles, n_splits);
  float* pa = ws_acc + part * TILE_ROWS * hd;
  float* pml = ws_ml + part * TILE_ROWS * 2;
  for (int e = tid; e < n_rows * hd; e += nt) pa[e] = acc[e];
  for (int r = tid; r < n_rows; r += nt) {
    pml[2 * r] = m[r];
    pml[2 * r + 1] = l[r];
  }
}

template <typename T, typename Rows>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(T* __restrict__ out, Rows rows,
                   const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml, int Hkv, int hd,
                   int page, int n_pp, int n_tiles, int n_splits) {
  __shared__ TileRows tr;
  // blockIdx.x = (slot, tile), row-major; blockIdx.y = kv head
  const int s = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int h = blockIdx.y;
  int n_rows;
  const int max_limit = rows.setup(s, h, tile, tr.row_off, tr.limit, n_rows);
  const int n_pages = tile_pages(max_limit, page, n_pp);
  const int n_used = (n_pages + SPLIT_PAGES - 1) / SPLIT_PAGES;
  const long long part0 = part_index(s, h, tile, 0, Hkv, n_tiles, n_splits);
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * hd; e += blockDim.x) {
    const int r = e / hd;
    float m_max = NEG_INF;
    for (int sp = 0; sp < n_used; ++sp)
      m_max = fmaxf(m_max, ws_ml[(part0 + sp) * TILE_ROWS * 2 + 2 * r]);
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const long long p = part0 + sp;
      const float w = expf(ws_ml[p * TILE_ROWS * 2 + 2 * r] - m_max);
      den = fmaf(ws_ml[p * TILE_ROWS * 2 + 2 * r + 1], w, den);
      num = fmaf(ws_acc[p * TILE_ROWS * hd + e], w, num);
    }
    out[tr.row_off[r] + (e - r * hd)] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

// Raises a kernel's dynamic shared-memory cap when a tile needs more than
// the default 48 KB; the launch that follows reports any refusal.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline bool shape_ok(int Hq, int Hkv, int hd, int page) {
  return Hkv > 0 && Hq % Hkv == 0 && hd > 0 && hd % 32 == 0 && hd <= 256 &&
         page > 0 && tile_smem_bytes(hd, page) <= 232448;
}

// Both passes on `stream`; returns the first error.
template <typename T, int FMT, typename Rows>
cudaError_t launch_two_pass(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* bt, Rows rows, void* out,
                            float* ws_acc, float* ws_ml, int S, int Hkv,
                            int hd, int page, int n_pp, int n_tiles,
                            float scale, cudaStream_t stream) {
  const int n_splits = (n_pp + SPLIT_PAGES - 1) / SPLIT_PAGES;
  const size_t smem = tile_smem_bytes(hd, page);
  cudaError_t err = allow_smem(attend_kernel<T, FMT, Rows>, smem);
  if (err != cudaSuccess) return err;
  attend_kernel<T, FMT, Rows><<<dim3(S * n_tiles * n_splits, Hkv), THREADS,
                                smem, stream>>>(
      (const T*)q, (const char*)k, (const char*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)bt, rows, ws_acc, ws_ml, Hkv, hd,
      page, n_pp, n_tiles, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T, Rows><<<dim3(S * n_tiles, Hkv), THREADS, 0, stream>>>(
      (T*)out, rows, ws_acc, ws_ml, Hkv, hd, page, n_pp, n_tiles, n_splits);
  return cudaGetLastError();
}

}  // namespace tl

extern "C" const char* tl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
