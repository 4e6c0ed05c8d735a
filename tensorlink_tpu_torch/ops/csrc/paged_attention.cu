// Paged decode attention for Hopper (sm_90a): one query per slot, one
// call per layer per decode-continuation step.
//
// Replaces: tensorlink_tpu/ops/attention.py:paged_attention (the Pallas
// kernel _paged_kernel). Same function: slot s attends positions
// < lengths[s] through its block table; a length-0 slot writes zeros and
// reads no page; pages at or past the length are skipped.
//
// Design: the G query heads of a kv head form one tile (16 at most per
// tile); the slot's live pages 0 .. ceil(len/page)-1 are split 16 at a
// time over thread blocks — each block reads its own block-table row and
// length in place of scalar prefetch — and the partial softmaxes are
// merged in a second pass (paged_common.cuh).
//
// What bounds it on the card: the bytes of live K/V (2 * len * hd per kv
// head per slot); its FLOPs are 4 * hd per (query head, key), far below
// the bytes at G = 2. What this simple design leaves on the table: each
// block streams its pages serially with no cp.async/TMA double buffering
// and stages them as f32 through shared memory, only G of the tile's 16
// rows are live, and the scalar dot products leave most threads idle at
// G = 2.
//
// Quantized variants (kv_format 1 and 2) replace the same Pallas kernel
// with quantized=True: int8 pages, and packed int4 pages (`packed`, two
// codes per byte, split-half). They are bound by bytes: about half (int8)
// or a quarter (int4) of the fp KV bytes, plus 8 B of scales (one f32 for
// K and one for V) per live position per kv head. The design dequantizes
// at the page load (load_page in paged_common.cuh) into the same f32
// shared-memory tiles, so the arithmetic after the load is unchanged.

#include "paged_common.cuh"

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and fp pages). kv_format: 0
// = pages in q's dtype [P, Hkv, page, hd] (scales null), 1 = int8
// [P, Hkv, page, hd], 2 = packed int4 [P, Hkv, page, hd/2], both with f32
// k_scale / v_scale [P, Hkv, page]. q/out [S, Hq, hd]; block_tables int32
// [S, n_pp]; lengths int32 [S]; ws_acc / ws_ml f32 workspaces of
// S*Hkv*n_tiles*n_splits partials (n_tiles = ceil(G/16), n_splits =
// ceil(n_pp/16)) of 16*hd and 16*2 floats; all contiguous on the current
// device. Returns a cudaError_t.
extern "C" int tl_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale,
                                  const void* block_tables,
                                  const void* lengths, void* out,
                                  void* ws_acc, void* ws_ml, int dtype,
                                  int kv_format, int S, int Hq, int Hkv,
                                  int hd, int page, int n_pp, float scale,
                                  void* stream) {
  if (!tl::shape_ok(Hq, Hkv, hd, page) || S <= 0 || n_pp <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int n_tiles = (G + tl::TILE_ROWS - 1) / tl::TILE_ROWS;
  DecodeRows rows{(const int*)lengths, Hq, G, hd};
  return (int)tl::launch(dtype, kv_format, q, k_pages, v_pages, k_scale,
                         v_scale, block_tables, rows, out, ws_acc, ws_ml, S,
                         Hkv, hd, page, n_pp, n_tiles, scale,
                         (cudaStream_t)stream);
}
