// Ragged paged attention for Hopper (sm_90a): the unified prefill+decode
// step's attention, one call per layer per chunk.
//
// Replaces: tensorlink_tpu/ops/attention.py:ragged_paged_attention (the
// Pallas kernel _ragged_kernel). Same function: query j of slot s sits at
// starts[s] + j and sees keys <= starts[s] + j through the slot's block
// table; rows at or past n_valid[s] (and idle slots) write exact zeros;
// pages past a tile's last visible position are neither read nor computed.
//
// Design: row r of the C*G query rows of a kv head is block position
// r / G and group member r % G (the layout of _ragged_kernel); rows go in
// tiles of 16, and each tile's visible pages are split 16 at a time over
// thread blocks, then merged (paged_common.cuh). A tile with no valid row
// touches no page and writes zeros.
//
// What bounds it on the card: for decode-heavy blocks the bytes of live
// K/V; for prefill-heavy blocks the FLOPs of QK^T and PV (4 * hd per
// visible (row, key) pair). What this simple design leaves on the table:
// the dot products are scalar f32 FMAs from shared memory (no wgmma/mma
// tensor-core tiles), page loads are not double-buffered (no cp.async/TMA
// pipeline), every row tile of a slot re-reads the slot's pages, and a
// decode slot's tile carries G valid rows of its 16.

#include "paged_common.cuh"

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out [S, C, Hq, hd]; pages
// [P, Hkv, page, hd]; block_tables int32 [S, n_pp]; starts, n_valid int32
// [S]; ws_acc / ws_ml f32 workspaces of S*Hkv*n_tiles*n_splits partials
// (n_tiles = ceil(C*G/16), n_splits = ceil(n_pp/16)) of 16*hd and 16*2
// floats; all contiguous on the current device. Returns a cudaError_t.
extern "C" int tl_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* starts, const void* n_valid,
    void* out, void* ws_acc, void* ws_ml, int dtype, int S, int C, int Hq,
    int Hkv, int hd, int page, int n_pp, float scale, void* stream) {
  if (!tl::shape_ok(Hq, Hkv, hd, page) || S <= 0 || C <= 0 || n_pp <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int n_tiles = (C * G + tl::TILE_ROWS - 1) / tl::TILE_ROWS;
  RaggedRows rows{(const int*)starts, (const int*)n_valid, C, Hq, G, hd};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)tl::launch_two_pass<float>(
        q, k_pages, v_pages, block_tables, rows, out, (float*)ws_acc,
        (float*)ws_ml, S, Hkv, hd, page, n_pp, n_tiles, scale, st);
  if (dtype == 1)
    return (int)tl::launch_two_pass<__nv_bfloat16>(
        q, k_pages, v_pages, block_tables, rows, out, (float*)ws_acc,
        (float*)ws_ml, S, Hkv, hd, page, n_pp, n_tiles, scale, st);
  return (int)cudaErrorInvalidValue;
}
