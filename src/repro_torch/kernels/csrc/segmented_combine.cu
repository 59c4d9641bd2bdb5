// Segmented combine of a key-sorted aggregate state, compacted to the front.
//
// Replaces: segmented_scan_tiles (src/repro/kernels/segmented_reduce.py:115,
// the Pallas flag-based segmented scan) together with the XLA compaction
// scatter that follows it (ops._compact, src/repro/kernels/ops.py:127).
//
// What bounds it on the H100: memory.  It does O(1) operations per row and
// column but must read every key, count and plane value and write the
// compacted state: (8 + 4 + 4V) bytes a row each way.  At the main path's
// batch of 65,536 rows that is under 2 MB, so there latency and launches
// bound it rather than bandwidth.
//
// Design: a segmented combine of A is the merge-absorb of A with an empty
// B at capacity |A|, so it runs the B-less variant of the fused pass of
// merge_absorb.cuh: tiles of 2,048 rows loaded coalesced, a block scan and
// a single-pass decoupled look-back across tiles (a group may span any
// number of tiles), the groups staged in shared memory and written
// coalesced; then the fill.  Two launches and one memset a call.
#include "merge_absorb.cuh"

extern "C" long long repro_segmented_combine_scratch_bytes(long long n, int ncols) {
  return repro::merge_absorb_scratch_bytes(n, ncols);
}

extern "C" int repro_segmented_combine(const int64_t* keys, long long n, long long empty,
                                       const int32_t* cnt, const float* s, int vs,
                                       const float* mn, int vm, const float* mx, int vx,
                                       int64_t* keys_out, int32_t* cnt_out, float* s_out,
                                       float* mn_out, float* mx_out, void* scratch,
                                       void* stream) {
  repro::Cols cols;
  int err = repro::make_cols(cols, cnt, cnt_out, s, s_out, vs, mn, mn_out, vm, mx, mx_out, vx);
  if (err) return err;
  return repro::merge_absorb_launch<false>(keys, n, nullptr, 0, (int64_t)empty, cols, cols,
                                           keys_out, cnt_out, s_out, vs, mn_out, vm, mx_out, vx,
                                           scratch, (cudaStream_t)stream);
}
