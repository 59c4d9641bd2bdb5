// Segmented combine of a key-sorted aggregate state, compacted to the front.
//
// Replaces: segmented_scan_tiles (src/repro/kernels/segmented_reduce.py:115,
// the Pallas flag-based segmented scan) together with the XLA compaction
// scatter that follows it (ops._compact, src/repro/kernels/ops.py:127).
//
// What bounds it on the H100: memory.  It does O(1) operations per row and
// column but must read every key, count and plane value and write the
// compacted state: (8 + 4 + 4V) bytes a row each way.  At the main path's
// batch of 65,536 rows that is under 2 MB, so there the launches (four, see
// seg_combine.cuh) and the single-block carry scan bound it rather than
// bandwidth.
//
// Design: the TPU kernel keeps one pow2 tile in VMEM and scans it in log2(N)
// rolls; a CUDA block holds 512 rows, so the scan becomes three passes with
// block carries (seg_combine.cuh) and the compaction is fused into the last
// pass — each tail writes its aggregate straight to its slot, so no tail
// mask and no scatter pass go through device memory.  A group may span any
// number of blocks.
#include "seg_combine.cuh"

extern "C" long long repro_segmented_combine_scratch_bytes(long long n, int ncols) {
  return repro::sc_scratch_bytes(n, ncols);
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
  return repro::seg_combine_launch(keys, n, (int64_t)empty, cols, keys_out, scratch,
                                   (cudaStream_t)stream);
}
