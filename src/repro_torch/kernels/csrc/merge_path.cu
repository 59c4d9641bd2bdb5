// Merge-absorb of two key-sorted aggregate states of unequal lengths, in
// one fused pass.
//
// Replaces: merge_path_tiles (src/repro/kernels/merge_path.py:112), the
// Pallas merge-path merge with the segmented scan fused, together with the
// compaction its caller runs (ops.merge_absorb_sorted and ops._compact,
// src/repro/kernels/ops.py:174,127).
//
// Function: merge A and B (A wins ties, duplicates allowed on either
// side), combine adjacent equal keys (EMPTY never joins a group), compact
// the groups to the front at capacity |A| + |B|, EMPTY and the neutral
// values after them.  With duplicate-free inputs (assume_unique) the same
// combine is exact, so one path serves both.
//
// What bounds it on the H100: memory.  The merge and the combine do O(1)
// work a row and must read both states and write the merged, compacted
// one: (8 + 4 + 4V) bytes a row each way.  At the main path's shapes,
// (M + 2B) + B = 1,179,648 + 65,536 rows in run generation and (M + P) + P
// = 1,064,960 + 16,384 rows per wide-merge page, that is about 17-20 MB in
// and as much out, some 10-12 us at 3.35 TB/s.
//
// Design: the fused pass of merge_absorb.cuh (tiles of 2,048 output rows
// merged in shared memory, a block scan and a decoupled look-back across
// tiles, a fill kernel), two launches and one memset a call.
#include "merge_absorb.cuh"

extern "C" long long repro_merge_absorb_scratch_bytes(long long n, int ncols) {
  return repro::merge_absorb_scratch_bytes(n, ncols);
}

// *_out receives the result (na + nb rows); scratch is
// repro_merge_absorb_scratch_bytes(na + nb, ncols) bytes.
extern "C" int repro_merge_absorb(
    const int64_t* ka, const int32_t* ca, const float* sa, const float* mna, const float* mxa,
    long long na, const int64_t* kb, const int32_t* cb, const float* sb, const float* mnb,
    const float* mxb, long long nb, int vs, int vm, int vx, long long empty,
    int64_t* keys_out, int32_t* cnt_out, float* sum_out, float* min_out, float* max_out,
    void* scratch, void* stream) {
  repro::Cols cols_a, cols_b;
  int err = repro::make_cols(cols_a, ca, cnt_out, sa, sum_out, vs, mna, min_out, vm, mxa,
                             max_out, vx);
  if (err) return err;
  err = repro::make_cols(cols_b, cb, cnt_out, sb, sum_out, vs, mnb, min_out, vm, mxb, max_out,
                         vx);
  if (err) return err;
  return repro::merge_absorb_launch<true>(ka, na, kb, nb, (int64_t)empty, cols_a, cols_b,
                                          keys_out, cnt_out, sum_out, vs, min_out, vm, max_out,
                                          vx, scratch, (cudaStream_t)stream);
}
