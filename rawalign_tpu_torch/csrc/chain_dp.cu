// Chaining DP: per-anchor best score and predecessor over a window of W
// predecessors, for one read's anchors sorted by (segment, target, query).
//
// Replaces rawalign_tpu/map/chain_pallas.py:chain_dp_batch_pallas (its
// kernel body _kernel). Semantics are those of the C twin
// native/rawalign_host.cpp:ra_chain_dp (rmap.cpp:427-484) and of the
// plain PyTorch version in rawalign_tpu_torch/map/chain.py, bit for bit:
// for anchor i, predecessors j = i-1 down to max(i - W, 0); other
// segments are skipped; equal query or target skip; a target gap beyond
// max_target_gap breaks; a negative query step skips; the candidate is
// f[j] + min(tdiff, qdiff, e) when gap < max_gap and 0.75 < qdiff/tdiff
// < 5 (an IEEE float32 division), else 0; a strictly better candidate
// takes the predecessor (so the first maximum in distance order wins
// ties) and lowers the skip counter, any other raises it and the loop
// breaks once it exceeds max_skips. Slots at and past n_anchors get
// score 0 and pred = their own index. Built with --fmad=false.
//
// What bounds it: a loop-carried recurrence along the anchors (f[i]
// reads f[j] of the window) with data-dependent early exits, so the only
// parallelism is across reads; one round chains B = 32..64 reads of up
// to 1<<17 anchors. One block per read; thread 0 runs the C twin's loop,
// the other threads write the tail past n_anchors. The scores of the
// last W anchors sit in a shared-memory ring (a power of two of at least
// min(W, A) floats, 8 KB at W = 2048), so A is bounded by nothing but
// device memory, and every width up to the ceiling runs in this one
// kernel (the TPU engine split wide rounds at 8192 anchors because of
// VMEM). seg/target/query of the window are re-read from global memory,
// where the thread read them a few anchors before (L1 hits). A warp per
// read, with the window's early exits as warp prefix scans, is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#define RA_CHAIN_THREADS 32

__global__ void ra_chain_dp_kernel(
    const int* __restrict__ seg, const int* __restrict__ tgt,
    const int* __restrict__ qry, const int* __restrict__ n_anchors, int A,
    int window, int ring_mask, int e, int max_gap, int max_target_gap,
    int max_skips, float* __restrict__ scores, int* __restrict__ preds) {
  extern __shared__ float ring[];
  const size_t row = (size_t)blockIdx.x * (size_t)A;
  const int* s = seg + row;
  const int* t = tgt + row;
  const int* q = qry + row;
  float* f = scores + row;
  int* p = preds + row;
  int n = n_anchors[blockIdx.x];
  n = n < 0 ? 0 : (n > A ? A : n);
  for (int i = n + threadIdx.x; i < A; i += blockDim.x) {
    f[i] = 0.0f;
    p[i] = i;
  }
  if (threadIdx.x != 0) return;
  const float init_score = (float)e;
  for (int i = 0; i < n; ++i) {
    float best = init_score;
    int pred = i;
    const int cs = s[i], ct = t[i], cq = q[i];
    const int lo = i - window > 0 ? i - window : 0;
    int num_skips = 0;
    for (int j = i - 1; j >= lo; --j) {
      if (s[j] != cs) continue;  // inert cross-segment slot
      const int tj = t[j], qj = q[j];
      if (qj == cq || tj == ct) continue;  // rmap.cpp:456-457
      if (tj + max_target_gap < ct) break;   // rmap.cpp:458
      const int qdiff = cq - qj;
      if (qdiff < 0) continue;  // rmap.cpp:465
      const int tdiff = ct - tj;
      float current = 0.0f;
      const int m32 = tdiff < qdiff ? tdiff : qdiff;
      const float matching = (float)(m32 < e ? m32 : e);
      const int gap_length = tdiff > qdiff ? tdiff - qdiff : qdiff - tdiff;
      const float gap_scale = tdiff > 0 ? (float)qdiff / (float)tdiff : 1.0f;
      if (gap_length < max_gap && gap_scale < 5.0f && gap_scale > 0.75f)
        current = ring[j & ring_mask] + matching;  // rmap.cpp:472-474
      if (current > best) {
        best = current;
        pred = j;
        --num_skips;  // rmap.cpp:476-478
      } else if (++num_skips > max_skips) {
        break;  // rmap.cpp:479-483
      }
    }
    ring[i & ring_mask] = best;
    f[i] = best;
    p[i] = pred;
  }
}

// One launch for B reads of A anchor slots each (row-major, contiguous).
// ring floats (a power of two >= min(window, A)) of dynamic shared memory
// per block.
extern "C" int ra_chain_dp(int device, const int* seg, const int* tgt,
                           const int* qry, const int* n_anchors, int B, int A,
                           int window, int ring, int e, int max_gap,
                           int max_target_gap, int max_skips, float* scores,
                           int* preds, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)ring * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ra_chain_dp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ra_chain_dp_kernel<<<B, RA_CHAIN_THREADS, smem, (cudaStream_t)stream>>>(
      seg, tgt, qry, n_anchors, A, window, ring - 1, e, max_gap,
      max_target_gap, max_skips, scores, preds);
  return (int)cudaGetLastError();
}
