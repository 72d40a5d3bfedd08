// Sketch scan: the sequential seed scan over one read's events.
//
// Replaces rawalign_tpu/seeds/sketch_pallas.py:sketch_scan_pallas (its
// kernel body _make_kernel) together with the elementwise quantize_u32
// before it and hash64_u32 after it (rawalign_tpu/seeds/sketch.py).
// Semantics are those of the plain scan in
// rawalign_tpu_torch/seeds/sketch.py:_sketch_scan (rsketch.c:223-274):
// skip an event within 0.3 of the last kept one (event 0 bypasses the
// check) and skip RI_MASK_SIGNAL; pack the quantized code of every kept
// event into a uint32 accumulator masked to quant_bit*e bits; keep the
// kept count and a ring of the last e kept positions; once e events are
// packed, every kept event emits hash64(pack).
//
// Outputs per event slot, exactly those of _sketch_scan: hashes (0 where
// nothing is emitted, int64 holding the uint32 value), emit, oldest (the
// ring's oldest position) and cnt. The TPU kernel packed emit/cnt/oldest
// into one int32 and so needed NE < 8192; this kernel writes them
// separately and has no such limit.
//
// What bounds it: the only loop-carried recurrence is WHICH events are
// kept (an event is kept by comparison with the last kept one); the
// count, the ring, the pack and the hash are functions of the kept list.
// The call moves about 1 MB, so the recurrence's latency is what counts.
// One block per read (the formulation of
// seeds/sketch.py:_sketch_scan_jump_plain):
//   1. the row's n events are loaded coalesced into shared memory;
//   2. every thread j finds next[j], the first event after j that would
//      be kept if j were the last kept one (a scan of one or two slots on
//      real reads); the kept list is the orbit of the first non-masked
//      event under next;
//   3. five rounds of pointer doubling give next^32; thread 0 walks it
//      (one dependent shared load per 32 kept events) and writes every
//      32nd kept position, then one thread per such anchor walks next
//      for the 31 positions after it: the serial part is n/32 + 32
//      dependent loads, not n;
//   4. cnt is filled by rank (slots from the r-th kept position up to
//      the next hold r), and every slot's oldest, emit, pack and hash
//      follow from cnt and the kept list elementwise; all four outputs
//      are written by the whole block, coalesced.
// A block keeps 4 (NE + 1) words: the events, next (then cnt), the kept
// list (and every other doubling level), next^32. That is 32 KB at
// NE = 2048, in dynamic shared memory; a row too long for shared memory
// gets the same layout in a device buffer the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#define RA_SKETCH_THREADS 512
#define RA_SKETCH_STRIDE 32  // 2^5: five doubling rounds

__device__ __forceinline__ uint32_t ra_hash64_u32(uint32_t key) {
  key = (~key) + (key << 21);
  key = key ^ (key >> 24);
  key = key + (key << 3) + (key << 8);
  key = key ^ (key >> 14);
  key = key + (key << 2) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

// kGlobal: the block's rows lie in the device buffer `scratch`, else in
// dynamic shared memory (two instances, so that the shared one addresses
// shared memory directly).
template <bool kGlobal>
__global__ void __launch_bounds__(RA_SKETCH_THREADS) ra_sketch_scan_kernel(
    const float* __restrict__ events, const int* __restrict__ n_events,
    int NE, int e, int q, int lq, int* scratch,
    long long* __restrict__ hashes, unsigned char* __restrict__ emit_out,
    int* __restrict__ oldest_out, int* __restrict__ cnt_out) {
  extern __shared__ int smem[];
  __shared__ int s_start, s_anchors, s_kept;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t W = (size_t)NE + 1;
  int* base = kGlobal ? scratch + (size_t)b * 4 * W : smem;
  float* val = reinterpret_cast<float*>(base);
  int* nxt = base + W;       // next; cnt once the kept list stands
  int* kept = base + 2 * W;  // doubling levels 2, 4 (next^4, next^16); then the kept list
  int* jmp = base + 3 * W;   // doubling levels 1, 3, 5 (next^2, next^8, next^32)
  const size_t row = (size_t)b * (size_t)NE;
  const float* ev = events + row;
  int n = n_events[b];
  n = n < 0 ? 0 : (n > NE ? NE : n);
  const float last_sig_diff = 0.3f;
  const float mask_signal = 3.402823466e32f;

  // 1. the row's events
  for (int i = tid; i < n; i += T) val[i] = ev[i];
  __syncthreads();

  // 2. next[j]: the first event after j that is kept when j is the last
  //    kept one (n when none is); the same float test as the serial scan,
  //    so a NaN event is kept and keeps its successor
  for (int j = tid; j < n; j += T) {
    const float v = val[j];
    int i = j + 1;
    for (; i < n; ++i) {
      const float w = val[i];
      if (w != mask_signal && !(fabsf(w - v) < last_sig_diff)) break;
    }
    nxt[j] = i;
  }
  if (tid == 0) {
    nxt[n] = n;
    s_anchors = 0;
    s_kept = 0;
  }
  __syncthreads();
  // event 0 bypasses the similarity test; when it is the mask value, the
  // comparison value stays the mask value and next[0] is the first kept
  if (tid == 0) s_start = n > 0 ? (val[0] != mask_signal ? 0 : nxt[0]) : 0;

  // 3a. next^32 by five rounds of doubling between the two spare rows
  for (int j = tid; j <= n; j += T) jmp[j] = nxt[nxt[j]];
  __syncthreads();
  for (int j = tid; j <= n; j += T) kept[j] = jmp[jmp[j]];
  __syncthreads();
  for (int j = tid; j <= n; j += T) jmp[j] = kept[kept[j]];
  __syncthreads();
  for (int j = tid; j <= n; j += T) kept[j] = jmp[jmp[j]];
  __syncthreads();
  for (int j = tid; j <= n; j += T) jmp[j] = kept[kept[j]];
  __syncthreads();
  // 3b. every 32nd kept position, by one thread
  if (tid == 0) {
    int m = 0;
    for (int p = s_start; p < n; p = jmp[p]) kept[(m++) * RA_SKETCH_STRIDE] = p;
    s_anchors = m;
  }
  __syncthreads();
  // 3c. the 31 kept positions after each anchor; only the last anchor
  //     can run off the row, and where it does the kept count is known
  const int anchors = s_anchors;
  for (int m = tid; m < anchors; m += T) {
    int p = kept[m * RA_SKETCH_STRIDE];
    int t = 1;
    for (; t < RA_SKETCH_STRIDE; ++t) {
      p = nxt[p];
      if (p >= n) break;
      kept[m * RA_SKETCH_STRIDE + t] = p;
    }
    if (m == anchors - 1) s_kept = m * RA_SKETCH_STRIDE + t;
  }
  __syncthreads();

  // 4. cnt[i] = kept positions up to i: slots from the (r-1)-th kept
  //    position up to the r-th hold r (next is dead: its row takes cnt)
  const int K = s_kept;
  int* cnt = nxt;
  for (int r = tid; r <= K; r += T) {
    const int lo = r ? kept[r - 1] : 0;
    const int hi = r < K ? kept[r] : n;
    for (int i = lo; i < hi; ++i) cnt[i] = r;
  }
  __syncthreads();

  // 5. every slot's outputs from cnt and the kept list; slots past n
  //    repeat the last state
  const int quant_bit = lq + 2;
  const int nbits = quant_bit * e;
  const uint32_t mask = nbits < 32 ? ((1u << nbits) - 1u) : 0xFFFFFFFFu;
  const uint32_t mask_lq = (1u << lq) - 1u;
  for (int i = tid; i < NE; i += T) {
    const int c = i < n ? cnt[i] : K;
    const bool keep = i < n && c > 0 && kept[c - 1] == i;
    const bool emit = keep && c >= e;
    uint32_t h = 0;
    if (emit) {
      // the pack: the e newest kept codes, the newest lowest; a code
      // shifted to bit 32 or beyond has left the uint32
      uint32_t acc = 0;
      for (int j = 0; j < e; ++j) {
        const int sh = quant_bit * j;
        if (sh >= 32) break;
        const uint32_t bits = __float_as_uint(val[kept[c - 1 - j]]);
        const uint32_t tq = ((bits >> 30) << lq) | ((bits >> (32 - q)) & mask_lq);
        acc |= tq << sh;
      }
      h = ra_hash64_u32(acc & mask);
    }
    hashes[row + i] = (long long)h;
    emit_out[row + i] = emit ? 1 : 0;
    oldest_out[row + i] = c >= e ? kept[c - e] : 0;
    cnt_out[row + i] = c;
  }
}

// One launch for B reads. scratch is null when the 4 (NE + 1) words of a
// block fit in shared memory (smem_bytes of them), else a device buffer
// of B * 4 (NE + 1) int32.
extern "C" int ra_sketch_scan(
    int device, const float* events, const int* n_events, int B, int NE, int e, int q,
    int lq, int* scratch, long long smem_bytes, long long* hashes,
    unsigned char* emit, int* oldest, int* cnt, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || NE <= 0) return (int)cudaGetLastError();
  if (scratch) {
    ra_sketch_scan_kernel<true><<<B, RA_SKETCH_THREADS, 0, (cudaStream_t)stream>>>(
        events, n_events, NE, e, q, lq, scratch, hashes, emit, oldest, cnt);
    return (int)cudaGetLastError();
  }
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(ra_sketch_scan_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ra_sketch_scan_kernel<false><<<B, RA_SKETCH_THREADS, (size_t)smem_bytes,
                                 (cudaStream_t)stream>>>(
      events, n_events, NE, e, q, lq, nullptr, hashes, emit, oldest, cnt);
  return (int)cudaGetLastError();
}
