// Chaining DP: per-anchor best score and predecessor over a window of W
// predecessors, for one read's anchors sorted by (segment, target, query).
//
// Replaces rawalign_tpu/map/chain_pallas.py:chain_dp_batch_pallas (its
// kernel body _kernel). Semantics are those of the C twin
// native/rawalign_host.cpp:ra_chain_dp (rmap.cpp:427-484) and of the
// plain PyTorch versions in rawalign_tpu_torch/map/chain.py
// (chain_dp_plain, and chain_dp_scan_plain, which follows this kernel
// step by step), bit for bit: for anchor i, predecessors j = i-1 down to
// max(i - W, 0); other segments are skipped; equal query or target skip;
// a target gap beyond max_target_gap breaks; a negative query step
// skips; the candidate is f[j] + min(tdiff, qdiff, e) when gap < max_gap
// and 0.75 < qdiff/tdiff < 5 (an IEEE float32 division), else 0; a
// strictly better candidate takes the predecessor (so the first maximum
// in distance order wins ties) and lowers the skip counter, any other
// raises it and the loop breaks once it exceeds max_skips. Slots at and
// past n_anchors get score 0 and pred = their own index. Built with
// --fmad=false; the division and the add are __fdiv_rn and __fadd_rn.
//
// What bounds it: a loop-carried recurrence along the anchors (f[i]
// reads f[j] of the window) with data-dependent early exits. The bytes
// (three int32 inputs, two outputs) take microseconds; what takes the
// time is the chain of dependent steps of the widest read, 52k anchors in
// the 5 Mb sensitive round. So the design shortens each step: one warp
// per read, the window evaluated by the 32 lanes at once, as the JAX
// Pallas kernel evaluates it as a vector axis:
//
// * seg/target/query/f of the last W anchors live in a ring of R slots
//   (a power of two >= min(W, A) + 32), in shared memory while it fits
//   and else in a device buffer the wrapper allocates; the lanes load
//   the next 32 anchors' seg/target/query from global memory, coalesced,
//   one block of 32 ahead of use, and store them into the ring when the
//   anchor loop reaches that block;
// * for anchor i, lane l takes the slot at distance d = 32k + l + 1 in
//   chunk k (k = 0 .. ceil(min(W, i)/32) - 1); the target-gap break is
//   the first set lane of a ballot; the running best before each slot is
//   an exclusive prefix max by __shfl_up_sync; the skip counter is a
//   prefix sum of +1/-1, counted with popc over two ballots; the skip
//   break is the first set lane of a ballot. The running max and the
//   skip count carry from chunk to chunk, and the warp stops at the
//   first chunk with a break (this matters at W = 2048);
// * the part of a chunk that reads no score (the slot loads, the gates
//   with their division, the gap-break ballot) is computed apart from the
//   rest: anchor i+1's first chunk is prepared while anchor i's scans
//   run, so that with one warp on the SM the independent instructions
//   fill the latency of the dependent ones;
// * the predecessor is the last improvement among the live slots (the
//   highest set lane of the improvement ballot, of the last chunk that
//   has one), which is the first maximum in distance order; its score
//   comes by one shuffle;
// * the lane whose anchor it is keeps score and predecessor in registers
//   and writes f[i] into the ring; every 32 anchors the lanes write the
//   block's scores and preds to global memory, coalesced.
//
// Every width up to the engine's ceiling (1<<17) and every window run in
// this one kernel body: A and W are bounded by nothing but device memory. The
// ring takes 16 R bytes: in shared memory (at most 227 KB) up to
// min(W, A) = 8160, beyond that in device memory (a ring per read, the
// same code through another pointer; __syncwarp orders its writes for
// the other lanes as it does in shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#define RA_FULL 0xffffffffu
#define RA_NEG (-3e38f)

// One lane's part of a chunk of 32 window slots of anchor i that does not
// read any score: which slot, whether it is processed (same segment, no
// equal query or target, rmap.cpp:456-457, no negative query step, :465,
// no target-gap break at or before it, :458), whether it passes the gap
// gates (rmap.cpp:466-471) and its matching length.
struct RaChunk {
  int slot;
  bool proc;
  bool gated;
  float matching;
  unsigned gap_m;  // ballot of the target-gap breaks
};

__device__ __forceinline__ RaChunk ra_chunk_static(
    const int* rs, const int* rt, const int* rq, int ring_mask, int i, int k0,
    int nwin, int cs, int ct, int cq, int e, int max_gap, int max_target_gap,
    int lane, unsigned upto) {
  RaChunk c;
  const int d = k0 + lane + 1;
  c.slot = (i - d) & ring_mask;
  const int sj = rs[c.slot], tj = rt[c.slot], qj = rq[c.slot];
  const bool seg_ok = d <= nwin && sj == cs;  // else an inert slot
  const bool cont = seg_ok && (qj == cq || tj == ct);
  const bool brk = seg_ok && !cont && tj + max_target_gap < ct;
  const int qdiff = cq - qj;
  const int tdiff = ct - tj;
  const bool cont2 = seg_ok && !cont && !brk && qdiff < 0;
  const int m32 = tdiff < qdiff ? tdiff : qdiff;
  c.matching = (float)(m32 < e ? m32 : e);
  const int gap_length = tdiff > qdiff ? tdiff - qdiff : qdiff - tdiff;
  const float gap_scale =
      tdiff > 0 ? __fdiv_rn((float)qdiff, (float)tdiff) : 1.0f;
  c.gated = gap_length < max_gap && gap_scale < 5.0f && gap_scale > 0.75f;
  // the first target-gap break and every slot after it are dead
  c.gap_m = __ballot_sync(RA_FULL, brk);
  c.proc = seg_ok && !cont && !cont2 && !(c.gap_m & upto);
  return c;
}

// The rest of the chunk, given the score fj of the lane's slot: updates
// the best score and predecessor and the running max and skip count
// carried to the next chunk; true at a break.
__device__ __forceinline__ bool ra_chunk_step(
    const RaChunk& c, float fj, int i, int k0, int lane, unsigned upto,
    float init, int max_skips, float& best, int& pred, float& carry_max,
    int& carry_skips) {
  float cand = c.gated ? __fadd_rn(fj, c.matching) : 0.0f;  // rmap.cpp:472-474
  if (!c.proc) cand = RA_NEG;
  // running best before each slot: max(init, carried, exclusive prefix
  // max of this chunk)
  float incl = cand;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(RA_FULL, incl, off);
    if (lane >= off) incl = fmaxf(incl, v);
  }
  float excl = __shfl_up_sync(RA_FULL, incl, 1);
  if (lane == 0) excl = RA_NEG;
  const bool improved =
      c.proc && cand > fmaxf(init, fmaxf(carry_max, excl));  // :476
  const unsigned proc_m = __ballot_sync(RA_FULL, c.proc);
  const unsigned impr_m = __ballot_sync(RA_FULL, improved);
  // skip counter after this slot: +1 per processed slot that does not
  // improve, -1 per improvement (rmap.cpp:476-483)
  const int skips =
      carry_skips + __popc(proc_m & ~impr_m & upto) - __popc(impr_m & upto);
  const unsigned skip_m =
      __ballot_sync(RA_FULL, c.proc && !improved && skips > max_skips);
  // the breaking slot itself was processed: keep lanes up to it
  const unsigned keep = skip_m ? (2u << (__ffs(skip_m) - 1)) - 1u : RA_FULL;
  const unsigned kept = impr_m & keep;
  const int last = kept ? 31 - __clz(kept) : 0;
  const float last_cand = __shfl_sync(RA_FULL, cand, last);
  best = kept ? last_cand : best;
  pred = kept ? i - (k0 + last + 1) : pred;
  carry_max = fmaxf(carry_max, __shfl_sync(RA_FULL, incl, 31));
  carry_skips += __popc(proc_m & ~impr_m) - __popc(impr_m);
  return (c.gap_m | skip_m) != 0;
}

// The ring lives in shared memory (kDeviceRing false) or at gring, a
// ring per read: one body, compiled for each, so the shared-memory kernel
// keeps shared loads and stores (a pointer that may be either compiles to
// generic ones, which measured 10% slower).
template <bool kDeviceRing>
__global__ void __launch_bounds__(32) ra_chain_dp_kernel(
    const int* __restrict__ seg, const int* __restrict__ tgt,
    const int* __restrict__ qry, const int* __restrict__ n_anchors, int A,
    int window, int ring_mask, int e, int max_gap, int max_target_gap,
    int max_skips, float* __restrict__ scores, int* __restrict__ preds,
    int* gring) {
  extern __shared__ int smem_ring[];
  const int R = ring_mask + 1;
  int* ring = kDeviceRing ? gring + (size_t)blockIdx.x * 4 * R : smem_ring;
  int* rs = ring;                                 // segment
  int* rt = ring + R;                             // target position
  int* rq = ring + 2 * R;                         // query position
  float* rf = reinterpret_cast<float*>(ring + 3 * R);  // score
  const int lane = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * (size_t)A;
  const int* s = seg + row;
  const int* t = tgt + row;
  const int* q = qry + row;
  float* f = scores + row;
  int* p = preds + row;
  int n = n_anchors[blockIdx.x];
  n = n < 0 ? 0 : (n > A ? A : n);
  for (int i = n + lane; i < A; i += 32) {
    f[i] = 0.0f;
    p[i] = i;
  }
  const float init = (float)e;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0 .. lane

  // the next block's anchors, loaded a block ahead of use
  int ns = 0, nt = 0, nq = 0;
  if (lane < n) {
    ns = __ldg(s + lane);
    nt = __ldg(t + lane);
    nq = __ldg(q + lane);
  }
  for (int base = 0; base < n; base += 32) {
    const int own = (base + lane) & ring_mask;
    rs[own] = ns;
    rt[own] = nt;
    rq[own] = nq;
    const int next = base + 32 + lane;
    if (next < n) {
      ns = __ldg(s + next);
      nt = __ldg(t + next);
      nq = __ldg(q + next);
    }
    __syncwarp();
    float my_score = 0.0f;
    int my_pred = base + lane;
    const int end = base + 32 < n ? base + 32 : n;
    // anchor i's segment, positions, window and the score-free part of
    // its first chunk, prepared while anchor i-1 was chained
    int ci = base & ring_mask;
    int cs = rs[ci], ct = rt[ci], cq = rq[ci];
    int nwin = window < base ? window : base;
    RaChunk c0 = ra_chunk_static(rs, rt, rq, ring_mask, base, 0, nwin, cs, ct,
                                 cq, e, max_gap, max_target_gap, lane, upto);
    for (int i = base; i < end; ++i) {
      float best = init;
      int pred = i;
      float carry_max = RA_NEG;
      int carry_skips = 0;
      const bool stop =
          ra_chunk_step(c0, rf[c0.slot], i, 0, lane, upto, init, max_skips,
                        best, pred, carry_max, carry_skips);
      // the next anchor's first chunk reads no score, so it needs nothing
      // of this one: computed here, it fills the latency of the scans
      // above (at the block's end it reads stale slots and is dropped)
      const int ci1 = (i + 1) & ring_mask;
      const int cs1 = rs[ci1], ct1 = rt[ci1], cq1 = rq[ci1];
      const int nwin1 = window < i + 1 ? window : i + 1;
      const RaChunk c1 =
          ra_chunk_static(rs, rt, rq, ring_mask, i + 1, 0, nwin1, cs1, ct1,
                          cq1, e, max_gap, max_target_gap, lane, upto);
      if (!stop) {
        for (int k0 = 32; k0 < nwin; k0 += 32) {
          const RaChunk c =
              ra_chunk_static(rs, rt, rq, ring_mask, i, k0, nwin, cs, ct, cq,
                              e, max_gap, max_target_gap, lane, upto);
          if (ra_chunk_step(c, rf[c.slot], i, k0, lane, upto, init,
                            max_skips, best, pred, carry_max, carry_skips))
            break;
        }
      }
      if (lane == i - base) {
        rf[ci] = best;
        my_score = best;
        my_pred = pred;
      }
      __syncwarp();
      ci = ci1;
      cs = cs1;
      ct = ct1;
      cq = cq1;
      nwin = nwin1;
      c0 = c1;
    }
    if (base + lane < n) {
      f[base + lane] = my_score;
      p[base + lane] = my_pred;
    }
  }
}

// One launch for B reads of A anchor slots each (row-major, contiguous):
// one 32-thread block per read, its ring of `ring` slots (a power of two
// >= min(window, A) + 32) in 16 * ring bytes of dynamic shared memory, or,
// when gring is not null, at gring + 4 * ring * read (B * 4 * ring int32).
extern "C" int ra_chain_dp(int device, const int* seg, const int* tgt,
                           const int* qry, const int* n_anchors, int B, int A,
                           int window, int ring, int e, int max_gap,
                           int max_target_gap, int max_skips, float* scores,
                           int* preds, int* gring, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  if (gring) {
    ra_chain_dp_kernel<true><<<B, 32, 0, (cudaStream_t)stream>>>(
        seg, tgt, qry, n_anchors, A, window, ring - 1, e, max_gap,
        max_target_gap, max_skips, scores, preds, gring);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)ring * 4 * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ra_chain_dp_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ra_chain_dp_kernel<false><<<B, 32, smem, (cudaStream_t)stream>>>(
      seg, tgt, qry, n_anchors, A, window, ring - 1, e, max_gap,
      max_target_gap, max_skips, scores, preds, nullptr);
  return (int)cudaGetLastError();
}
