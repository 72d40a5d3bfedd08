// Chaining DP: per-anchor best score and predecessor over a window of W
// predecessors, for one read's anchors sorted by (segment, target, query).
//
// Replaces rawalign_tpu/map/chain_pallas.py:chain_dp_batch_pallas (its
// kernel body _kernel). Semantics are those of the C twin
// native/rawalign_host.cpp:ra_chain_dp (rmap.cpp:427-484) and of the
// plain PyTorch versions in rawalign_tpu_torch/map/chain.py
// (chain_dp_plain; chain_dp_runs_plain, which splits the rows as this
// kernel does; chain_dp_scan_plain, which follows this kernel's step),
// bit for bit: for anchor i, predecessors j = i-1 down to max(i - W, 0);
// other segments are skipped; equal query or target skip; a target gap
// beyond max_target_gap breaks; a negative query step skips; the
// candidate is f[j] + min(tdiff, qdiff, e) when gap < max_gap and
// 0.75 < qdiff/tdiff < 5 (an IEEE float32 division), else 0; a strictly
// better candidate takes the predecessor (so the first maximum in
// distance order wins ties) and lowers the skip counter, any other
// raises it and the loop breaks once it exceeds max_skips. Slots at and
// past n_anchors get score 0 and pred = their own index. Built with
// --fmad=false; the division and the add are __fdiv_rn and __fadd_rn,
// and fmaxf of finite floats is exact in any order.
//
// What bounds it: a loop-carried recurrence along the anchors (f[i]
// reads f[j] of the window) with data-dependent early exits. The bytes
// (three int32 inputs, two outputs) take microseconds; what takes the
// time is the longest chain of dependent steps. The design cuts both the
// number of serial steps and the length of each, in two launches.
//
// Launch 1, the window pass (ra_chain_dp_kernel_window, a warp per anchor
// over the whole card; its name begins with the recurrence's, so that a
// trace's sums by name take both): everything about anchor i's window that reads
// no score. Lane l takes slot d = 32k + l + 1 of chunk k: processed or
// not, the gates with their division, the matching length, the
// target-gap break (the first set lane of a ballot), and the prefix
// counts P_d of processed slots and C_d of candidate slots, the
// processed slots whose candidate can beat init (those that pass the
// gates; all of them if init < 0). Every other processed slot has
// candidate 0 <= init <= best: it never improves, and counts only
// toward the skip counter. The pass stops at the gap break, the window's
// end, or the first processed non-candidate slot d with
// P_d - 2 C_d > max_skips, where the loop breaks whatever the scores (at
// most C_d improvements can have lowered the counter). It writes one
// int4 record an anchor: up to RA_CANDS candidates in distance order,
// each d | P_d << 8 | matching << 16 | gated << 24, 0 for none; an
// anchor with more candidates, a field beyond its byte, or a candidate
// with P_d > max_skips (one that could meet a skip break) is marked
// RA_COMPLEX (chip_smoke.py logs how many anchors of its captured round
// take each of the two paths below).
//
// Launch 2, the recurrence (ra_chain_dp_kernel, a block per read, a warp
// per independent run). A row splits into runs: a new run starts where
// the segment changes, or where, inside one segment,
// t[k] + max_target_gap < t[k+1]. Exact when the row is non-decreasing
// in (segment, target): for an anchor i of a run that starts at r, every
// slot j < r either lies in another segment (inert), or lies in i's
// segment with t[j] <= t[r-1] < t[r] - max_target_gap <= t[i] - max_target_gap,
// so it is skipped by the equal-query/target test without being counted
// or it breaks the loop (rmap.cpp:456-458). No slot before r ever adds a
// candidate or counts toward the skip counter, so anchor i's result is
// that of its window clipped at r (the window stays W in the row's own
// index), and its record, taken over the row's window, is the clipped
// window's. The same block-wide pass that finds the run starts checks
// that order, and that no t + max_target_gap leaves the int32 range
// (where the break's int32 compare would stop being monotone); a row
// that fails either check runs as one run, exactly as the serial loop
// does. Any contiguous range of anchors that starts at a run start is
// such a job too, so the runs are merged into at most RA_JOBS jobs: the
// row is cut into RA_JOBS slabs of equal anchor count and a job starts
// at the first run start of each slab that has one (a job is one run
// plus at most a slab of shorter runs before it). The block sorts its
// jobs longest first (bitonic, in shared memory) and each warp takes the
// next one as it comes free, so every one of the longest runs has a warp
// of its own. No host round trip.
//
// A step of the recurrence. Anchor i is resolved in two parts. (a) What
// reads no score of anchor i-1, done while anchor i-1 is resolved: its
// record, and the candidates of slots d >= 2, f[i-d] + matching (or 0
// when not gated), whose scores are at least two steps old; their max A
// (with init) and where it first occurs. (b) What waits for f[i-1]:
// slot 1's candidate c1 = f[i-1] + matching. No candidate of a record
// can meet a skip break (every one has P_d <= max_skips, so the count
// P_d - 2 * improvements stays within it up to the last candidate), and
// the loop's result is the first maximum over init and the candidates in
// distance order: f[i] = max(A, c1), two float operations on the serial
// path, every lane computing the same. A RA_COMPLEX anchor runs the
// window in chunks of 32 slots across the lanes (the gates, a ballot for
// the gap break, an exclusive prefix max by __shfl_up_sync, the skip
// count by popc over ballots, the last improvement before the first
// break), as the serial loop would. Every lane writes f[i] into its own
// view of the ring, so the scores need no __syncwarp.
//
// Memory: seg/target/query/f of a job's last W + 64 anchors live in a
// ring of R int4 slots (a power of two >= min(W, A) + 64) per warp, and
// the records of 64 anchors in a second ring; the lanes load anchors two
// blocks of 32 ahead of use from global memory, coalesced, and store
// them one block ahead. The rings sit in shared memory while
// 2 .. RA_MAX_WARPS of them fit beside the job tables (the wrapper picks
// the warp count), else in device memory (RA_MAX_WARPS rings a block,
// the same code through another pointer; __syncwarp orders the block
// stores for the other lanes as it does in shared memory). Every width
// up to the engine's ceiling (1<<17) and every window run in these
// bodies.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define RA_FULL 0xffffffffu
#define RA_NEG (-3e38f)
// jobs (slabs) a row is cut into; the tables take 12 bytes a job
#define RA_JOBS 1024
#define RA_MAX_WARPS 8
#define RA_TABLE_BYTES (RA_JOBS * 12 + 8)
// candidates a record holds, and the mark of an anchor that has more
#define RA_CANDS 4
#define RA_COMPLEX 0xffffffffu
// records a warp stages in shared memory (two blocks of 32 anchors)
#define RA_STAGE 64

// One slot's part that reads no score: processed unless a target-gap
// break comes at or before it (same segment, no equal query or target,
// rmap.cpp:456-457, no negative query step, :465), whether it is such a
// break (:458), whether it passes the gap gates (:466-471) and its
// matching length.
struct RaSlot {
  bool live;
  bool brk;
  bool gated;
  int match;
};

__device__ __forceinline__ RaSlot ra_slot(int4 w, bool in_win, int cs,
                                          int ct, int cq, int e, int max_gap,
                                          int max_target_gap) {
  RaSlot r;
  const bool seg_ok = in_win && w.x == cs;  // else an inert slot
  const bool cont = seg_ok && (w.z == cq || w.y == ct);
  r.brk = seg_ok && !cont && w.y + max_target_gap < ct;
  const int qdiff = cq - w.z;
  const int tdiff = ct - w.y;
  r.live = seg_ok && !cont && !r.brk && qdiff >= 0;
  const int m32 = tdiff < qdiff ? tdiff : qdiff;
  r.match = m32 < e ? m32 : e;
  const int gap_length = tdiff > qdiff ? tdiff - qdiff : qdiff - tdiff;
  const float gap_scale =
      tdiff > 0 ? __fdiv_rn((float)qdiff, (float)tdiff) : 1.0f;
  r.gated = gap_length < max_gap && gap_scale < 5.0f && gap_scale > 0.75f;
  return r;
}

__device__ __forceinline__ float ra_scan_max(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(RA_FULL, x, off);
    if (lane >= off) x = fmaxf(x, v);
  }
  return x;
}

// A chunk of 32 window slots, slot d = k0 + lane + 1, all parts at once:
// updates the best score and predecessor and the running max and skip
// count carried to the next chunk; true at a break.
__device__ __forceinline__ bool ra_chunk(const int4* ring, int mask, int i,
                                         int k0, int nwin, int4 c, int e,
                                         int max_gap, int max_target_gap,
                                         int max_skips, int lane,
                                         unsigned upto, float& best,
                                         int& pred, float& carry_max,
                                         int& carry_skips) {
  const int d = k0 + lane + 1;
  const int4 w = ring[(i - d) & mask];
  const RaSlot s = ra_slot(w, d <= nwin, c.x, c.y, c.z, e, max_gap,
                           max_target_gap);
  const unsigned gap = __ballot_sync(RA_FULL, s.brk);
  const bool proc = s.live && !(gap & upto);
  float cand =
      s.gated ? __fadd_rn(__int_as_float(w.w), (float)s.match) : 0.0f;
  if (!proc) cand = RA_NEG;
  const float incl = ra_scan_max(cand, lane);
  float excl = __shfl_up_sync(RA_FULL, incl, 1);
  if (lane == 0) excl = RA_NEG;
  const bool improved = proc && cand > fmaxf(carry_max, excl);  // :476
  const unsigned pm = __ballot_sync(RA_FULL, proc);
  const unsigned im = __ballot_sync(RA_FULL, improved);
  const int skips =
      carry_skips + __popc(pm & ~im & upto) - __popc(im & upto);
  const unsigned sm =
      __ballot_sync(RA_FULL, proc && !improved && skips > max_skips);
  // the breaking slot itself was processed: keep lanes up to it
  const unsigned kept = im & (sm ^ (sm - 1));
  const int last = 31 - __clz(kept);
  const float got = __shfl_sync(RA_FULL, cand, last & 31);
  if (kept) {
    best = got;
    pred = i - (k0 + last + 1);
  }
  carry_max = fmaxf(carry_max, __shfl_sync(RA_FULL, incl, 31));
  carry_skips += __popc(pm & ~im) - __popc(im);
  return (gap | sm) != 0;
}

// Launch 1: one warp per anchor i < n of each row, the anchor's record.
__global__ void __launch_bounds__(256) ra_chain_dp_kernel_window(
    const int* __restrict__ seg, const int* __restrict__ tgt,
    const int* __restrict__ qry, const int* __restrict__ n_anchors, int A,
    int window, int e, int max_gap, int max_target_gap, int max_skips,
    int4* __restrict__ rec) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  int n = n_anchors[blockIdx.y];
  n = n < 0 ? 0 : (n > A ? A : n);
  if (i >= n) return;
  const size_t row = (size_t)blockIdx.y * (size_t)A;
  const int* s = seg + row;
  const int* t = tgt + row;
  const int* q = qry + row;
  const int cs = __ldg(s + i), ct = __ldg(t + i), cq = __ldg(q + i);
  const int nwin = window < i ? window : i;
  const bool any_cand = (float)e < 0.0f;  // then 0 beats init
  const unsigned upto = (2u << lane) - 1u;
  int n_cand = 0, n_proc = 0;
  unsigned word = 0;  // lane k < RA_CANDS: the record's word k
  bool complex = false;
  for (int k0 = 0; k0 < nwin; k0 += 32) {
    const int d = k0 + lane + 1;
    const bool in_win = d <= nwin;
    int4 w = make_int4(0, 0, 0, 0);
    if (in_win)
      w = make_int4(__ldg(s + i - d), __ldg(t + i - d), __ldg(q + i - d), 0);
    const RaSlot sl = ra_slot(w, in_win, cs, ct, cq, e, max_gap,
                              max_target_gap);
    const unsigned gap = __ballot_sync(RA_FULL, sl.brk);
    const bool proc = sl.live && !(gap & upto);
    const bool cand = proc && (sl.gated || any_cand);
    const unsigned pm = __ballot_sync(RA_FULL, proc);
    unsigned cm = __ballot_sync(RA_FULL, cand);
    const int P = n_proc + __popc(pm & upto);
    const unsigned sure = __ballot_sync(
        RA_FULL, proc && !cand && P - 2 * (n_cand + __popc(cm & upto)) >
                                      max_skips);
    cm &= (sure & (0u - sure)) - 1u;  // candidates before a sure break
    const bool mine = (cm >> lane) & 1u;
    const bool wide = mine && (d > 255 || P > 255 || sl.match < -128 ||
                               sl.match > 127);
    if (n_cand + __popc(cm) > RA_CANDS || __any_sync(RA_FULL, wide)) {
      complex = true;
      break;
    }
    const unsigned my = (unsigned)d | ((unsigned)P << 8) |
                        (((unsigned)sl.match & 0xffu) << 16) |
                        ((unsigned)sl.gated << 24);
    for (unsigned m = cm; m; m &= m - 1) {  // into words n_cand, n_cand+1, ..
      const unsigned v = __shfl_sync(RA_FULL, my, __ffs(m) - 1);
      if (lane == n_cand) word = v;
      ++n_cand;
    }
    n_proc += __popc(pm);
    if (gap | sure) break;
  }
  // a candidate that could meet a skip break: the window across the lanes
  complex |= __any_sync(RA_FULL, lane < RA_CANDS && word &&
                                     (int)((word >> 8) & 0xffu) > max_skips);
  if (lane < RA_CANDS)
    reinterpret_cast<unsigned*>(rec + row + i)[lane] =
        complex ? RA_COMPLEX : word;
}

// Part (a) of an anchor a from its record: the candidates of slots
// d >= 2, with the scores read from the ring (f[a-2] and older), and
// their max. Branch-free: every word's slot is read (the ring index is
// masked, so any word gives a valid address) and selects keep the live
// ones.
struct RaNext {
  bool complex;  // the window walks across the lanes
  bool s1;       // slot 1 is a candidate (it can only be the first)
  float m1;      // its matching, NaN if it fails the gates
  float A;       // max(init, candidates of slots d >= 2)
  int dA;        // the first slot d >= 2 holding A when A > init
};

__device__ __forceinline__ unsigned ra_word(int4 rc, int k) {
  return (unsigned)(k == 0 ? rc.x : k == 1 ? rc.y : k == 2 ? rc.z : rc.w);
}

// The candidate value of word w for anchor a (0 when it fails the gates)
__device__ __forceinline__ float ra_value(unsigned w, const int* rf,
                                          int mask, int a) {
  const int d = w & 0xffu;
  const float m = (float)(int)(signed char)(w >> 16);
  const float fj = __int_as_float(rf[4 * ((a - d) & mask)]);
  return (w >> 24) & 1u ? __fadd_rn(fj, m) : 0.0f;
}

__device__ __forceinline__ void ra_next(RaNext& N, int4 rc, const int* rf,
                                        int mask, int a, float init) {
  N.complex = (unsigned)rc.x == RA_COMPLEX;
  const unsigned w0 = (unsigned)rc.x;
  N.s1 = (w0 & 0xffu) == 1u;
  N.m1 = (w0 >> 24) & 1u ? (float)(int)(signed char)(w0 >> 16)
                         : __int_as_float(0x7fc00000);
  float A = init;
  int dA = 0;
#pragma unroll
  for (int k = 0; k < RA_CANDS; ++k) {
    const unsigned w = ra_word(rc, k);
    const int d = w & 0xffu;
    const float v = ra_value(w, rf, mask, a);
    const bool up = d >= 2 && v > A;
    A = up ? v : A;
    dA = up ? d : dA;
  }
  N.A = A;
  N.dA = dA;
}

// One job: anchors [b, end) of the row, a DP whose windows stop at b.
__device__ __forceinline__ void ra_job(
    int4* ring, int4* stage, int mask, const int* __restrict__ s,
    const int* __restrict__ t, const int* __restrict__ q,
    const int4* __restrict__ rec, float* f, int* p, int b, int end,
    int window, int e, int max_gap, int max_target_gap, int max_skips,
    int lane) {
  const float init = (float)e;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0 .. lane
  int* rf = reinterpret_cast<int*>(ring) + 3;  // rf[4 * slot]: score bits
  const int4 zero = make_int4(0, 0, 0, 0);
  // anchors b .. b+31 into the rings, b+32 .. b+63 into registers
  int k = b + lane;
  ring[k & mask] = k < end ? make_int4(__ldg(s + k), __ldg(t + k),
                                       __ldg(q + k), 0) : zero;
  stage[k & (RA_STAGE - 1)] = k < end ? __ldg(rec + k) : zero;
  k += 32;
  int4 nxt = zero, nrc = zero;
  if (k < end) {
    nxt = make_int4(__ldg(s + k), __ldg(t + k), __ldg(q + k), 0);
    nrc = __ldg(rec + k);
  }
  __syncwarp();
  RaNext P;
  ra_next(P, stage[b & (RA_STAGE - 1)], rf, mask, b, init);
  int4 rc1 = stage[(b + 1) & (RA_STAGE - 1)];  // the next anchor's record
  float f_prev = init;
  for (int base = b; base < end; base += 32) {
    // the next block into the rings (its slots are past every window of
    // this block: R >= W + 64), and the one after into registers
    ring[(base + 32 + lane) & mask] = nxt;
    stage[(base + 32 + lane) & (RA_STAGE - 1)] = nrc;
    k = base + 64 + lane;
    nxt = nrc = zero;
    if (k < end) {
      nxt = make_int4(__ldg(s + k), __ldg(t + k), __ldg(q + k), 0);
      nrc = __ldg(rec + k);
    }
    __syncwarp();
    float my_score = 0.0f;
    int my_pred = base + lane;
    const int stop = base + 32 < end ? base + 32 : end;
    for (int i = base; i < stop; ++i) {
      // part (a) of anchor i+1 reads scores up to f[i-1]: independent of
      // anchor i's part (b) (at the job's end it reads stale slots and
      // is dropped)
      RaNext N;
      ra_next(N, rc1, rf, mask, i + 1, init);
      rc1 = stage[(i + 2) & (RA_STAGE - 1)];
      // part (b): slot 1 waits for f[i-1]; no candidate meets a skip
      // break: the first maximum over init and the candidates
      const float c1 = P.m1 == P.m1 ? __fadd_rn(f_prev, P.m1) : 0.0f;
      float best = P.s1 ? fmaxf(P.A, c1) : P.A;
      int pred = P.s1 && c1 > init && c1 >= P.A ? i - 1
                 : P.A > init                   ? i - P.dA
                                                : i;
      if (P.complex) {  // the whole window across the lanes
        best = init;
        pred = i;
        float carry_max = init;
        int carry_skips = 0;
        const int nwin = window < i - b ? window : i - b;
        const int4 c = ring[i & mask];
        for (int k0 = 0; k0 < nwin; k0 += 32)
          if (ra_chunk(ring, mask, i, k0, nwin, c, e, max_gap,
                       max_target_gap, max_skips, lane, upto, best, pred,
                       carry_max, carry_skips))
            break;
      }
      if (lane == i - base) {
        my_score = best;
        my_pred = pred;
      }
      rf[4 * (i & mask)] = __float_as_int(best);  // every lane: its own view
      f_prev = best;
      P = N;
    }
    if (base + lane < end) {
      f[base + lane] = my_score;
      p[base + lane] = my_pred;
    }
  }
}

// Launch 2. The rings live in shared memory (kDeviceRing false) or at
// gring, a ring per warp: one body, compiled for each, so the
// shared-memory kernel keeps shared loads and stores (a pointer that may
// be either compiles to generic ones, which measured 10% slower).
template <bool kDeviceRing>
__global__ void __launch_bounds__(RA_MAX_WARPS * 32, 1) ra_chain_dp_kernel(
    const int* __restrict__ seg, const int* __restrict__ tgt,
    const int* __restrict__ qry, const int* __restrict__ n_anchors, int A,
    int window, int ring_mask, int e, int max_gap, int max_target_gap,
    int max_skips, const int4* __restrict__ rec, float* __restrict__ scores,
    int* __restrict__ preds, int4* gring) {
  extern __shared__ int4 smem_rings[];
  __shared__ int4 s_stage[RA_MAX_WARPS * RA_STAGE];
  __shared__ unsigned long long s_keys[RA_JOBS];  // length << 32 | slab
  __shared__ int s_first[RA_JOBS];  // first run start of each slab on
  __shared__ int s_next;            // the next job to take
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nw = nthr >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int R = ring_mask + 1;
  int4* ring = kDeviceRing
                   ? gring + ((size_t)blockIdx.x * nw + warp) * (size_t)R
                   : smem_rings + (size_t)warp * R;
  int4* stage = s_stage + warp * RA_STAGE;
  const size_t row = (size_t)blockIdx.x * (size_t)A;
  const int* s = seg + row;
  const int* t = tgt + row;
  const int* q = qry + row;
  const int4* r = rec + row;
  float* f = scores + row;
  int* p = preds + row;
  int n = n_anchors[blockIdx.x];
  n = n < 0 ? 0 : (n > A ? A : n);
  for (int i = n + tid; i < A; i += nthr) {
    f[i] = 0.0f;
    p[i] = i;
  }
  // run starts, and the order check, in one pass over the row
  for (int k = tid; k < RA_JOBS; k += nthr) s_first[k] = n;
  if (tid == 0) s_next = 0;
  __syncthreads();
  bool bad = false;
#pragma unroll 4
  for (int k = tid; k < n; k += nthr) {
    const int sk = __ldg(s + k), tk = __ldg(t + k);
    const long long tg = (long long)tk + max_target_gap;
    bad |= tg > INT_MAX || tg < INT_MIN;
    bool start = k == 0;
    if (k) {
      const int sp = __ldg(s + k - 1), tp = __ldg(t + k - 1);
      bad |= sp > sk || (sp == sk && tp > tk);
      start = sp != sk || tp + max_target_gap < tk;
    }
    if (start) atomicMin(&s_first[(int)((long long)k * RA_JOBS / n)], k);
  }
  if (__syncthreads_or(bad))  // not sorted: the row is one run
    for (int k = tid; k < RA_JOBS; k += nthr) s_first[k] = k ? n : 0;
  __syncthreads();
  // a job starts at each slab's first run start and ends at the next
  // one: a suffix min over the slabs
  constexpr int kPer = RA_JOBS / 64;  // slabs a thread holds (nthr >= 64)
  for (int off = 1; off < RA_JOBS; off <<= 1) {
    int m[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = tid + u * nthr;
      if (k < RA_JOBS) {
        m[u] = s_first[k];
        if (k + off < RA_JOBS) m[u] = min(m[u], s_first[k + off]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = tid + u * nthr;
      if (k < RA_JOBS) s_first[k] = m[u];
    }
    __syncthreads();
  }
  for (int k = tid; k < RA_JOBS; k += nthr) {
    const int nx = k + 1 < RA_JOBS ? s_first[k + 1] : n;
    s_keys[k] = ((unsigned long long)(nx - s_first[k]) << 32) | (unsigned)k;
  }
  __syncthreads();
  // longest first: a bitonic sort, descending
  for (int size = 2; size <= RA_JOBS; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int u = tid; u < RA_JOBS / 2; u += nthr) {
        const int lo = 2 * u - (u & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = s_keys[lo], y = s_keys[hi];
        if (((lo & size) == 0) == (x < y)) {
          s_keys[lo] = y;
          s_keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (;;) {
    int jk = 0;
    if (lane == 0) jk = atomicAdd(&s_next, 1);
    jk = __shfl_sync(RA_FULL, jk, 0);
    if (jk >= RA_JOBS) break;
    const unsigned long long key = s_keys[jk];
    const int len = (int)(key >> 32);
    if (len == 0) break;
    const int b = s_first[(int)(key & 0xffffffffu)];
    ra_job(ring, stage, ring_mask, s, t, q, r, f, p, b, b + len, window, e,
           max_gap, max_target_gap, max_skips, lane);
  }
}

// Two launches for B reads of A anchor slots each (row-major,
// contiguous): the window pass, a warp per anchor, writing rec (B * A
// int4); then the recurrence, one block of `warps` warps
// (2 .. RA_MAX_WARPS) per read, each warp's ring of `ring` int4 slots (a
// power of two >= min(window, A) + 64) in 16 * ring * warps bytes of
// dynamic shared memory beside the job tables and record stages
// (RA_TABLE_BYTES + 1024 * RA_MAX_WARPS), or, when gring is not null, at
// gring + 4 * ring * (read * warps + warp) int32 (B * warps * 4 * ring).
extern "C" int ra_chain_dp(int device, const int* seg, const int* tgt,
                           const int* qry, const int* n_anchors, int B, int A,
                           int window, int ring, int warps, int e,
                           int max_gap, int max_target_gap, int max_skips,
                           int* rec, float* scores, int* preds, int* gring,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  if (warps < 2 || warps > RA_MAX_WARPS) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int4* r = reinterpret_cast<int4*>(rec);
  ra_chain_dp_kernel_window<<<dim3((A + 7) / 8, B), 256, 0, st>>>(
      seg, tgt, qry, n_anchors, A, window, e, max_gap, max_target_gap,
      max_skips, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (gring) {
    ra_chain_dp_kernel<true><<<B, 32 * warps, 0, st>>>(
        seg, tgt, qry, n_anchors, A, window, ring - 1, e, max_gap,
        max_target_gap, max_skips, r, scores, preds,
        reinterpret_cast<int4*>(gring));
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)ring * warps * sizeof(int4);
  if (smem + RA_TABLE_BYTES + 1024 * RA_MAX_WARPS > 48 * 1024) {
    err = cudaFuncSetAttribute(ra_chain_dp_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ra_chain_dp_kernel<false><<<B, 32 * warps, smem, st>>>(
      seg, tgt, qry, n_anchors, A, window, ring - 1, e, max_gap,
      max_target_gap, max_skips, r, scores, preds, nullptr);
  return (int)cudaGetLastError();
}
