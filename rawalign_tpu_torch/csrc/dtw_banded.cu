// Descriptor-indexed banded DTW: every tile of a round in one launch.
//
// Replaces rawalign_tpu/map/dtw_pallas.py:_dtw_call (kernel body
// _kernel) together with dtw_pallas._panels_from_descs, i.e. everything
// dtw_pallas.dtw_banded_multi_indexed runs for a round: the reference's
// DTW_global_slantedbanded_antidiagonalwise (dtw.cpp:273-520) over tiles
// described by a (9, T) int32 descriptor array (rows a_base, off_a, n,
// b_base, off_b, m, lp, ls, excl; off_a and off_b address the TPU's
// pre-shifted panels and are not read here). The plain PyTorch versions
// are rawalign_tpu_torch/map/dtw.py: dtw_banded_round follows this
// kernel's formulation, dtw_banded_indexed the JAX kernel's, per class.
//
// Values come straight from the pools by descriptor: a base below lref
// indexes the reference pool, any other base the flattened event history
// at base - lref. There are no panels, rolls or pool concatenations.
//
// Per wavefront iteration it = 1 .. n-1 (dtw.cpp:350-491):
//   * band centre cr = floor(it*m/n) by Bresenham stepping (a >= b, so
//     it advances by at most one per iteration);
//   * when cr advanced (inc), the secondary anti-diagonal is computed and
//     rotates into the state (eff_dp0 = dp1, eff_dp1 = sec);
//   * the primary anti-diagonal is computed from the effective state;
//     odd-R tiles (lp < ls) keep primary element k at slot k+1 (the "+1
//     simplification"), even-R tiles at slot k;
//   * every cell is fminf(fminf(top, left), topleft) + fabsf(a - b), the
//     same float32 operands in the same order as the JAX package, so with
//     --fmad=false (nothing here could contract anyway) results are
//     bit-identical to the plain versions and to native.dtw_banded_batch
//     (NaN events aside: fminf drops a NaN operand, as torch.fmin does).
// d00 = |a[0]-b[0]| seeds the first cell and the exclude_last correction
// |a[n-1]-b[m-1]| is subtracted here. INF = 1e10 as in the JAX code;
// costs of about 1e10 are valid outputs.
//
// What bounds it on the card: each tile is a chain of n-1 dependent
// iterations; the bytes (both sequences once, the descriptors, one cost)
// take a fraction of a microsecond for a whole round. A round holds
// thousands of tiles of very different lengths (n 1..2048) and band
// widths (a few slots to a few hundred), so the round costs about its
// longest tile's chain, provided the chain steps are short and the other
// tiles fill the SMs around it. The design:
//
// * One launch per round, over a work list of jobs built on the host
//   (map/tiles.py:work_list), ordered by their longest tile, longest
//   first, so that the long chains start in the first wave. A job is a
//   block of RA_DTW_THREADS threads: either RA_DTW_WARPS tiles of one
//   lane width K, one tile per warp, or one wide tile for the whole block.
//   The job kind is uniform over the block; each tile's band width comes
//   from its own lp/ls, W = max(lp, ls) + 2 slots.
// * A warp tile keeps the two anti-diagonals in registers: lane l holds
//   slots l*K .. l*K+K-1 of dp0 and dp1 (K = 1, 2, 4: W <= 32 K). The
//   neighbours across a lane border come by __shfl_down_sync (the
//   secondary's left) and __shfl_up_sync (the primary's top and, when the
//   centre did not advance, its topleft); the secondary cell is computed
//   once per slot. No block barrier; every iteration runs the same
//   instructions, the centre's advance selecting the effective state
//   (branching on it measured 1.6x slower an iteration).
// * The special cases of the reference's recurrence at the band's edges
//   (slot 0 and 1, the last slot of each diagonal, the previous
//   iteration's inc) only ever replace a value that is already INF there,
//   so the warp form drops them: for odd R slot 0 of dp1 never leaves INF
//   (primary element -1 is out of range), nor slot ls of dp1 (the primary
//   fills slots 1..lp = ls-1), nor slot 0 of dp0 after an iteration
//   without inc; for even R the secondary's slot lp-1 is out of range.
//   Every slot past max(lp, ls) - 1 stays INF, which is why any width of
//   at least max(lp, ls) + 1 gives the same costs (the plain version
//   dtw_banded_round and tests/test_torch_dtw_round.py hold this).
// * A warp first stages its tile's two sequences (n + m floats) in its
//   part of the block's shared memory, coalesced, so the recurrence reads
//   its operands from shared memory and global latency stays out of it.
//   (Loading the next iteration's operands into registers ahead of the
//   step, the other way to the same end, measured slower: it spilled.)
// * A tile wider than 128 slots keeps a block with the two anti-diagonals
//   and their next buffers in shared memory (16 W bytes) and one barrier
//   per iteration, each thread recomputing its left neighbour's secondary
//   cell: 8 slots a lane took 2.3x as long as a block on bands of 129-256
//   slots (map/dtw_cuda.py:WARP_MAX_SLOTS).

#include <cuda_runtime.h>
#include <stdint.h>

#define RA_DTW_INF 1e10f
#define RA_FULL 0xffffffffu
#define RA_DTW_THREADS 256
#define RA_DTW_WARPS (RA_DTW_THREADS / 32)
#define RA_DTW_JOB (1 + RA_DTW_WARPS)  // ints per job: kind, then tiles

// One tile's descriptor, its sequences and its constants.
struct RaTile {
  const float* a;
  const float* b;
  int n, m, lp, ls, half_lp, half_ls, slot0;
  bool plm, ok;
  float d00, corr;
};

__device__ __forceinline__ RaTile ra_tile(const float* ref, long long lref,
                                          const float* hist, const int* descs,
                                          long long ld, int t) {
  RaTile T;
  const long long a_base = descs[t];
  const long long b_base = descs[3 * ld + t];
  T.n = descs[2 * ld + t];
  T.m = descs[5 * ld + t];
  T.lp = descs[6 * ld + t];
  T.ls = descs[7 * ld + t];
  const int excl = descs[8 * ld + t];
  T.a = a_base < lref ? ref + a_base : hist + (a_base - lref);
  T.b = b_base < lref ? ref + b_base : hist + (b_base - lref);
  T.plm = T.lp > T.ls;  // R even: the primary anti-diagonal is the longer
  T.half_lp = T.lp >> 1;
  T.half_ls = T.ls >> 1;
  T.slot0 = T.plm ? T.half_lp : T.half_lp + 1;
  T.ok = T.n > 0 && T.m > 0;
  T.d00 = T.ok ? fabsf(T.a[0] - T.b[0]) : 0.0f;
  T.corr = (excl != 0 && T.ok) ? fabsf(T.a[T.n - 1] - T.b[T.m - 1]) : 0.0f;
  return T;
}

// Bresenham step of the band centre: true iff floor(it*m/n) advanced.
__device__ __forceinline__ bool ra_advance(int& acc, int& cr, int m, int n) {
  const int acc2 = acc + m;
  const bool inc = acc2 >= n;
  acc = inc ? acc2 - n : acc2;
  cr += inc ? 1 : 0;
  return inc;
}

// ---------------------------------------------------------------- warp tile

// The operands of one iteration for a lane's K slots, and which of its
// cells lie in the band (bit j: slot j).
template <int K>
struct RaOps {
  float pa[K], pb[K], sa[K], sb[K];
  unsigned pin, sin;
};

// Loads iteration it's operands (centre cr) from the staged sequences:
// primary element k = kl + j at cell (p_i - k, p_j + k), secondary slot
// x = xl + j at cell (s_i - x, s_j + x); cells outside the band load
// nothing.
template <int K>
__device__ __forceinline__ void ra_load(RaOps<K>& o, const RaTile& T, int it,
                                        int cr, bool inc, int kl, int xl) {
  const int p_i = it + T.half_lp;
  const int p_j = cr - T.half_lp;
  const int o0p = max(max(0, p_i - T.n + 1), -p_j);
  const int o1p = min(min(T.lp, p_i + 1), T.m - p_j);
  const unsigned lenp = o1p > o0p ? (unsigned)(o1p - o0p) : 0u;
  const float* pa = T.a + (p_i - kl);
  const float* pb = T.b + (p_j + kl);
  o.pin = 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = (unsigned)(kl + j - o0p) < lenp;
    o.pin |= (unsigned)in << j;
    o.pa[j] = in ? pa[-j] : 0.0f;
    o.pb[j] = in ? pb[j] : 0.0f;
  }
  // the secondary only where the centre advanced (no branch: see ra_step)
  const int s_i = it + T.half_ls - 1;
  const int s_j = cr - T.half_ls;
  const int o0s = max(max(0, s_i - T.n + 1), -s_j);
  const int o1s = min(min(T.ls, s_i + 1), T.m - s_j);
  const unsigned lens = (inc && o1s > o0s) ? (unsigned)(o1s - o0s) : 0u;
  const float* sa = T.a + (s_i - xl);
  const float* sb = T.b + (s_j + xl);
  o.sin = 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = (unsigned)(xl + j - o0s) < lens;
    o.sin |= (unsigned)in << j;
    o.sa[j] = in ? sa[-j] : 0.0f;
    o.sb[j] = in ? sb[j] : 0.0f;
  }
}

// One wavefront iteration on a lane's K slots of dp0 (d0) and dp1 (d1),
// the same instructions whether or not the centre advanced (inc selects
// the effective state): a branch here would split the loop body and
// lengthen each iteration's chain.
template <int K>
__device__ __forceinline__ void ra_step(float (&d0)[K], float (&d1)[K],
                                        const RaOps<K>& o, bool inc, int lane) {
  // secondary slot x: top dp1[x], left dp1[x+1], topleft dp0[x] (INF
  // where the centre did not advance: no cell is in range)
  float right = __shfl_down_sync(RA_FULL, d1[0], 1);
  if (lane == 31) right = RA_DTW_INF;
  float e0[K], e1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float left = j + 1 < K ? d1[j + 1 < K ? j + 1 : j] : right;
    const float sec =
        (o.sin >> j & 1u)
            ? fminf(fminf(d1[j], left), d0[j]) + fabsf(o.sa[j] - o.sb[j])
            : RA_DTW_INF;
    e1[j] = inc ? sec : d1[j];  // eff_dp1
    e0[j] = inc ? d1[j] : d0[j];  // eff_dp0
  }
  // primary slot o: top eff_dp1[o-1], left eff_dp1[o], topleft
  // eff_dp0[o] where the centre advanced, else eff_dp0[o-1]
  float up1 = __shfl_up_sync(RA_FULL, e1[K - 1], 1);
  float up0 = __shfl_up_sync(RA_FULL, e0[K - 1], 1);
  if (lane == 0) up1 = up0 = RA_DTW_INF;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float top = j > 0 ? e1[j > 0 ? j - 1 : 0] : up1;
    const float topleft = inc ? e0[j] : (j > 0 ? e0[j > 0 ? j - 1 : 0] : up0);
    const float pri =
        (o.pin >> j & 1u)
            ? fminf(fminf(top, e1[j]), topleft) + fabsf(o.pa[j] - o.pb[j])
            : RA_DTW_INF;
    d0[j] = e1[j];
    d1[j] = pri;
  }
}

// A tile of band width <= 32 K on one warp; `stage` is the warp's part
// of shared memory, n + m floats at least.
template <int K>
__device__ void ra_dtw_warp(RaTile T, int lane, float* stage, float* out) {
  for (int i = lane; i < T.n; i += 32) stage[i] = T.a[i];
  for (int i = lane; i < T.m; i += 32) stage[T.n + i] = T.b[i];
  __syncwarp();
  T.a = stage;
  T.b = stage + T.n;
  const int xl = lane * K;            // secondary slot of j = 0
  const int kl = xl - (T.plm ? 0 : 1);  // primary element held in slot xl
  float d0[K], d1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    d0[j] = RA_DTW_INF;
    d1[j] = (xl + j == T.slot0) ? T.d00 : RA_DTW_INF;
  }
  RaOps<K> o;
  int acc = 0, cr = 0;
  for (int it = 1; it < T.n; ++it) {
    const bool inc = ra_advance(acc, cr, T.m, T.n);
    ra_load(o, T, it, cr, inc, kl, xl);
    ra_step(d0, d1, o, inc, lane);
  }
  float v = RA_DTW_INF;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (xl + j == T.slot0) v = d1[j];
  v = __shfl_sync(RA_FULL, v, T.slot0 / K);
  if (lane == 0) *out = v - T.corr;
}

// --------------------------------------------------------------- block tile

struct RaSec {
  const float* d0;
  const float* d1;
  const float* a;
  const float* b;
  int w, ls, o0, o1, s_i, s_j;
  bool plm, previnc;
};

// secondary anti-diagonal cell at slot x (dtw.cpp:361-414)
__device__ __forceinline__ float ra_sec(const RaSec& s, int x) {
  if (x < s.o0 || x >= s.o1) return RA_DTW_INF;
  const float top = (s.plm || x != 0) ? s.d1[x] : RA_DTW_INF;
  const float topleft = (s.plm || x != 0 || s.previnc) ? s.d0[x] : RA_DTW_INF;
  const float left =
      ((s.plm || x != s.ls - 1) && x + 1 < s.w) ? s.d1[x + 1] : RA_DTW_INF;
  return fminf(fminf(top, left), topleft) + fabsf(s.a[s.s_i - x] - s.b[s.s_j + x]);
}

// A tile of band width w (<= the launch's shared-memory rows) on the
// whole block: dp0, dp1 and their next buffers are four w-float rows.
__device__ void ra_dtw_block(const RaTile& T, int w, float* smem, float* out) {
  const int n = T.n, m = T.m, lp = T.lp, ls = T.ls;
  const bool plm = T.plm;
  const float* a = T.a;
  const float* b = T.b;
  float* d0 = smem;
  float* d1 = smem + w;
  float* n0 = smem + 2 * w;
  float* n1 = smem + 3 * w;
  for (int o = threadIdx.x; o < w; o += blockDim.x) {
    d0[o] = RA_DTW_INF;
    d1[o] = (o == T.slot0 && T.ok) ? T.d00 : RA_DTW_INF;
  }
  __syncthreads();

  int acc = 0, cr = 0;
  bool previnc = false;
  for (int it = 1; it < n; ++it) {
    const bool inc = ra_advance(acc, cr, m, n);
    RaSec s;
    s.d0 = d0; s.d1 = d1; s.a = a; s.b = b;
    s.w = w; s.ls = ls; s.plm = plm; s.previnc = previnc;
    s.s_i = it + T.half_ls - 1;
    s.s_j = cr - T.half_ls;
    s.o0 = max(max(0, s.s_i - n + 1), -s.s_j);
    s.o1 = min(min(ls, s.s_i + 1), m - s.s_j);
    const int p_i = it + T.half_lp;
    const int p_j = cr - T.half_lp;
    const int o0p = max(max(0, p_i - n + 1), -p_j);
    const int o1p = min(min(lp, p_i + 1), m - p_j);
    for (int o = threadIdx.x; o < w; o += blockDim.x) {
      // effective state at slots o and o-1 (eff_dp*_r), INF left of 0
      float e0_o, e1_o, e0_l, e1_l;
      if (inc) {
        e0_o = d1[o];
        e1_o = ra_sec(s, o);
        e0_l = o > 0 ? d1[o - 1] : RA_DTW_INF;
        e1_l = o > 0 ? ra_sec(s, o - 1) : RA_DTW_INF;
      } else {
        e0_o = d0[o];
        e1_o = d1[o];
        e0_l = o > 0 ? d0[o - 1] : RA_DTW_INF;
        e1_l = o > 0 ? d1[o - 1] : RA_DTW_INF;
      }
      const int k = plm ? o : o - 1;  // primary element held in slot o
      float pri = RA_DTW_INF;
      if (k >= o0p && k < o1p) {
        float top, topleft, left;
        if (plm) {
          top = o == 0 ? RA_DTW_INF : e1_l;
          topleft = inc ? e0_o : (o == 0 ? RA_DTW_INF : e0_l);
          left = (inc && o == lp - 1) ? RA_DTW_INF : e1_o;
        } else {
          top = (!inc && o == 1) ? RA_DTW_INF : e1_l;
          topleft = inc ? e0_o : ((o == 1 && !previnc) ? RA_DTW_INF : e0_l);
          left = e1_o;
        }
        pri = fminf(fminf(top, left), topleft) + fabsf(a[p_i - k] - b[p_j + k]);
      }
      n0[o] = e1_o;
      n1[o] = pri;
    }
    previnc = inc;
    float* tmp = d0; d0 = n0; n0 = tmp;
    tmp = d1; d1 = n1; n1 = tmp;
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = d1[T.slot0] - T.corr;
}

// ------------------------------------------------------------------- launch

// jobs[j * RA_DTW_JOB]: kind (0: the block runs tile jobs[.. + 1]; K: warp
// w runs tile jobs[.. + 1 + w] with K slots a lane, none if -1, staging
// it in shared memory at smem + w * stage). At least two blocks an SM: at
// most 128 registers a thread.
__global__ void __launch_bounds__(RA_DTW_THREADS, 2) ra_dtw_round_kernel(
    const float* __restrict__ ref, long long lref,
    const float* __restrict__ hist, const int* __restrict__ descs,
    long long ld, const int* __restrict__ jobs, int block_w, int stage,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int* job = jobs + (size_t)blockIdx.x * RA_DTW_JOB;
  const int kind = job[0];
  if (kind == 0) {
    const int t = job[1];
    const RaTile T = ra_tile(ref, lref, hist, descs, ld, t);
    ra_dtw_block(T, min(max(T.lp, T.ls) + 2, block_w), smem, out + t);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = job[1 + warp];
  if (t < 0) return;
  const RaTile T = ra_tile(ref, lref, hist, descs, ld, t);
  if (!T.ok) {  // an empty side: the band holds no cell
    if (lane == 0) out[t] = RA_DTW_INF;
    return;
  }
  float* st = smem + (size_t)warp * stage;
  switch (kind) {
    case 1: ra_dtw_warp<1>(T, lane, st, out + t); break;
    case 2: ra_dtw_warp<2>(T, lane, st, out + t); break;
    default: ra_dtw_warp<4>(T, lane, st, out + t); break;
  }
}

// One launch for a round of T tiles: descs row r of tile t at
// descs[r * ld + t], n_jobs jobs of RA_DTW_JOB ints (built by
// map/tiles.py:work_list), block_w the widest band a block job holds (0
// without block jobs), stage the most n + m of a warp job's tile. Dynamic
// shared memory: the larger of 16 * block_w and 4 * RA_DTW_WARPS * stage
// bytes.
extern "C" int ra_dtw_banded_round(int device, const float* ref,
                                   long long lref, const float* hist,
                                   const int* descs, long long ld,
                                   const int* jobs, int n_jobs, int block_w,
                                   int stage, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_jobs <= 0) return (int)cudaGetLastError();
  const size_t rows = 4 * (size_t)block_w;
  const size_t staged = (size_t)RA_DTW_WARPS * stage;
  const size_t smem = (rows > staged ? rows : staged) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ra_dtw_round_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ra_dtw_round_kernel<<<(unsigned int)n_jobs, RA_DTW_THREADS, smem,
                        (cudaStream_t)stream>>>(ref, lref, hist, descs, ld,
                                                jobs, block_w, stage, out);
  return (int)cudaGetLastError();
}
