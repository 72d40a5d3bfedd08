// Event detection: one read's raw signal chunk -> normalised events.
//
// Replaces rawalign_tpu/signal/events_pallas.py:peak_scan_pallas (its
// kernel body _make_kernel: prefix sums, the two t-statistic rows and the
// two-detector peak machine) together with the XLA code after it in
// rawalign_tpu/signal/events.py:detect_events_batch (peak compaction,
// event means, z-normalisation). Semantics are those of the golden
// detector and its C twin, native/rawalign_host.cpp:ra_detect_events
// (revent.c:22-188), and of the plain PyTorch version in
// rawalign_tpu_torch/signal/events.py, bit for bit:
//   - float32 prefix sums, sequential, the square rounded before the add;
//   - t = f32(|double(dm)| / sqrt(double(cv / w))), cv clamped at FLT_MIN
//     before the division, zero outside w <= i <= len - w;
//   - the peak machine of ra_gen_peaks;
//   - float32 event means, double sequential z-norm sums with each square
//     rounded in float32 first, IEEE double sqrt and division.
// Built with --fmad=false and without fast math or FTZ: no contraction,
// IEEE float and double division and sqrt, denormals kept (cv / w lands
// in the denormal range when cv is clamped).
//
// Every chunk is normalised over all of its events, then the first
// max_events are written: n_dropped = max(total - max_events, 0).
//
// What bounds it: latency, not bandwidth (a 32-read round moves about
// 0.5 MB). Bit-exactness leaves four loop-carried recurrences along one
// read: the float32 sum and the float32 sum of squares over L samples,
// the peak machine over L samples, and the two double z-norm sums over
// the events. One block per read, everything out of shared memory:
//   1. all threads stage the samples, coalesced;
//   2. lane 0 of warp 0 runs the sum, lane 0 of warp 1 the sum of
//      squares (independent chains, side by side), each loading the next
//      16 samples while it adds the current ones;
//   3. the two t rows are elementwise;
//   4. the peak machine in select form, split by detector (the
//      formulation of signal/events.py:_peaks_split_plain): the short
//      detector never reads the long one's state, and the long one needs
//      of the short one, per sample, only whether it masked it and up to
//      where. The short detector runs first and records that, the long
//      one second. Each detector's state is small and forgets its past
//      at every fire, so its recurrence is run in chunks, one lane per
//      chunk, all at once: in the first round every chunk starts from
//      the start state, which is right for the first chunk only; in
//      every later round the chunks whose start state was not the end
//      state of the chunk before them run again from that state. When a
//      round finds none, the row is exact. The first chunk that started
//      wrong in one round starts right in the next, so there are at most
//      as many rounds as chunks (the serial pass the sequential
//      semantics would cost throughout); a state that is wrong at a
//      chunk's start is as a rule right after the chunk's first fire, so
//      a read takes one or two rounds more than the first, and white
//      noise or long dwells five to eight on average (chip_smoke.py logs
//      them).
//      ra_event_reruns counts the chunks run again and the rounds;
//   5. the peak list in emission order (sample order, the short detector
//      first at one sample) and the event count are a ballot and prefix
//      pass of the whole block;
//   6. event means and the normalised output are elementwise; the two
//      z-norm sums run side by side on warps 0 and 1.
// The block's scratch is 5 rows of L + 1 words (rounded up to a multiple
// of 4): A the prefix sums; B the sums of squares, then the short
// detector's record, then the peak list; C the staged samples, then the
// short t row, then the long detector's peaks; D the long t row, then
// the event means; E the short detector's peaks. That is 80 KB at
// L = 4000, in dynamic shared memory; a chunk too long for shared memory
// gets the same layout in a device buffer the wrapper allocates, so L
// has no limit (the TPU kernel needed L < 8192 for its 13-bit packed
// peaks).

#include <cuda_runtime.h>
#include <stdint.h>

#define RA_EV_THREADS 512
// samples of a chunk, at least; chunks are odd so that the lanes of a
// warp, one chunk apart, fall on different banks
#define RA_EV_CHUNK 15
#define RA_EV_MAX_CHUNKS 256  // one lane each: at most RA_EV_THREADS
#define RA_EV_GROUP 16        // samples a sum loads ahead of its chain
#define RA_FLT_MAX 3.402823466e+38f
#define RA_FLT_MIN 1.17549435e-38f

// chunks of the peak machine run again, and rounds of such runs, since
// the last reset (all launches on this device)
__device__ unsigned long long ra_ev_reruns[2];

__device__ __forceinline__ float ra_tstat(const float* ps, const float* pss,
                                          int len, int w, int i) {
  if (w < 2 || len < 2 * w || i < w || i > len - w) return 0.0f;
  const float w32 = (float)w;
  float sum1 = ps[i];
  float sumsq1 = pss[i];
  if (i > w) {
    sum1 -= ps[i - w];
    sumsq1 -= pss[i - w];
  }
  const float sum2 = ps[i + w] - ps[i];
  const float sumsq2 = pss[i + w] - pss[i];
  const float mean1 = sum1 / w32;
  const float mean2 = sum2 / w32;
  const float m1s = mean1 * mean1;
  const float m2s = mean2 * mean2;
  const float cv0 = sumsq1 / w32 - m1s + sumsq2 / w32 - m2s;
  const float cv = cv0 > RA_FLT_MIN ? cv0 : RA_FLT_MIN;
  const float dm = mean2 - mean1;
  const float q = cv / w32;
  return (float)(fabs((double)dm) / sqrt((double)q));
}

// State of one detector of ra_gen_peaks.
struct RaDetector {
  int pos;     // sample of the running peak, -1 when none
  float val;   // the running minimum (no peak) or maximum (inside one)
  bool valid;  // the running peak has been confirmed
  int masked;  // long detector: last sample the short one masks, -1 when past
};

// One sample of one detector, in select form. ``act``: the detector is
// not masked at this sample. Returns the peak it fires, or -1; ``npos``
// and ``nval`` leave as the peak position and value after the update and
// before the fire (what the short detector masks the long one by).
__device__ __forceinline__ int ra_peak_step(RaDetector& d, bool act, int i,
                                            float cv, float thr, int half,
                                            float peak_height, int& npos,
                                            float& nval) {
  const bool idle = d.pos < 0;
  const bool up = cv > d.val;
  const bool deeper = cv < d.val;
  const bool rise = (cv - d.val) > peak_height;
  // no peak: follow the minimum, start a peak once the value rises
  // peak_height above it; inside a peak: follow the maximum
  const bool take = act && (idle ? (deeper || rise) : up);
  const bool mark = act && (idle ? (!deeper && rise) : up);
  nval = take ? cv : d.val;
  npos = mark ? i : d.pos;
  const bool busy = act && !idle;
  const bool valid =
      d.valid || (busy && (nval - cv) > peak_height && nval > thr);
  const bool fire = busy && valid && (i - npos) > half;
  d.pos = fire ? -1 : npos;
  d.val = fire ? cv : nval;
  d.valid = valid && !fire;
  return fire ? npos : -1;
}

__device__ __forceinline__ bool ra_same(const RaDetector& a,
                                        const RaDetector& b) {
  return a.pos == b.pos && __float_as_int(a.val) == __float_as_int(b.val) &&
         a.valid == b.valid && a.masked == b.masked;
}

// Samples [i0, i1) of detector K (0 the short one, 1 the long one) from
// state d, which leaves as the state before sample i1 (a mask that has
// ended is forgotten, so that equal behaviour is equal state). The short
// detector leaves in rec, per sample, the end of the mask it lays on the
// long one (its peak + w1 while it is inside a peak above its threshold)
// or -1; the long one reads it: masked, it starts over before it sees
// the sample. The peak fired at each sample (or -1) goes to em (int
// bits).
template <int K>
__device__ __forceinline__ void ra_run(RaDetector& d, int i0, int i1,
                                       const float* __restrict__ t,
                                       float* rec, float* __restrict__ em,
                                       float thr, int half, float peak_height,
                                       int w1) {
  for (int i = i0; i < i1; ++i) {
    const float cv = t[i];
    bool act = true;
    if (K == 1) {
      const int r = __float_as_int(rec[i]);
      const bool dom = r >= 0;
      d.masked = dom ? r : d.masked;
      d.pos = dom ? -1 : d.pos;
      d.val = dom ? RA_FLT_MAX : d.val;
      d.valid = d.valid && !dom;
      act = d.masked < i;
    }
    const bool inside = d.pos >= 0;
    int npos;
    float nval;
    const int p =
        ra_peak_step(d, act, i, cv, thr, half, peak_height, npos, nval);
    em[i] = __int_as_float(p);
    if (K == 0)
      rec[i] = __int_as_float(inside && nval > thr ? npos + w1 : -1);
  }
  d.masked = (K == 1 && d.masked >= i1) ? d.masked : -1;
}

// Detector K over samples 1 .. len-1 (both detectors skip sample 0: their
// mask ends start at 0), in n_chunks chunks of `chunk` samples, one lane
// each, in rounds; see the header. s_to[c] is the state chunk c ended in.
// Every thread of the block calls it; it ends in a barrier.
template <int K>
__device__ __forceinline__ void ra_detector(
    const float* t, float* rec, float* em, int len, int chunk, int n_chunks,
    float thr, int half, float peak_height, int w1, RaDetector* s_to) {
  const int tid = threadIdx.x;
  const int lo = 1 + tid * chunk;
  const int hi = lo + chunk < len ? lo + chunk : len;
  const RaDetector start = {-1, RA_FLT_MAX, false, -1};
  if (tid == 0 && len > 0) em[0] = __int_as_float(-1);
  RaDetector from = start;  // the state this lane's chunk last started in
  bool run = tid < n_chunks;
  for (;;) {
    if (run) {
      RaDetector d = from;
      ra_run<K>(d, lo, hi, t, rec, em, thr, half, peak_height, w1);
      s_to[tid] = d;
    }
    __syncthreads();
    const RaDetector before =
        tid > 0 && tid < n_chunks ? s_to[tid - 1] : start;
    run = !ra_same(from, before);
    from = before;
    const int n_again = __syncthreads_count(run);
    if (n_again == 0) break;
    if (tid == 0) {
      atomicAdd(&ra_ev_reruns[0], (unsigned long long)n_again);
      atomicAdd(&ra_ev_reruns[1], 1ull);
    }
  }
}

// out[i + 1] = out[i] + x[i] (or its square, rounded first), out[0] = 0,
// in sample order by the calling thread: the next RA_EV_GROUP samples are
// loaded while the current ones are added. xs is 16-byte aligned.
template <bool kSquare>
__device__ __forceinline__ void ra_prefix(const float* __restrict__ xs,
                                          float* __restrict__ out, int len) {
  float a = 0.0f;
  out[0] = 0.0f;
  float4 v[RA_EV_GROUP / 4];
  if (len >= RA_EV_GROUP) {
#pragma unroll
    for (int k = 0; k < RA_EV_GROUP / 4; ++k)
      v[k] = reinterpret_cast<const float4*>(xs)[k];
  }
  int i = 0;
  for (; i + RA_EV_GROUP <= len; i += RA_EV_GROUP) {
    // the group after this one; at the end this one again, unused
    const int j = i + 2 * RA_EV_GROUP <= len ? i + RA_EV_GROUP : i;
    float4 nv[RA_EV_GROUP / 4];
#pragma unroll
    for (int k = 0; k < RA_EV_GROUP / 4; ++k)
      nv[k] = reinterpret_cast<const float4*>(xs + j)[k];
#pragma unroll
    for (int k = 0; k < RA_EV_GROUP / 4; ++k) {
      const float u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float term = kSquare ? u[m] * u[m] : u[m];
        a += term;
        out[i + 4 * k + m + 1] = a;
      }
    }
#pragma unroll
    for (int k = 0; k < RA_EV_GROUP / 4; ++k) v[k] = nv[k];
  }
  for (; i < len; ++i) {
    const float u = xs[i];
    const float term = kSquare ? u * u : u;
    a += term;
    out[i + 1] = a;
  }
}

// kGlobal: the block's rows lie in the device buffer `scratch`, else in
// dynamic shared memory (two instances, so that the shared one addresses
// shared memory directly).
template <bool kGlobal>
__global__ void __launch_bounds__(RA_EV_THREADS) ra_event_detect_kernel(
    const float* __restrict__ sig, long long ld, const int* __restrict__ length,
    int L, int w1, int w2, float thr1, float thr2, float peak_height,
    int max_events, float* scratch, float* __restrict__ out,
    int* __restrict__ n_events, int* __restrict__ n_dropped) {
  static_assert(RA_EV_MAX_CHUNKS <= RA_EV_THREADS && RA_EV_THREADS >= 64,
                "one lane per chunk; warps 0 and 1 run the sums");
  extern __shared__ __align__(16) float smem[];
  __shared__ RaDetector s_to[RA_EV_MAX_CHUNKS];
  __shared__ int s_wcnt[32], s_win[32];
  __shared__ double s_sum, s_sum2;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const size_t W = ((size_t)L + 4) & ~(size_t)3;
  float* ps = kGlobal ? scratch + (size_t)b * 5 * W : smem;  // row A
  float* pss = ps + W;                                        // row B
  float* t1 = pss + W;                                        // row C
  float* t2 = t1 + W;                                         // row D
  float* em0 = t2 + W;  // row E: the short detector's peaks (int bits)
  float* xs = t1;       // the staged samples, dead once the sums stand
  float* rec = pss;     // the short detector's record (int bits)
  float* em1 = t1;      // the long detector's peaks, once t1 is dead
  float* peaks = pss;   // the peak list (int bits), once the record is dead
  float* ev = t2;       // the event means, once t2 is dead
  const float* x = sig + (size_t)b * (size_t)ld;
  int len = length[b];
  len = len < 0 ? 0 : (len > L ? L : len);

  // 1. the samples, coalesced
  for (int i = tid; i < len; i += T) xs[i] = x[i];
  __syncthreads();

  // 2. prefix sums, in sample order: two independent chains
  if (tid == 0) ra_prefix<false>(xs, ps, len);
  if (tid == 32) ra_prefix<true>(xs, pss, len);
  __syncthreads();

  // 3. both t-statistic rows; each element stands alone (row C stops
  //    holding the samples here)
  for (int i = tid; i < len; i += T) {
    const float a = ra_tstat(ps, pss, len, w1, i);
    const float c = ra_tstat(ps, pss, len, w2, i);
    t1[i] = a;
    t2[i] = c;
  }
  __syncthreads();

  // 4. the peak machine (ra_gen_peaks): the short detector, then the
  //    long one from its record
  int chunk = (len - 1 + RA_EV_MAX_CHUNKS - 1) / RA_EV_MAX_CHUNKS;
  chunk = (chunk > RA_EV_CHUNK ? chunk : RA_EV_CHUNK) | 1;
  const int n_chunks = len > 1 ? (len - 1 + chunk - 1) / chunk : 0;
  ra_detector<0>(t1, rec, em0, len, chunk, n_chunks, thr1, w1 / 2,
                 peak_height, w1, s_to);
  ra_detector<1>(t2, rec, em1, len, chunk, n_chunks, thr2, w2 / 2,
                 peak_height, w1, s_to);

  // 5. the peak list in emission order and the event count. Each warp
  //    takes a run of samples: it counts its peaks, then (its offset
  //    known) writes them, the short detector's before the long one's at
  //    the same sample. A detector fires at most every other sample, so
  //    the list is no longer than len.
  const int per = (((len + n_warps - 1) / n_warps) + 31) & ~31;
  const int lo = warp * per < len ? warp * per : len;
  const int hi = lo + per < len ? lo + per : len;
  const unsigned below = (1u << lane) - 1u;
  {
    int n_p = 0, n_in = 0;
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int p0 = i < hi ? __float_as_int(em0[i]) : -1;
      const int p1 = i < hi ? __float_as_int(em1[i]) : -1;
      n_p += __popc(__ballot_sync(0xFFFFFFFFu, p0 >= 0)) +
             __popc(__ballot_sync(0xFFFFFFFFu, p1 >= 0));
      n_in += __popc(__ballot_sync(0xFFFFFFFFu, p0 > 0 && p0 < len)) +
              __popc(__ballot_sync(0xFFFFFFFFu, p1 > 0 && p1 < len));
    }
    if (lane == 0) {
      s_wcnt[warp] = n_p;
      s_win[warp] = n_in;
    }
  }
  __syncthreads();
  int n_peaks = 0, n_inside = 0, off = 0;
  for (int w = 0; w < n_warps; ++w) {
    if (w < warp) off += s_wcnt[w];
    n_peaks += s_wcnt[w];
    n_inside += s_win[w];
  }
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int p0 = i < hi ? __float_as_int(em0[i]) : -1;
    const int p1 = i < hi ? __float_as_int(em1[i]) : -1;
    const unsigned b0 = __ballot_sync(0xFFFFFFFFu, p0 >= 0);
    const unsigned b1 = __ballot_sync(0xFFFFFFFFu, p1 >= 0);
    int at = off + __popc(b0 & below) + __popc(b1 & below);
    if (p0 >= 0) peaks[at++] = __int_as_float(p0);
    if (p1 >= 0) peaks[at] = __int_as_float(p1);
    off += __popc(b0) + __popc(b1);
  }
  __syncthreads();
  // events: the first peak opens one, every later peak inside the chunk
  // one more
  int n_ev = 0;
  if (n_peaks > 0) {
    const int first = __float_as_int(peaks[0]);
    n_ev = 1 + n_inside - (first > 0 && first < len ? 1 : 0);
  }

  // 6. event means: event k spans peaks[k-1] (or 0) to peaks[k]; the last
  //    one runs to the chunk end (row D stops holding t values here)
  for (int k = tid; k < n_ev; k += T) {
    const int end = k == n_ev - 1 ? len : __float_as_int(peaks[k]);
    const int start = k ? __float_as_int(peaks[k - 1]) : 0;
    ev[k] = (ps[end] - ps[start]) / ((float)end - (float)start);
  }
  __syncthreads();

  // 7. z-norm sums, in event order: two independent chains
  if (tid == 0) {
    double s = 0.0;
    int k = 0;
    for (; k + 8 <= n_ev; k += 8) {
      double v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (double)ev[k + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    for (; k < n_ev; ++k) s += (double)ev[k];
    s_sum = s;
  } else if (tid == 32) {
    double s2 = 0.0;
    int k = 0;
    for (; k + 8 <= n_ev; k += 8) {
      double v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sq = ev[k + j] * ev[k + j];
        v[j] = (double)sq;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s2 += v[j];
    }
    for (; k < n_ev; ++k) {
      const float sq = ev[k] * ev[k];
      s2 += (double)sq;
    }
    s_sum2 = s2;
  }
  __syncthreads();

  // 8. the first max_events normalised events, zero padded
  const int kept = n_ev < max_events ? n_ev : max_events;
  double mean = 0.0, std = 0.0;
  if (n_ev > 0) {
    mean = s_sum / (double)n_ev;
    const double mm = mean * mean;
    std = sqrt(s_sum2 / (double)n_ev - mm);
  }
  float* o = out + (size_t)b * (size_t)max_events;
  for (int k = tid; k < max_events; k += T)
    o[k] = k < kept ? (float)(((double)ev[k] - mean) / std) : 0.0f;
  if (tid == 0) {
    n_events[b] = kept;
    n_dropped[b] = n_ev > max_events ? n_ev - max_events : 0;
  }
}

// One launch for B reads. sig row r starts at sig + r * ld. scratch is
// null when the block's 5 rows fit in shared memory (smem_bytes of them),
// else a device buffer of B * 5 rows; a row is L + 1 floats rounded up to
// a multiple of 4.
extern "C" int ra_event_detect(
    int device, const float* sig, long long ld, const int* length, int B,
    int L, int w1, int w2, float thr1, float thr2, float peak_height,
    int max_events, float* scratch, long long smem_bytes, float* out,
    int* n_events, int* n_dropped, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return (int)cudaGetLastError();
  if (scratch) {
    ra_event_detect_kernel<true><<<B, RA_EV_THREADS, 0, (cudaStream_t)stream>>>(
        sig, ld, length, L, w1, w2, thr1, thr2, peak_height, max_events,
        scratch, out, n_events, n_dropped);
    return (int)cudaGetLastError();
  }
  if (smem_bytes > 32 * 1024) {
    err = cudaFuncSetAttribute(ra_event_detect_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ra_event_detect_kernel<false><<<B, RA_EV_THREADS, (size_t)smem_bytes,
                                  (cudaStream_t)stream>>>(
      sig, ld, length, L, w1, w2, thr1, thr2, peak_height, max_events,
      nullptr, out, n_events, n_dropped);
  return (int)cudaGetLastError();
}

// out[0], out[1] = chunks of the peak machine run again and rounds of
// such runs on `device` since the last reset; waits for the device.
extern "C" int ra_event_reruns(int device, unsigned long long* out,
                               int reset) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(out, ra_ev_reruns, sizeof(ra_ev_reruns));
  if (err != cudaSuccess || !reset) return (int)err;
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(ra_ev_reruns, zero, sizeof(zero));
}
