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
// What bounds it: three loop-carried recurrences along one read (the
// prefix sums over L samples, the peak machine over L samples, the
// double sums over the events), i.e. latency, not bandwidth (a 32-read
// round moves about 0.5 MB). One block per read: thread 0 runs each
// recurrence out of shared memory, all threads compute the t-statistic
// rows, the event means and the normalised output, which are elementwise.
// The block's scratch is 4 (L + 1) words: prefix sums, sums of squares
// (reused for the peak positions once both t rows exist) and the two
// t rows (t1 reused for the event means). That is 64 KB at L = 4000, in
// dynamic shared memory; a chunk too long for shared memory gets the
// same layout in a device buffer the wrapper allocates, so L has no
// limit (the TPU kernel needed L < 8192 for its 13-bit packed peaks).

#include <cuda_runtime.h>
#include <stdint.h>

#define RA_EV_THREADS 256
#define RA_FLT_MAX 3.402823466e+38f
#define RA_FLT_MIN 1.17549435e-38f

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

__global__ void ra_event_detect_kernel(
    const float* __restrict__ sig, long long ld, const int* __restrict__ length,
    int L, int w1, int w2, float thr1, float thr2, float peak_height,
    int max_events, float* __restrict__ scratch, float* __restrict__ out,
    int* __restrict__ n_events, int* __restrict__ n_dropped) {
  extern __shared__ float smem[];
  __shared__ int s_n_ev;
  __shared__ double s_mean, s_std;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t words = 4 * ((size_t)L + 1);
  float* ps = scratch ? scratch + (size_t)b * words : smem;
  float* pss = ps + (L + 1);
  float* t1 = pss + (L + 1);
  float* t2 = t1 + (L + 1);
  int* peaks = reinterpret_cast<int*>(pss);  // pss is dead once t1, t2 exist
  float* ev = t1;                            // t1 is dead once peaks exist
  const float* x = sig + (size_t)b * (size_t)ld;
  int len = length[b];
  len = len < 0 ? 0 : (len > L ? L : len);

  // 1. prefix sums, in sample order
  if (tid == 0) {
    float a = 0.0f, q = 0.0f;
    ps[0] = 0.0f;
    pss[0] = 0.0f;
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const float v = x[i];
      a += v;
      const float sq = v * v;
      q += sq;
      ps[i + 1] = a;
      pss[i + 1] = q;
    }
  }
  __syncthreads();

  // 2. both t-statistic rows; each element stands alone
  for (int i = tid; i < len; i += blockDim.x) {
    t1[i] = ra_tstat(ps, pss, len, w1, i);
    t2[i] = ra_tstat(ps, pss, len, w2, i);
  }
  __syncthreads();

  // 3. the two-detector peak machine (ra_gen_peaks), then the event count
  if (tid == 0) {
    int masked_to[2] = {0, 0};
    int pos[2] = {-1, -1};
    float val[2] = {RA_FLT_MAX, RA_FLT_MAX};
    bool valid[2] = {false, false};
    const float thr[2] = {thr1, thr2};
    const int win[2] = {w1, w2};
    const float* tk[2] = {t1, t2};
    int np = 0;
    for (int i = 0; i < len; ++i) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (masked_to[k] >= i) continue;
        const float cv = tk[k][i];
        if (pos[k] == -1) {
          if (cv < val[k]) {
            val[k] = cv;
          } else if (cv - val[k] > peak_height) {
            val[k] = cv;
            pos[k] = i;
          }
        } else {
          if (cv > val[k]) {
            val[k] = cv;
            pos[k] = i;
          }
          if (k == 0 && val[0] > thr[0]) {
            masked_to[1] = pos[0] + win[0];
            pos[1] = -1;
            val[1] = RA_FLT_MAX;
            valid[1] = false;
          }
          if (val[k] - cv > peak_height && val[k] > thr[k]) valid[k] = true;
          if (valid[k] && (i - pos[k]) > win[k] / 2) {
            // a detector fires at most every other sample: np <= len
            peaks[np++] = pos[k];
            pos[k] = -1;
            val[k] = cv;
            valid[k] = false;
          }
        }
      }
    }
    int n_ev = 0;
    if (np > 0) {
      n_ev = 1;
      for (int k = 1; k < np; ++k)
        if (peaks[k] > 0 && peaks[k] < len) ++n_ev;
    }
    s_n_ev = n_ev;
  }
  __syncthreads();
  const int n_ev = s_n_ev;

  // 4. event means: event k spans peaks[k-1] (or 0) to peaks[k]; the last
  //    one runs to the chunk end
  for (int k = tid; k < n_ev; k += blockDim.x) {
    const int end = k == n_ev - 1 ? len : peaks[k];
    const int start = k ? peaks[k - 1] : 0;
    ev[k] = (ps[end] - ps[start]) / ((float)end - (float)start);
  }
  __syncthreads();

  // 5. z-norm sums, in event order
  if (tid == 0 && n_ev > 0) {
    double s = 0.0, s2 = 0.0;
    for (int k = 0; k < n_ev; ++k) {
      s += (double)ev[k];
      const float sq = ev[k] * ev[k];
      s2 += (double)sq;
    }
    const double mean = s / (double)n_ev;
    const double mm = mean * mean;
    s_mean = mean;
    s_std = sqrt(s2 / (double)n_ev - mm);
  }
  __syncthreads();

  // 6. the first max_events normalised events, zero padded
  const int kept = n_ev < max_events ? n_ev : max_events;
  float* o = out + (size_t)b * (size_t)max_events;
  for (int k = tid; k < max_events; k += blockDim.x)
    o[k] = k < kept ? (float)(((double)ev[k] - s_mean) / s_std) : 0.0f;
  if (tid == 0) {
    n_events[b] = kept;
    n_dropped[b] = n_ev > max_events ? n_ev - max_events : 0;
  }
}

// One launch for B reads. sig row r starts at sig + r * ld. scratch is
// null when the 4 (L + 1) words of a block fit in shared memory
// (smem_bytes of them), else a device buffer of B * 4 (L + 1) floats.
extern "C" int ra_event_detect(
    int device, const float* sig, long long ld, const int* length, int B,
    int L, int w1, int w2, float thr1, float thr2, float peak_height,
    int max_events, float* scratch, long long smem_bytes, float* out,
    int* n_events, int* n_dropped, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return (int)cudaGetLastError();
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(ra_event_detect_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ra_event_detect_kernel<<<B, RA_EV_THREADS, (size_t)smem_bytes,
                           (cudaStream_t)stream>>>(
      sig, ld, length, L, w1, w2, thr1, thr2, peak_height, max_events,
      scratch, out, n_events, n_dropped);
  return (int)cudaGetLastError();
}
