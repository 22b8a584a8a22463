// Ownership select and crossfade combine for the moving-source render,
// hand-written for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by sonicsim_tpu_torch/ops/kernels.py.
//
// Replaces the two Pallas TPU kernels of sonicsim_tpu/ops/pallas_kernels.py:
//   select_segments_kernel   <- select_segments / _select_kernel (K1)
//   crossfade_combine_kernel <- crossfade_combine / _combine_kernel (K2)
//
// Both compute, for every output sample s of batch row b,
//   own(s)    = clip(searchsorted(off_true[b], s, 'right') - 1, 0, N-1)
//   within(s) = clip(s - off_al[b, own(s)], 0, span-1)
// and read window own(s) at position within(s): K1 copies the pre-combined
// value, K2 blends the (start, end) pair with the per-sample weight w[b, s].
// That is the general function of fftconv._fused_lerp_select and
// fftconv._ownership_combine, with no bound on segment length: the TPU
// kernels read at most two windows per 8192-sample block and are valid only
// when every segment is at least that long, so the blocked path there fell
// back to an XLA gather. Here one kernel serves both paths.
//
// Bound: device-memory bandwidth. Each output sample is one read (K1) or
// two reads plus a weight (K2) and one write, with no arithmetic to speak
// of: about 2 x B*C*T*4 bytes for K1 (184 MB at 12 sources x 2 channels x
// 960,000 samples). The design keeps every global access coalesced along T:
// a thread block owns one (batch, tile) of consecutive output samples,
// neighbouring threads take neighbouring samples, and inside a segment
// neighbouring samples read neighbouring window positions. The segment
// table (N <= a few hundred entries) sits in shared memory, so the
// per-sample binary search costs no device-memory traffic. Indices into
// the large tensors are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // output samples per thread
constexpr int64_t kTile = int64_t(kThreads) * kItems;

// Upper bound of s in the sorted table, minus one, clipped to [0, n-1].
__device__ __forceinline__ int owner(const int* off, int n, int64_t s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (int64_t(off[mid]) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int own = lo - 1;
  return own < 0 ? 0 : (own > n - 1 ? n - 1 : own);
}

__device__ __forceinline__ int64_t clip_within(int64_t v, int64_t span) {
  return v < 0 ? 0 : (v > span - 1 ? span - 1 : v);
}

// Stage the batch row's segment table in shared memory.
__device__ __forceinline__ void load_table(const int* off_true,
                                           const int* off_al, int* s_off,
                                           int* s_al, int64_t b, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_off[i] = off_true[b * n + i];
    s_al[i] = off_al[b * n + i];
  }
  __syncthreads();
}

// combined (B, N, C, span) -> out (B, C, T).
__global__ void __launch_bounds__(kThreads)
select_segments_kernel(const float* __restrict__ combined,
                       const int* __restrict__ off_true,
                       const int* __restrict__ off_al,
                       float* __restrict__ out, int n, int c, int64_t span,
                       int64_t t) {
  extern __shared__ int smem[];
  int* s_off = smem;
  int* s_al = smem + n;
  const int64_t b = blockIdx.y;
  load_table(off_true, off_al, s_off, s_al, b, n);

  const float* src = combined + b * n * c * span;
  float* dst = out + b * c * t;
  const int64_t base = int64_t(blockIdx.x) * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t s = base + int64_t(k) * kThreads;
    if (s < t) {
      const int own = owner(s_off, n, s);
      const int64_t within = clip_within(s - s_al[own], span);
      const float* p = src + int64_t(own) * c * span + within;
      for (int ch = 0; ch < c; ++ch) {
        dst[int64_t(ch) * t + s] = p[int64_t(ch) * span];
      }
    }
  }
}

// conv (B, N, 2, C, span), w (B, T) -> out (B, C, T).
__global__ void __launch_bounds__(kThreads)
crossfade_combine_kernel(const float* __restrict__ conv,
                         const float* __restrict__ w,
                         const int* __restrict__ off_true,
                         const int* __restrict__ off_al,
                         float* __restrict__ out, int n, int c, int64_t span,
                         int64_t t) {
  extern __shared__ int smem[];
  int* s_off = smem;
  int* s_al = smem + n;
  const int64_t b = blockIdx.y;
  load_table(off_true, off_al, s_off, s_al, b, n);

  const int64_t pair = int64_t(c) * span;  // start -> end window stride
  const float* src = conv + b * n * 2 * pair;
  const float* wb = w + b * t;
  float* dst = out + b * c * t;
  const int64_t base = int64_t(blockIdx.x) * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t s = base + int64_t(k) * kThreads;
    if (s < t) {
      const int own = owner(s_off, n, s);
      const int64_t within = clip_within(s - s_al[own], span);
      const float* p0 = src + int64_t(own) * 2 * pair + within;
      const float* p1 = p0 + pair;
      const float ws = wb[s];
      const float ws1 = __fsub_rn(1.0f, ws);
      for (int ch = 0; ch < c; ++ch) {
        const int64_t q = int64_t(ch) * span;
        // Rounded as the plain version is: (1 - w)*start + w*end with no
        // fused multiply-add, so the two agree bit for bit.
        dst[int64_t(ch) * t + s] =
            __fadd_rn(__fmul_rn(ws1, p0[q]), __fmul_rn(ws, p1[q]));
      }
    }
  }
}

dim3 grid_for(int64_t b, int64_t t) {
  return dim3(unsigned((t + kTile - 1) / kTile), unsigned(b));
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(): a refused launch never runs, and only this
// return value reports it.
extern "C" int sonicsim_select_segments(const float* combined,
                                        const int* off_true,
                                        const int* off_al, float* out,
                                        int64_t b, int64_t n, int64_t c,
                                        int64_t span, int64_t t, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (b == 0 || t == 0) return 0;
  const size_t smem = size_t(2 * n) * sizeof(int);
  select_segments_kernel<<<grid_for(b, t), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      combined, off_true, off_al, out, int(n), int(c), span, t);
  return int(cudaGetLastError());
}

extern "C" int sonicsim_crossfade_combine(const float* conv, const float* w,
                                          const int* off_true,
                                          const int* off_al, float* out,
                                          int64_t b, int64_t n, int64_t c,
                                          int64_t span, int64_t t,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (b == 0 || t == 0) return 0;
  const size_t smem = size_t(2 * n) * sizeof(int);
  crossfade_combine_kernel<<<grid_for(b, t), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      conv, w, off_true, off_al, out, int(n), int(c), span, t);
  return int(cudaGetLastError());
}
