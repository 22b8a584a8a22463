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
// and read window own(s) at position within(s). K1 copies the window's
// value (select form) or applies the crossfade ramp as it reads (ramp
// form, below); K2 blends a (start, end) pair with the per-sample weight
// w[b, s]. That is the general function of fftconv._fused_lerp_select and
// fftconv._ownership_combine, with no bound on segment length: the TPU
// kernels read at most two windows per 8192-sample block and are valid only
// when every segment is at least that long, so the blocked path there fell
// back to an XLA gather. Here one kernel serves both paths.
//
// Bound: device-memory bandwidth. Each output sample is one read (K1
// select form), two reads (K1 ramp form) or two reads plus a weight (K2),
// and one write, with a few flops at most. Every global access is coalesced
// along T: a thread block owns one (batch, tile) of consecutive output
// samples, neighbouring threads take neighbouring samples, and inside a
// segment neighbouring samples read neighbouring window positions. The
// segment table sits in shared memory. Indices into the large tensors are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // K2: output samples per thread
constexpr int64_t kTile = int64_t(kThreads) * kItems;

// K1: each thread takes kGroups runs of kVec consecutive output samples
// (one float4 store per run and channel), kChunk channels at a time.
constexpr int kVec = 4;
constexpr int kGroups = 2;
constexpr int kChunk = 2;
constexpr int64_t kSelectTile = int64_t(kThreads) * kGroups * kVec;

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

// K1. Windows (B, N, C, span) whose row (b, i, ch) starts at
// ((b*N + i)*C + ch)*rs, rs >= span: the irfft outputs sliced in place.
// Select form (kRamp false):  out[b, ch, s] = conv_s[b, own, ch, u]
// Ramp form (kRamp true):     out[b, ch, s] = conv_s[b, own, ch, u]
//                               + ((u + shift[b, own]) * scale[b, own])
//                                 * conv_d[b, own, ch, u]
// with u = within(s). Written for what held the first K1 at half of the
// memory bandwidth:
// - one owner search per tile (its first and last samples); between them
//   each thread steps forward at the segment starts it passes, so a tile
//   inside one segment, the common case, does no search per sample;
// - every load of a channel chunk is issued before any arithmetic or store;
// - the output rows are 16-byte aligned when T % 4 == 0, so each run of 4
//   samples is one float4 store. The loads stay scalar (read-only path):
//   the window offset l-1 leaves them misaligned by (l-1+s) mod 4, and the
//   4 loads of a run hit the same L1 lines.
// - at most 80 registers a thread, so 3 blocks share an SM (the ramp form
//   takes 100 unbounded, which leaves 2, and was slower).
// The ramp rounds as its plain version does: (u + shift) * scale, then
// conv_s + w * conv_d, each rounded, with no fused multiply-add.
template <bool kRamp>
__global__ void __launch_bounds__(kThreads, 3)
select_segments_kernel(const float* __restrict__ conv_s,
                       const float* __restrict__ conv_d,
                       const float* __restrict__ shift,
                       const float* __restrict__ scale,
                       const int* __restrict__ off_true,
                       const int* __restrict__ off_al,
                       float* __restrict__ out, int n, int c, int64_t span,
                       int64_t rs, int64_t t) {
  extern __shared__ int smem[];
  int* s_off = smem;
  int* s_al = smem + n;
  const int64_t b = blockIdx.y;
  load_table(off_true, off_al, s_off, s_al, b, n);

  const int64_t tile0 = int64_t(blockIdx.x) * kSelectTile;
  const int64_t tile_end = tile0 + kSelectTile < t ? tile0 + kSelectTile : t;
  const int o_last = owner(s_off, n, tile_end - 1);
  int own = owner(s_off, n, tile0);

  const int64_t win = int64_t(c) * rs;  // window i of row b at (b*n + i)*win
  const float* cs = conv_s + b * n * win;
  const float* cd = kRamp ? conv_d + b * n * win : nullptr;
  const float* sh_b = kRamp ? shift + b * n : nullptr;
  const float* sc_b = kRamp ? scale + b * n : nullptr;
  float sh = 0.0f, sc = 0.0f;
  if constexpr (kRamp) {
    sh = __ldg(sh_b + own);
    sc = __ldg(sc_b + own);
  }

  // Window offsets (and ramp weights) of this thread's samples. A sample
  // past T gets a valid offset too; only its store is skipped.
  int64_t pos[kGroups][kVec];
  float w[kGroups][kVec];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t s0 = tile0 + (int64_t(g) * kThreads + threadIdx.x) * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t s = s0 + j;
      if (own < o_last && int64_t(s_off[own + 1]) <= s) {
        do {
          ++own;
        } while (own < o_last && int64_t(s_off[own + 1]) <= s);
        if constexpr (kRamp) {
          sh = __ldg(sh_b + own);
          sc = __ldg(sc_b + own);
        }
      }
      const int64_t u = clip_within(s - s_al[own], span);
      pos[g][j] = int64_t(own) * win + u;
      if constexpr (kRamp) w[g][j] = __fmul_rn(__fadd_rn(float(u), sh), sc);
    }
  }

  float* dst = out + b * c * t;
  const bool vec = (t % kVec) == 0;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    float vs[kChunk][kGroups][kVec];
    float vd[kChunk][kGroups][kVec];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int64_t q = int64_t(c0 + k) * rs;
      if (c0 + k < c) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            vs[k][g][j] = __ldg(cs + pos[g][j] + q);
            if constexpr (kRamp) vd[k][g][j] = __ldg(cd + pos[g][j] + q);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (c0 + k >= c) break;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float r[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if constexpr (kRamp) {
            r[j] = __fadd_rn(vs[k][g][j], __fmul_rn(w[g][j], vd[k][g][j]));
          } else {
            r[j] = vs[k][g][j];
          }
        }
        const int64_t s0 =
            tile0 + (int64_t(g) * kThreads + threadIdx.x) * kVec;
        float* p = dst + int64_t(c0 + k) * t + s0;
        if (vec && s0 + kVec <= t) {
          *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            if (s0 + j < t) p[j] = r[j];
          }
        }
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

dim3 grid_for(int64_t b, int64_t t, int64_t tile) {
  return dim3(unsigned((t + tile - 1) / tile), unsigned(b));
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(): a refused launch never runs, and only this
// return value reports it.

// K1. conv_d == nullptr takes the select form (shift and scale unused).
extern "C" int sonicsim_select_segments(const float* conv_s,
                                        const float* conv_d,
                                        const float* shift,
                                        const float* scale,
                                        const int* off_true,
                                        const int* off_al, float* out,
                                        int64_t b, int64_t n, int64_t c,
                                        int64_t span, int64_t rs, int64_t t,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (b == 0 || t == 0 || c == 0) return 0;
  const size_t smem = size_t(2 * n) * sizeof(int);
  const dim3 grid = grid_for(b, t, kSelectTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (conv_d == nullptr) {
    select_segments_kernel<false><<<grid, kThreads, smem, st>>>(
        conv_s, nullptr, nullptr, nullptr, off_true, off_al, out, int(n),
        int(c), span, rs, t);
  } else {
    select_segments_kernel<true><<<grid, kThreads, smem, st>>>(
        conv_s, conv_d, shift, scale, off_true, off_al, out, int(n), int(c),
        span, rs, t);
  }
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
  crossfade_combine_kernel<<<grid_for(b, t, kTile), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      conv, w, off_true, off_al, out, int(n), int(c), span, t);
  return int(cudaGetLastError());
}
