// flax's bfloat16 LSTM cell scanned over a sequence, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// sonicsim_tpu_torch/ops/lstm_cell.py, whose bf16_lstm_scan_ref is the same
// function in plain PyTorch.
//
// Replaces no TPU kernel. The JAX package leaves this scan to XLA: flax's
// OptimizedLSTMCell under nn.RNN, where the carry, the kernels and the input
// are all bfloat16 (the JAX SegLSTM makes its zero carry in the input's
// dtype, sonicsim_tpu/models/skim.py:52-66). XLA then computes every op of
// the cell in float32 and rounds its result to bfloat16. With rnd() that
// rounding and z each gate's pre-activation (gates i, f, g, o):
//
//   dh   = rnd(rnd(h . W_hh^T) + b)          the dot in float32 over bf16 values
//   z    = rnd(dh + xp)                      xp = rnd(x . W_ih^T), given
//   s(z) = rnd(1 / rnd(rnd(exp(-z)) + 1))    i, f, o
//   g    = rnd(tanh(z_g))
//   c'   = rnd(rnd(f * c) + rnd(i * g))
//   h'   = rnd(o * rnd(tanh(c')))
//
// No library call computes this function: cuDNN's bfloat16 RNN keeps its
// gates and cell in float32 and rounds once.
//
// Design. One CTA per (tile of 16 rows, direction): the rows' recurrences
// are independent, so the tiles run in parallel and each walks its K steps
// alone (backward for a reversed direction). The step's product h . W_hh^T
// is one m16 x n(4H) x k(H) tile on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 out, each k tile's sum added in float32). Warp w owns
// hidden units [16w, 16w + 16) of all four gates: 8 n-tiles whose B
// fragments (its slice of W_hh, 128 registers at H = 128) stay in registers
// for the whole scan, and whose
// accumulators hold the i, f, g and o of the same (row, unit) in the same
// thread, so the rounded elementwise chain runs in registers and c never
// leaves them. h' goes to shared memory (double-buffered, one barrier per
// step) as the next step's A operand.
//
// Bound. Each input read once and each output written once: at SkiM's
// shapes (642 rows, 250 steps, H = 128, two directions) the projection's
// 329 MB and the output's 82 MB, 0.123 ms at 3.35 TB/s; the dots' 42 GFLOP
// are 0.043 ms at the dense bf16 peak. The 250-step dependence chain, one
// barrier and one product per step, bounds it first: at one CTA per SM only
// 82 of 132 SMs hold a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;  // rows of a tile: the m of mma.m16n8k16

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// flax's sigmoid as XLA expands it in bfloat16: each op rounded.
__device__ __forceinline__ float sigmoid_rounded(float z) {
  return rnd(1.0f / rnd(rnd(expf(-z)) + 1.0f));
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two bfloat16-exact floats as one word, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load2(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xp (N, K, D*4H), y (N, K, D*H), w_hh (D, 4H, H), bias (D, 4H),
// h0/c0/hn/cn (D, N, H): bfloat16 bits, contiguous. Bit d of reverse_mask
// walks direction d from step K-1 down to 0.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, q = lane % 4): A (16 x 16,
// row-major) a0 = (g, 2q..2q+1), a1 = (g+8, 2q..), a2 = (g, 2q+8..),
// a3 = (g+8, 2q+8..); B (16 x 8) b0 = (k 2q..2q+1, n g), b1 = (k 2q+8.., n g);
// the accumulator d0, d1 = (g, 2q..2q+1), d2, d3 = (g+8, 2q..2q+1).
template <int H>
__global__ void __launch_bounds__(2 * H, 1)
bf16_lstm_scan_kernel(const uint16_t* __restrict__ xp,
                      const uint16_t* __restrict__ w_hh,
                      const uint16_t* __restrict__ bias,
                      const uint16_t* __restrict__ h0,
                      const uint16_t* __restrict__ c0,
                      uint16_t* __restrict__ y, uint16_t* __restrict__ hn,
                      uint16_t* __restrict__ cn, int n, int k_len, int dirs,
                      unsigned reverse_mask) {
  constexpr int KT = H / 16;  // k tiles of the product; also the warps
  constexpr int G = 4 * H;
  constexpr int LD = H + 8;  // row stride in shared memory: conflict-free
  __shared__ __align__(16) uint16_t sh[2][kRows][LD];
  __shared__ float sb[G];

  const int d = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int u0 = warp * 16;
  const bool rev = (reverse_mask >> d) & 1u;
  const int64_t xs = int64_t(dirs) * G, ys = int64_t(dirs) * H;

  // This warp's B fragments: n-tile t is gate t / 2, units u0 + 8 (t % 2) +
  // [0, 8); B[k][col] = W_hh[col][k], so each pair is adjacent in W_hh.
  uint32_t bw[8][KT][2];
  const uint16_t* wd = w_hh + int64_t(d) * G * H;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = (t >> 1) * H + u0 + 8 * (t & 1) + gq;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      bw[t][kt][0] = load2(wd + int64_t(col) * H + kt * 16 + 2 * tq);
      bw[t][kt][1] = load2(wd + int64_t(col) * H + kt * 16 + 8 + 2 * tq);
    }
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    sb[i] = __bfloat162float(
        __ushort_as_bfloat16(bias[int64_t(d) * G + i]));
  }

  // The thread's (row, unit) pairs: rows gq + 8 hr, units u0 + 8 s + 2 tq
  // + e. Its c stays here; h goes to shared memory.
  float c[2][2][2];
  uint32_t hlast[2][2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + gq + 8 * hr;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int u = u0 + 8 * s + 2 * tq;
      uint32_t hv = 0, cv = 0;
      if (row < n) {
        const int64_t at = (int64_t(d) * n + row) * H + u;
        hv = load2(h0 + at);
        cv = load2(c0 + at);
      }
      const float2 cf = unpack2(cv);
      c[hr][s][0] = cf.x;
      c[hr][s][1] = cf.y;
      hlast[hr][s] = hv;
      *reinterpret_cast<uint32_t*>(&sh[0][gq + 8 * hr][u]) = hv;
    }
  }
  __syncthreads();

  int buf = 0;
  for (int step = 0; step < k_len; ++step) {
    const int t = rev ? k_len - 1 - step : step;
    // The step's projections, issued before the product to hide their
    // latency: [hr][s][gate], two units a word.
    uint32_t xv[2][2][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + gq + 8 * hr;
      const uint16_t* xr = xp + (int64_t(row) * k_len + t) * xs + int64_t(d) * G;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xv[hr][s][q] = row < n ? load2(xr + q * H + u0 + 8 * s + 2 * tq) : 0u;
        }
      }
    }

    float acc[8][4];
#pragma unroll
    for (int t8 = 0; t8 < 8; ++t8) {
      acc[t8][0] = acc[t8][1] = acc[t8][2] = acc[t8][3] = 0.0f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      const int k = kt * 16 + 2 * tq;
      a[0] = *reinterpret_cast<const uint32_t*>(&sh[buf][gq][k]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sh[buf][gq + 8][k]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sh[buf][gq][k + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sh[buf][gq + 8][k + 8]);
      // Each k tile's products summed on the tensor cores from zero, the
      // tiles' sums added in float32 here: the tensor cores' own float32
      // accumulation rounds less exactly than an add, and a rounded gate
      // that flips carries through the recurrence.
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a, bw[t8][kt][0], bw[t8][kt][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t8][j] += part[j];
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + gq + 8 * hr;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int u = u0 + 8 * s + 2 * tq;
        float hnew[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 xf = unpack2(xv[hr][s][q]);
            const float dh = rnd(rnd(acc[2 * q + s][2 * hr + e]) + sb[q * H + u + e]);
            z[q] = rnd(dh + (e ? xf.y : xf.x));
          }
          const float ig = sigmoid_rounded(z[0]);
          const float fg = sigmoid_rounded(z[1]);
          const float gg = rnd(tanhf(z[2]));
          const float og = sigmoid_rounded(z[3]);
          const float cnew = rnd(rnd(fg * c[hr][s][e]) + rnd(ig * gg));
          c[hr][s][e] = cnew;
          hnew[e] = rnd(og * rnd(tanhf(cnew)));
        }
        const uint32_t hv = pack2(hnew[0], hnew[1]);
        hlast[hr][s] = hv;
        *reinterpret_cast<uint32_t*>(&sh[buf ^ 1][gq + 8 * hr][u]) = hv;
        if (row < n) {
          *reinterpret_cast<uint32_t*>(y + (int64_t(row) * k_len + t) * ys +
                                       int64_t(d) * H + u) = hv;
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + gq + 8 * hr;
    if (row >= n) continue;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int64_t at = (int64_t(d) * n + row) * H + u0 + 8 * s + 2 * tq;
      *reinterpret_cast<uint32_t*>(hn + at) = hlast[hr][s];
      *reinterpret_cast<uint32_t*>(cn + at) = pack2(c[hr][s][0], c[hr][s][1]);
    }
  }
}

template <int H>
int launch(const uint16_t* xp, const uint16_t* w_hh, const uint16_t* bias,
           const uint16_t* h0, const uint16_t* c0, uint16_t* y, uint16_t* hn,
           uint16_t* cn, int64_t n, int64_t k_len, int64_t dirs,
           unsigned reverse_mask, cudaStream_t st) {
  const dim3 grid(unsigned((n + kRows - 1) / kRows), unsigned(dirs));
  bf16_lstm_scan_kernel<H><<<grid, 2 * H, 0, st>>>(
      xp, w_hh, bias, h0, c0, y, hn, cn, int(n), int(k_len), int(dirs),
      reverse_mask);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was taken. 1
// (cudaErrorInvalidValue) for a hidden width the kernel has no instance of
// (a multiple of 16 up to 128).
extern "C" int sonicsim_bf16_lstm_scan(const void* xp, const void* w_hh,
                                       const void* bias, const void* h0,
                                       const void* c0, void* y, void* hn,
                                       void* cn, int64_t n, int64_t k_len,
                                       int64_t dirs, int64_t hidden,
                                       int64_t reverse_mask, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n == 0 || dirs == 0) return 0;
  const auto* x = static_cast<const uint16_t*>(xp);
  const auto* w = static_cast<const uint16_t*>(w_hh);
  const auto* b = static_cast<const uint16_t*>(bias);
  const auto* h = static_cast<const uint16_t*>(h0);
  const auto* c = static_cast<const uint16_t*>(c0);
  auto* yo = static_cast<uint16_t*>(y);
  auto* ho = static_cast<uint16_t*>(hn);
  auto* co = static_cast<uint16_t*>(cn);
  const unsigned mask = unsigned(reverse_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16: return launch<16>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 32: return launch<32>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 48: return launch<48>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 64: return launch<64>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 80: return launch<80>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 96: return launch<96>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 112: return launch<112>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    case 128: return launch<128>(x, w, b, h, c, yo, ho, co, n, k_len, dirs, mask, st);
    default: return int(cudaErrorInvalidValue);
  }
}
