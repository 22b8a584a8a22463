// flax's bfloat16 LSTM cell scanned over a sequence, forward and backward,
// hand-written for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// sonicsim_tpu_torch/ops/lstm_cell.py, whose *_ref functions are the same
// functions in plain PyTorch.
//
// Replaces no TPU kernel. The JAX package leaves this scan and its VJP to
// XLA: flax's OptimizedLSTMCell under nn.RNN, where the carry, the kernels
// and the input are all bfloat16 (the JAX SegLSTM makes its zero carry in
// the input's dtype, sonicsim_tpu/models/skim.py:52-66). XLA then computes
// every op of the cell in float32 and rounds its result to bfloat16. With
// rnd() that rounding and z each gate's pre-activation (gates i, f, g, o):
//
//   dh   = rnd(rnd(h . W_hh^T) + b)          the dot in float32 over bf16 values
//   z    = rnd(dh + xp)                      xp = rnd(x . W_ih^T), given
//   s(z) = rnd(1 / rnd(rnd(exp(-z)) + 1))    i, f, o
//   g    = rnd(tanh(z_g))
//   c'   = rnd(rnd(f * c) + rnd(i * g))
//   h'   = rnd(o * rnd(tanh(c')))
//
// and the VJP (bf16_lstm_scan_backward_ref says it op by op) walks the steps
// back with the cotangents of h and c in registers. No library call computes
// either: cuDNN's bfloat16 RNN keeps its gates and cell in float32.
//
// Four kernels:
//  * bf16_lstm_scan_kernel<H, false>: the forward (serving); its TRAIN
//    instance, the earlier training forward, is no longer launched;
//  * bf16_lstm_scan_train_kernel<H>: the training forward, which also
//    writes each step's rounded gates i, f, g, o and cells c', which the
//    backward reads;
//  * bf16_lstm_scan_backward_kernel<H>: the reverse scan, one product
//    dh_prev = rnd(dz . W_hh) a step;
//  * bf16_running_sum_kernel: the weight and bias gradients accumulated in
//    bfloat16 over the steps in the JAX transpose loop's order.
//
// Design of the serving forward scan (the training forward's and the
// backward's are at their kernels). One CTA per
// (tile of 16 rows, direction), H / 8 warps: the rows' recurrences are
// independent, so the tiles run in parallel and each walks its K steps
// alone. A step's product is one m16 x n x k tile on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 out); each k tile's product is summed
// from zero on the tensor cores and the k tiles' sums added in float32 here,
// since the tensor cores' own float32 accumulation rounds less exactly than
// an add and a rounded gate that flips carries through the recurrence. Warp
// w owns hidden units [8w, 8w + 8) of all four gates, so the i, f, g and o
// of one (row, unit) meet in one thread, which keeps c in registers; its
// slice of W_hh (64 registers at H = 128) stays in registers for the whole
// scan. The step's new h goes to shared memory, double-buffered, as the next
// step's A operand: one barrier a step.
//
// What bounds a step at SkiM's shapes (a 250-step dependence chain; the
// bytes are 0.12 ms, the products 0.04 ms) is the rounded gate chain: three
// expf, three IEEE divisions and two tanhf for each (row, unit) and step.
// Each gate takes a bfloat16 input, so the CTA first tabulates sigma and
// tanh over the bfloat16 inputs whose magnitude lies in [2^-16, 2^8) with
// those same functions (24 KB of shared memory); a step then reads five
// entries per (row, unit) and computes directly only outside that window,
// bit for bit the same values. A step's inputs (the forward's projection
// tile, the backward's gate, c and dy tiles) come through a ring of four
// cp.async stages in shared memory, three steps ahead, off the chain; its
// outputs (y, dz) leave from shared memory in 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // rows of a forward tile: the m of mma.m16n8k16
constexpr int kBackRows = 8;  // rows of a backward tile: the n of mma.m16n8k16
constexpr int kStages = 4;    // the forward's projection ring
constexpr int kExpLo = 111;   // the gate tables: bf16 exponents [111, 135),
constexpr int kExps = 24;     // |z| in [2^-16, 2^8)
constexpr int kTable = 2 * kExps * 128;  // sign x exponent x mantissa

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// flax's sigmoid as XLA expands it in bfloat16: each op rounded.
__device__ __forceinline__ float sigmoid_rounded(float z) {
  return rnd(1.0f / rnd(rnd(expf(-z)) + 1.0f));
}

__device__ __forceinline__ float tanh_rounded(float z) { return rnd(tanhf(z)); }

// The bfloat16 bits of a bfloat16-exact float, and back.
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v) >> 16; }
__device__ __forceinline__ float from_bits(uint32_t b) { return __uint_as_float(b << 16); }

// The bfloat16-exact input at table entry i.
__device__ __forceinline__ float table_input(int i) {
  const uint32_t sign = uint32_t(i) / (kExps * 128);
  const uint32_t exp = (uint32_t(i) >> 7) % kExps + kExpLo;
  return from_bits((sign << 15) | (exp << 7) | (uint32_t(i) & 0x7fu));
}

// A table's entry for a bfloat16-exact z, and whether z lies outside the
// window (then the entry read is entry 0 and the caller computes the
// function itself). Branch-free, so the loads of a step's lookups can all be
// in flight at once.
__device__ __forceinline__ float lookup(const uint16_t* table, float z, bool& outside) {
  const uint32_t b = bits(z);
  const uint32_t e = ((b >> 7) & 0xffu) - kExpLo;
  outside = e >= uint32_t(kExps);
  return from_bits(table[outside ? 0u : ((((b >> 15) * kExps + e) << 7) | (b & 0x7fu))]);
}

__device__ void fill_tables(uint16_t* sig, uint16_t* tnh, int threads) {
  for (int i = threadIdx.x; i < kTable; i += threads) {
    const float z = table_input(i);
    sig[i] = uint16_t(bits(sigmoid_rounded(z)));
    tnh[i] = uint16_t(bits(tanh_rounded(z)));
  }
}

// The tanh table alone: the backward looks up tanh(c') and no sigmoid.
__device__ void fill_tanh(uint16_t* tnh, int threads) {
  for (int i = threadIdx.x; i < kTable; i += threads) {
    tnh[i] = uint16_t(bits(tanh_rounded(table_input(i))));
  }
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

// A fragment of rows [0, 16), columns [k0, k0 + 16) of a row-major tile
// with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile, int ld,
                                       int k0, int gq, int tq) {
  const int k = k0 + 2 * tq;
  a[0] = *reinterpret_cast<const uint32_t*>(tile + gq * ld + k);
  a[1] = *reinterpret_cast<const uint32_t*>(tile + (gq + 8) * ld + k);
  a[2] = *reinterpret_cast<const uint32_t*>(tile + gq * ld + k + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(tile + (gq + 8) * ld + k + 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// xp (N, K, D*4H), y (N, K, D*H), w_hh (D, 4H, H), bias (D, 4H),
// h0/c0/hn/cn (D, N, H), with TRAIN z_out (N, K, D*4H: the gates i, f, g, o
// as rounded) and c_out (N, K, D*H):
// bfloat16 bits, contiguous. Bit d of reverse_mask walks direction d from
// step K-1 down to 0.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, q = lane % 4): A (16 x 16,
// row-major) a0 = (g, 2q..2q+1), a1 = (g+8, 2q..), a2 = (g, 2q+8..),
// a3 = (g+8, 2q+8..); B (16 x 8) b0 = (k 2q..2q+1, n g), b1 = (k 2q+8.., n g);
// the accumulator d0, d1 = (g, 2q..2q+1), d2, d3 = (g+8, 2q..2q+1).
template <int H, bool TRAIN>
__global__ void __launch_bounds__(4 * H, 1)
bf16_lstm_scan_kernel(const uint16_t* __restrict__ xp,
                      const uint16_t* __restrict__ w_hh,
                      const uint16_t* __restrict__ bias,
                      const uint16_t* __restrict__ h0,
                      const uint16_t* __restrict__ c0,
                      uint16_t* __restrict__ y, uint16_t* __restrict__ hn,
                      uint16_t* __restrict__ cn, uint16_t* __restrict__ z_out,
                      uint16_t* __restrict__ c_out, int n, int k_len, int dirs,
                      unsigned reverse_mask) {
  constexpr int KT = H / 16;      // k tiles of the product
  constexpr int G = 4 * H;
  constexpr int THREADS = 4 * H;  // H / 8 warps
  constexpr int LD = H + 8;       // h row stride in shared memory: conflict-free
  constexpr int XLD = G + 8;      // projection row stride in the ring
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);  // [kStages][kRows][XLD]
  uint16_t* sh = ring + kStages * kRows * XLD;         // [2][kRows][LD]
  uint16_t* sig = sh + 2 * kRows * LD;                 // [kTable]
  uint16_t* tnh = sig + kTable;                        // [kTable]
  float* sb = reinterpret_cast<float*>(tnh + kTable);  // [G]

  const int d = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int u = warp * 8 + 2 * tq;  // the thread's units u, u + 1
  const bool rev = (reverse_mask >> d) & 1u;
  const int64_t xs = int64_t(dirs) * G, ys = int64_t(dirs) * H;

  // A step's projection tile is 16 rows x G / 8 16-byte chunks, two a
  // thread: rows xrow and xrow + 8, chunk xc8. Their addresses, but for the
  // step's offset, are fixed for the scan.
  const int xrow = threadIdx.x / (G / 8), xc8 = threadIdx.x % (G / 8);
  const uint16_t* xsrc[2];
  int xbytes[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r0 + xrow + 8 * j;
    xsrc[j] = xp + int64_t(min(row, n - 1)) * k_len * xs + int64_t(d) * G + xc8 * 8;
    xbytes[j] = row < n ? 16 : 0;  // zeros for rows past n
  }
  // Step `step`'s projection tile into ring slot step % kStages.
  auto issue = [&](int step) {
    const int64_t at = int64_t(rev ? k_len - 1 - step : step) * xs;
    uint16_t* slot = ring + (step % kStages) * kRows * XLD + xrow * XLD + xc8 * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) cp_async16(slot + 8 * j * XLD, xsrc[j] + at, xbytes[j]);
  };
  // A step's h is 16 rows x H / 8 chunks: one for each of the first 2H
  // threads, written to y from shared memory.
  const int yrow = threadIdx.x / (H / 8), yc8 = threadIdx.x % (H / 8);
  const bool ystore = threadIdx.x < 2 * H && r0 + yrow < n;
  uint16_t* ydst = y + int64_t(r0 + yrow) * k_len * ys + int64_t(d) * H + yc8 * 8;
  auto store_h = [&](const uint16_t* tile, int t) {
    if (ystore) {
      *reinterpret_cast<uint4*>(ydst + int64_t(t) * ys) =
          *reinterpret_cast<const uint4*>(tile + yrow * LD + yc8 * 8);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_len) issue(s);
    cp_async_commit();
  }

  // This warp's B fragments: n-tile q is gate q, units 8 warp + [0, 8);
  // B[k][col] = W_hh[col][k], so each pair is adjacent in W_hh.
  uint32_t bw[4][KT][2];
  const uint16_t* wd = w_hh + int64_t(d) * G * H;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = q * H + warp * 8 + gq;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      bw[q][kt][0] = load2(wd + int64_t(col) * H + kt * 16 + 2 * tq);
      bw[q][kt][1] = load2(wd + int64_t(col) * H + kt * 16 + 8 + 2 * tq);
    }
  }
  fill_tables(sig, tnh, THREADS);
  for (int i = threadIdx.x; i < G; i += THREADS) {
    sb[i] = __bfloat162float(__ushort_as_bfloat16(bias[int64_t(d) * G + i]));
  }

  // The thread's (row, unit) pairs: rows gq + 8 hr, units u + e. Its c
  // stays here; h goes to shared memory.
  float c[2][2];
  uint32_t hlast[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + gq + 8 * hr;
    uint32_t hv = 0, cv = 0;
    if (row < n) {
      const int64_t at = (int64_t(d) * n + row) * H + u;
      hv = load2(h0 + at);
      cv = load2(c0 + at);
    }
    const float2 cf = unpack2(cv);
    c[hr][0] = cf.x;
    c[hr][1] = cf.y;
    hlast[hr] = hv;
    *reinterpret_cast<uint32_t*>(sh + (gq + 8 * hr) * LD + u) = hv;
  }
  cp_async_wait<kStages - 2>();  // step 0's tile
  __syncthreads();

  int buf = 0;
  for (int step = 0; step < k_len; ++step) {
    const int t = rev ? k_len - 1 - step : step;
    // Three steps ahead; the slot was last read in step - 1, before its
    // barrier.
    if (step + kStages - 1 < k_len) issue(step + kStages - 1);
    cp_async_commit();
    const uint16_t* hb = sh + buf * kRows * LD;
    if (step > 0) store_h(hb, rev ? t + 1 : t - 1);  // the previous step's h

    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      load_a(a, hb, LD, kt * 16, gq, tq);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a, bw[q][kt][0], bw[q][kt][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] += part[j];
      }
    }

    const uint16_t* slot = ring + (step % kStages) * kRows * XLD;
    uint16_t* hnext = sh + (buf ^ 1) * kRows * LD;
    // One row at a time (registers): its cells' pre-activations [e][gate],
    // then every gate's lookup at once, the rare input outside the tables'
    // window computed after.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int lr = gq + 8 * hr, row = r0 + lr;
      float z[2][4], gv[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf =
            unpack2(*reinterpret_cast<const uint32_t*>(slot + lr * XLD + q * H + u));
        z[0][q] = rnd(rnd(rnd(acc[q][2 * hr]) + sb[q * H + u]) + xf.x);
        z[1][q] = rnd(rnd(rnd(acc[q][2 * hr + 1]) + sb[q * H + u + 1]) + xf.y);
      }
      bool outside = false;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bool o;
          gv[e][q] = lookup(q == 2 ? tnh : sig, z[e][q], o);
          outside |= o;
        }
      }
      if (outside) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            bool o;
            lookup(sig, z[e][q], o);
            if (o) gv[e][q] = q == 2 ? tanh_rounded(z[e][q]) : sigmoid_rounded(z[e][q]);
          }
        }
      }
      float cnew[2], tc[2];
      outside = false;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cnew[e] = rnd(rnd(gv[e][1] * c[hr][e]) + rnd(gv[e][0] * gv[e][2]));
        bool o;
        tc[e] = lookup(tnh, cnew[e], o);
        outside |= o;
      }
      if (outside) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool o;
          lookup(tnh, cnew[e], o);
          if (o) tc[e] = tanh_rounded(cnew[e]);
        }
      }
      c[hr][0] = cnew[0];
      c[hr][1] = cnew[1];
      const uint32_t hv = pack2(rnd(gv[0][3] * tc[0]), rnd(gv[1][3] * tc[1]));
      hlast[hr] = hv;
      *reinterpret_cast<uint32_t*>(hnext + lr * LD + u) = hv;
      if (TRAIN && row < n) {
        const int64_t zr = (int64_t(row) * k_len + t) * xs + int64_t(d) * G + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          *reinterpret_cast<uint32_t*>(z_out + zr + q * H) = pack2(gv[0][q], gv[1][q]);
        }
        *reinterpret_cast<uint32_t*>(c_out + (int64_t(row) * k_len + t) * ys +
                                     int64_t(d) * H + u) = pack2(cnew[0], cnew[1]);
      }
    }
    cp_async_wait<kStages - 2>();  // the next step's tile
    __syncthreads();
    buf ^= 1;
  }
  store_h(sh + buf * kRows * LD, rev ? 0 : k_len - 1);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + gq + 8 * hr;
    if (row >= n) continue;
    const int64_t at = (int64_t(d) * n + row) * H + u;
    *reinterpret_cast<uint32_t*>(hn + at) = hlast[hr];
    *reinterpret_cast<uint32_t*>(cn + at) = pack2(c[hr][0], c[hr][1]);
  }
}

// The training forward: bf16_lstm_scan_kernel's function, and each step's
// rounded gates i, f, g, o (z_out, N, K, D*4H) and cells c' (c_out, N, K,
// D*H) kept for the backward; the arguments as bf16_lstm_scan_kernel's.
// At SkiM's training shape the kept gates and cells are 3 in 4 of the bytes
// written (661.8 MB a call at 516 rows, 0.20 ms at 3.35 TB/s) and the step
// is a 250-step dependence chain. Its design is the backward's:
//  * 8-row tiles: 130 CTAs at 516 rows and two directions, where 16-row
//    tiles made 66 on 132 SMs;
//  * the product is z^T = W_hh . h^T: the mma's 16 rows are 16 units of one
//    gate, its 8 columns a tile's rows, so no row of it is padding; warp
//    pair (w, w + H / 16) holds W_hh for units [16 w, 16 w + 16) of all
//    four gates in registers, warp w the lower half of the k tiles (the
//    larger, for an odd count) and warp w + H / 16 the upper; the pair
//    trades halves through shared memory (a named barrier each step), and
//    each warp keeps 8 of the 16 units, so a thread holds 2 cells (rows 2 q,
//    2 q + 1 of the tile, one unit) with all four gates, and c stays in
//    registers: a chain of KT / 2 k tiles a step and 10 table lookups a
//    thread, where the earlier form had KT and 20;
//  * the step's gates, c' and h go to a double-buffered tile in shared
//    memory and leave it after the step's barrier in 16-byte stores, each
//    warp writing whole rows: the stores of step t overlap step t + 1.
// Each k tile's product is summed from zero on the tensor cores and added
// in float32, in order within each half; then the lower half's sum plus the
// upper half's. The projection ring and the gate tables are the forward's.
template <int H>
__global__ void __launch_bounds__(4 * H, 1)
bf16_lstm_scan_train_kernel(const uint16_t* __restrict__ xp,
                            const uint16_t* __restrict__ w_hh,
                            const uint16_t* __restrict__ bias,
                            const uint16_t* __restrict__ h0,
                            const uint16_t* __restrict__ c0,
                            uint16_t* __restrict__ y, uint16_t* __restrict__ hn,
                            uint16_t* __restrict__ cn, uint16_t* __restrict__ z_out,
                            uint16_t* __restrict__ c_out, int n, int k_len, int dirs,
                            unsigned reverse_mask) {
  constexpr int G = 4 * H;
  constexpr int KT = H / 16;         // k tiles of W_hh . h^T
  constexpr int KLO = (KT + 1) / 2;  // the lower half's, warps [0, UG)
  constexpr int KHI = KT / 2;        // the upper half's, warps [UG, 2 UG)
  constexpr int THREADS = 4 * H;     // H / 8 warps: H / 16 pairs
  constexpr int UG = H / 16;         // unit groups of 16, one a warp pair
  constexpr int ROWS = kBackRows;
  constexpr int CELLS = 2;           // a thread's cells: rows 2 tq, 2 tq + 1, one unit
  constexpr int XLD = G + 8;         // projection and gate row stride in shared memory
  constexpr int LD = H + 8;          // h and c row stride in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);  // [kStages][ROWS][XLD]
  uint16_t* sz = ring + kStages * ROWS * XLD;          // [2][ROWS][XLD], gates
  uint16_t* sh = sz + 2 * ROWS * XLD;                  // [2][ROWS][LD], h
  uint16_t* sc = sh + 2 * ROWS * LD;                   // [2][ROWS][LD], c'
  uint16_t* sig = sc + 2 * ROWS * LD;                  // [kTable]
  uint16_t* tnh = sig + kTable;                        // [kTable]
  float* xch = reinterpret_cast<float*>(tnh + kTable);  // [UG][2][4 * CELLS][32]

  const int d = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ug = warp % UG, kh = warp / UG;
  const int uc = 16 * ug + gq + 8 * kh;  // the thread's unit
  const bool rev = (reverse_mask >> d) & 1u;
  const int64_t xs = int64_t(dirs) * G, ys = int64_t(dirs) * H;

  // A[m][k] = W_hh[q H + 16 ug + m][k], gate q, for this warp's half of the
  // k tiles: each pair (k, k + 1) is adjacent in W_hh.
  uint32_t wa[4][KLO][4];
  const uint16_t* wd = w_hh + int64_t(d) * G * H;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < KLO; ++i) {
      const int kt = kh ? KLO + i : i;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int m = q * H + 16 * ug + gq + 8 * (f & 1), k = kt * 16 + 2 * tq + 8 * (f >> 1);
        wa[q][i][f] = kt < KT ? load2(wd + int64_t(m) * H + k) : 0u;
      }
    }
  }
  fill_tables(sig, tnh, THREADS);
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bq[q] = __bfloat162float(__ushort_as_bfloat16(bias[int64_t(d) * G + q * H + uc]));
  }

  // A step's projection tile and its gates are 8 rows x G / 8 16-byte
  // chunks, one a thread: row zrow, chunk zc8. Its h and c' are 8 rows x H /
  // 8 chunks: y from threads [0, H), c' from [H, 2 H), row orow, chunk oc8.
  const int zrow = threadIdx.x / (G / 8), zc8 = threadIdx.x % (G / 8);
  const int ot = threadIdx.x % H, orow = ot / (H / 8), oc8 = ot % (H / 8);
  const bool kstore = r0 + zrow < n;
  const bool ystore = threadIdx.x < H && r0 + orow < n;
  const bool cstore = threadIdx.x >= H && threadIdx.x < 2 * H && r0 + orow < n;
  const int64_t zbase = int64_t(min(r0 + zrow, n - 1)) * k_len * xs + int64_t(d) * G + zc8 * 8;
  const int64_t obase = int64_t(r0 + orow) * k_len * ys + int64_t(d) * H + oc8 * 8;
  // Step `step`'s projection tile into ring slot step % kStages, zeros for
  // rows past n.
  auto issue = [&](int step) {
    const int64_t at = int64_t(rev ? k_len - 1 - step : step) * xs;
    cp_async16(ring + (step % kStages) * ROWS * XLD + zrow * XLD + zc8 * 8, xp + zbase + at,
               kstore ? 16 : 0);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_len) issue(s);
    cp_async_commit();
  }

  auto bf = [](uint16_t v) { return __bfloat162float(__ushort_as_bfloat16(v)); };
  auto lrow = [&](int ci) { return 2 * tq + ci; };
  float c[CELLS], hlast[CELLS];
#pragma unroll
  for (int ci = 0; ci < CELLS; ++ci) {
    const int row = r0 + lrow(ci);
    const int64_t at = (int64_t(d) * n + row) * H + uc;
    const uint16_t hv = row < n ? h0[at] : uint16_t(0);
    c[ci] = row < n ? bf(c0[at]) : 0.0f;
    hlast[ci] = bf(hv);
    sh[lrow(ci) * LD + uc] = hv;
  }
  cp_async_wait<kStages - 2>();  // step 0's tile
  __syncthreads();

  float* mine = xch + (ug * 2 + kh) * 4 * CELLS * 32 + lane;
  const float* theirs = xch + (ug * 2 + (kh ^ 1)) * 4 * CELLS * 32 + lane;
  int buf = 0;
  for (int step = 0; step < k_len; ++step) {
    const int t = rev ? k_len - 1 - step : step;
    // Three steps ahead; the slot was last read in step - 1, before its
    // barrier.
    if (step + kStages - 1 < k_len) issue(step + kStages - 1);
    cp_async_commit();

    // z^T = W_hh . h^T over this warp's half of the k tiles; the
    // accumulator holds units gq (j = 0, 1) and gq + 8 (j = 2, 3) of rows
    // 2 tq, 2 tq + 1.
    const uint16_t* hb = sh + buf * ROWS * LD;
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
#pragma unroll
    for (int i = 0; i < KLO; ++i) {
      if (kh && i >= KHI) break;
      const uint16_t* hrow = hb + gq * LD + (kh ? KLO + i : i) * 16 + 2 * tq;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(hrow);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(hrow + 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, wa[q][i], b0, b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] += part[j];
      }
    }
    // This warp keeps its unit's sums and gives the other unit's.
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int ci = 0; ci < CELLS; ++ci) mine[(q * CELLS + ci) * 32] = kh ? acc[q][ci] : acc[q][2 + ci];
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + ug));  // the pair's halves

    const uint16_t* slot = ring + (step % kStages) * ROWS * XLD;
    uint16_t* zo = sz + buf * ROWS * XLD;
    uint16_t* ho = sh + (buf ^ 1) * ROWS * LD;
    uint16_t* co = sc + buf * ROWS * LD;
    // The cells' pre-activations, then every gate's lookup at once, the
    // rare input outside the tables' window computed after.
    float z[CELLS][4], gv[CELLS][4];
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float own = kh ? acc[q][2 + ci] : acc[q][ci], other = theirs[(q * CELLS + ci) * 32];
        const float dot = kh ? other + own : own + other;
        z[ci][q] = rnd(rnd(rnd(dot) + bq[q]) + bf(slot[lrow(ci) * XLD + q * H + uc]));
      }
    }
    bool outside = false;
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bool o;
        gv[ci][q] = lookup(q == 2 ? tnh : sig, z[ci][q], o);
        outside |= o;
      }
    }
    if (outside) {
#pragma unroll
      for (int ci = 0; ci < CELLS; ++ci) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bool o;
          lookup(sig, z[ci][q], o);
          if (o) gv[ci][q] = q == 2 ? tanh_rounded(z[ci][q]) : sigmoid_rounded(z[ci][q]);
        }
      }
    }
    float tc[CELLS];
    outside = false;
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      c[ci] = rnd(rnd(gv[ci][1] * c[ci]) + rnd(gv[ci][0] * gv[ci][2]));
      bool o;
      tc[ci] = lookup(tnh, c[ci], o);
      outside |= o;
    }
    if (outside) {
#pragma unroll
      for (int ci = 0; ci < CELLS; ++ci) {
        bool o;
        lookup(tnh, c[ci], o);
        if (o) tc[ci] = tanh_rounded(c[ci]);
      }
    }
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      const int lr = lrow(ci);
      hlast[ci] = rnd(gv[ci][3] * tc[ci]);
      ho[lr * LD + uc] = __bfloat16_as_ushort(__float2bfloat16_rn(hlast[ci]));
      co[lr * LD + uc] = __bfloat16_as_ushort(__float2bfloat16_rn(c[ci]));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        zo[lr * XLD + q * H + uc] = __bfloat16_as_ushort(__float2bfloat16_rn(gv[ci][q]));
      }
    }
    cp_async_wait<kStages - 2>();  // the next step's tile and outputs
    __syncthreads();
    // Step t's outputs, 16-byte stores from shared memory: each tile is
    // next written two steps on, after a barrier that follows these loads.
    if (kstore) {  // the kept gates
      *reinterpret_cast<uint4*>(z_out + zbase + int64_t(t) * xs) =
          *reinterpret_cast<const uint4*>(zo + zrow * XLD + zc8 * 8);
    }
    if (ystore) {  // y
      *reinterpret_cast<uint4*>(y + obase + int64_t(t) * ys) =
          *reinterpret_cast<const uint4*>(ho + orow * LD + oc8 * 8);
    }
    if (cstore) {  // the kept cells
      *reinterpret_cast<uint4*>(c_out + obase + int64_t(t) * ys) =
          *reinterpret_cast<const uint4*>(co + orow * LD + oc8 * 8);
    }
    buf ^= 1;
  }
#pragma unroll
  for (int ci = 0; ci < CELLS; ++ci) {
    const int row = r0 + lrow(ci);
    if (row >= n) continue;
    const int64_t at = (int64_t(d) * n + row) * H + uc;
    hn[at] = __bfloat16_as_ushort(__float2bfloat16_rn(hlast[ci]));
    cn[at] = __bfloat16_as_ushort(__float2bfloat16_rn(c[ci]));
  }
}

// The scan's VJP. dy (N, K, D*H), dhn/dcn/c0/dh0/dc0 (D, N, H), the training
// forward's gates (N, K, D*4H: i, f, g, o as it rounded them) and c (N, K,
// D*H), w_hh (D, 4H, H), dz (N, K, D*4H): bfloat16 bits, contiguous. Each
// (tile of 8 rows, direction) walks its steps from the last back to the
// first; a step reads that step's gates, c and dy and the previous step's c
// (c0 at the first), takes dh from the product of the step after it,
// rnd(dz_{t+1} . W_hh) on the tensor cores, and writes dz.
//
// The design (the earlier form, 16-row tiles that recomputed every gate from
// its pre-activation, timed with one part of its step taken out at a time:
// tests/bf16_cell_probe.py --backward-variants):
//  * the gates come from the training forward as it rounded them, so a
//    step looks up tanh(c') alone, not five functions a cell;
//  * 8-row tiles: 16-row tiles left half the SMs idle (130 CTAs at SkiM's
//    516 rows, two directions, where 16-row tiles made 66);
//  * the product is dh^T = W_hh^T . dz^T: the mma's 16 rows are units, its 8
//    columns a tile's rows, so no row of it is padding; warp pair (w, w + H /
//    16) holds W_hh^T for units [16 w, 16 w + 16) in registers, each warp
//    half the k tiles, and the pair adds its two float32 sums (a named
//    barrier each step); each warp then takes 8 of the 16 units. A chain of
//    KT / 2 k tiles a step, not KT;
//  * the previous step's c is the next walk position's, already in the
//    cp.async ring.
// Each k tile's product is still summed from zero on the tensor cores and
// the tiles' sums added in float32.
template <int H>
__global__ void __launch_bounds__(4 * H, 1)
bf16_lstm_scan_backward_kernel(const uint16_t* __restrict__ dy,
                               const uint16_t* __restrict__ dhn,
                               const uint16_t* __restrict__ dcn,
                               const uint16_t* __restrict__ gates,
                               const uint16_t* __restrict__ c,
                               const uint16_t* __restrict__ w_hh,
                               const uint16_t* __restrict__ c0,
                               uint16_t* __restrict__ dz, uint16_t* __restrict__ dh0,
                               uint16_t* __restrict__ dc0, int n, int k_len, int dirs,
                               unsigned reverse_mask) {
  constexpr int G = 4 * H;
  constexpr int KH = G / 32;      // k tiles of dz . W_hh a warp: half of them
  constexpr int THREADS = 4 * H;  // H / 8 warps: H / 16 pairs
  constexpr int UG = H / 16;      // unit groups of 16, one a warp pair
  constexpr int ROWS = kBackRows;
  constexpr int CELLS = 2;        // a thread's cells: rows 2 tq, 2 tq + 1, one unit
  constexpr int ZLD = G + 8;      // gate and dz row stride in shared memory
  constexpr int CLD = H + 8;      // c and dy row stride in shared memory
  constexpr int CTHREADS = ROWS * H / 8;  // threads that copy a c and a dy chunk
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* zring = reinterpret_cast<uint16_t*>(smem);  // [kStages][ROWS][ZLD], gates
  uint16_t* cring = zring + kStages * ROWS * ZLD;       // [kStages][ROWS][CLD]
  uint16_t* gring = cring + kStages * ROWS * CLD;       // [kStages][ROWS][CLD], dy
  uint16_t* sz = gring + kStages * ROWS * CLD;          // [2][ROWS][ZLD]
  uint16_t* tnh = sz + 2 * ROWS * ZLD;                  // [kTable]
  float* xch = reinterpret_cast<float*>(tnh + kTable);  // [UG][2][32][CELLS]

  const int d = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ug = warp % UG, kh = warp / UG;
  const int uc = 16 * ug + gq + 8 * kh;  // the thread's unit
  const bool rev = (reverse_mask >> d) & 1u;
  const int64_t zs = int64_t(dirs) * G, ys = int64_t(dirs) * H;

  // A[m][k] = W_hh[k][16 ug + m] for this warp's half of the k tiles: the
  // pair (k, k + 1) is H apart in W_hh.
  uint32_t wa[KH][4];
  const uint16_t* wd = w_hh + int64_t(d) * G * H + 16 * ug + gq;
#pragma unroll
  for (int i = 0; i < KH; ++i) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int k = (kh * KH + i) * 16 + 2 * tq + 8 * (f >> 1), m = 8 * (f & 1);
      wa[i][f] = uint32_t(wd[int64_t(k) * H + m]) | (uint32_t(wd[int64_t(k + 1) * H + m]) << 16);
    }
  }
  fill_tanh(tnh, THREADS);
  // A step's gate and dz tiles are 8 rows x G / 8 16-byte chunks, one a
  // thread: row zrow, chunk zc8; its c and dy tiles 8 rows x H / 8 chunks,
  // one for each of the first CTHREADS threads. Their addresses, but for
  // the step's offset, are fixed for the scan.
  const int zrow = threadIdx.x / (G / 8), zc8 = threadIdx.x % (G / 8);
  const int crow = threadIdx.x / (H / 8), cc8 = threadIdx.x % (H / 8);
  const bool cthread = threadIdx.x < CTHREADS;
  const bool zstore = r0 + zrow < n;
  uint16_t* const zdst = dz + int64_t(r0 + zrow) * k_len * zs + int64_t(d) * G + zc8 * 8;
  const uint16_t* const zsrc =
      gates + int64_t(min(r0 + zrow, n - 1)) * k_len * zs + int64_t(d) * G + zc8 * 8;
  const int crow_n = min(r0 + crow, n - 1);
  const int64_t cbase = int64_t(crow_n) * k_len * ys + int64_t(d) * H + cc8 * 8;
  const int64_t c0base = (int64_t(d) * n + crow_n) * H + cc8 * 8;
  const int cbytes = r0 + crow < n ? 16 : 0;
  // Walk position p's gate, c and dy tiles (step K - 1 - p) into ring slot
  // p % kStages, zeros for rows past n; position K is c0 alone, the c that
  // the first step read.
  auto issue = [&](int p) {
    const int slot = p % kStages;
    if (p == k_len) {
      if (cthread) cp_async16(cring + slot * ROWS * CLD + crow * CLD + cc8 * 8, c0 + c0base,
                              cbytes);
      return;
    }
    const int s = k_len - 1 - p, t = rev ? k_len - 1 - s : s;
    cp_async16(zring + slot * ROWS * ZLD + zrow * ZLD + zc8 * 8, zsrc + int64_t(t) * zs,
               zstore ? 16 : 0);
    if (cthread) {
      const int at = slot * ROWS * CLD + crow * CLD + cc8 * 8;
      cp_async16(cring + at, c + cbase + int64_t(t) * ys, cbytes);
      cp_async16(gring + at, dy + cbase + int64_t(t) * ys, cbytes);
    }
  };
  // Three positions ahead; a step reads its own slot and the next one's c.
  for (int p = 0; p < kStages - 1; ++p) {
    if (p <= k_len) issue(p);
    cp_async_commit();
  }

  // The thread's cells: rows lrow(ci) = 2 tq + ci, unit uc.
  auto lrow = [&](int ci) { return 2 * tq + ci; };
  float dh[CELLS], dc[CELLS];
#pragma unroll
  for (int ci = 0; ci < CELLS; ++ci) {
    const int row = r0 + lrow(ci);
    const int64_t at = (int64_t(d) * n + row) * H + uc;
    dh[ci] = row < n ? __bfloat162float(__ushort_as_bfloat16(dhn[at])) : 0.0f;
    dc[ci] = row < n ? __bfloat162float(__ushort_as_bfloat16(dcn[at])) : 0.0f;
  }
  cp_async_wait<kStages - 3>();  // the first step's tiles and the next one's c
  __syncthreads();

  // rnd(dz . W_hh) for the thread's cells, dz the tile in `tile`: this
  // warp's half of the k tiles, each summed from zero on the tensor cores
  // and added in float32, then the pair's two sums added (the lower k half's
  // first).
  auto product = [&](const uint16_t* tile, float (&out)[CELLS]) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      const int k = (kh * KH + i) * 16 + 2 * tq;
      const uint16_t* row = tile + gq * ZLD + k;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(part, wa[i], *reinterpret_cast<const uint32_t*>(row),
               *reinterpret_cast<const uint32_t*>(row + 8));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += part[j];
    }
    // The accumulator holds units gq (j = 0, 1) and gq + 8 (j = 2, 3) of
    // rows 2 tq, 2 tq + 1: this warp keeps its unit's, gives the other's.
    float* mine = xch + ((ug * 2 + kh) * 32 + lane) * CELLS;
    const float* theirs = xch + ((ug * 2 + (kh ^ 1)) * 32 + lane) * CELLS;
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) mine[ci] = acc[ci + 2 * (kh ^ 1)];
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + ug));
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      const float own = acc[ci + 2 * kh], other = theirs[ci];
      out[ci] = rnd(kh ? other + own : own + other);
    }
  };

  auto bf = [](uint16_t v) { return __bfloat162float(__ushort_as_bfloat16(v)); };
  int buf = 0;
  for (int step = k_len - 1; step >= 0; --step) {
    const int t = rev ? k_len - 1 - step : step;
    const int p = k_len - 1 - step;
    // Three positions ahead; the slot was last read at positions p - 1 and
    // p - 2, before their barriers.
    if (p + kStages - 1 <= k_len) issue(p + kStages - 1);
    cp_async_commit();
    if (step < k_len - 1) product(sz + buf * ROWS * ZLD, dh);
    const uint16_t* zslot = zring + (p % kStages) * ROWS * ZLD;
    const uint16_t* cslot = cring + (p % kStages) * ROWS * CLD;
    const uint16_t* pslot = cring + ((p + 1) % kStages) * ROWS * CLD;  // c before this step
    const uint16_t* gslot = gring + (p % kStages) * ROWS * CLD;
    uint16_t* out = sz + (buf ^ 1) * ROWS * ZLD;
    // The cells' tanh(c') looked up at once, the rare input outside the
    // table's window computed after.
    float tcv[CELLS];
    bool outside = false;
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      bool o;
      tcv[ci] = lookup(tnh, bf(cslot[lrow(ci) * CLD + uc]), o);
      outside |= o;
    }
    if (outside) {
#pragma unroll
      for (int ci = 0; ci < CELLS; ++ci) {
        bool o;
        const float cv = bf(cslot[lrow(ci) * CLD + uc]);
        lookup(tnh, cv, o);
        if (o) tcv[ci] = tanh_rounded(cv);
      }
    }
#pragma unroll
    for (int ci = 0; ci < CELLS; ++ci) {
      const int lr = lrow(ci);
      const uint16_t* gr = zslot + lr * ZLD + uc;
      const float ig = bf(gr[0]), fg = bf(gr[H]), gg = bf(gr[2 * H]), og = bf(gr[3 * H]);
      const float tc = tcv[ci], cprev = bf(pslot[lr * CLD + uc]);
      const float cth = rnd(dh[ci] + bf(gslot[lr * CLD + uc]));
      const float uu = rnd(rnd(og * cth) * rnd(1.0f - tc));
      const float dct = rnd(rnd(dc[ci] + uu) + rnd(uu * tc));
      const float v = rnd(rnd(ig * dct) * rnd(1.0f - gg));
      uint16_t* o = out + lr * ZLD + uc;
      o[0] = __bfloat16_as_ushort(__float2bfloat16_rn(rnd(dct * gg) * rnd(ig * rnd(1.0f - ig))));
      o[H] = __bfloat16_as_ushort(
          __float2bfloat16_rn(rnd(dct * cprev) * rnd(fg * rnd(1.0f - fg))));
      o[2 * H] = __bfloat16_as_ushort(__float2bfloat16_rn(v + rnd(v * gg)));
      o[3 * H] = __bfloat16_as_ushort(
          __float2bfloat16_rn(rnd(cth * tc) * rnd(og * rnd(1.0f - og))));
      dc[ci] = rnd(fg * dct);
    }
    cp_async_wait<kStages - 3>();  // the next step's tiles and the c after them
    __syncthreads();
    if (zstore) {  // dz, a 16-byte store from shared memory
      *reinterpret_cast<uint4*>(zdst + int64_t(t) * zs) =
          *reinterpret_cast<const uint4*>(out + zrow * ZLD + zc8 * 8);
    }
    buf ^= 1;
  }
  product(sz + buf * ROWS * ZLD, dh);
#pragma unroll
  for (int ci = 0; ci < CELLS; ++ci) {
    const int row = r0 + lrow(ci);
    if (row >= n) continue;
    const int64_t at = (int64_t(d) * n + row) * H + uc;
    dh0[at] = __bfloat16_as_ushort(__float2bfloat16_rn(dh[ci]));
    dc0[at] = __bfloat16_as_ushort(__float2bfloat16_rn(dc[ci]));
  }
}

constexpr int kSumThreads = 256;
constexpr int kSumLanes = kSumThreads / 32;  // threads a column, in the bias blocks
constexpr int kSumChunk = 8;  // steps a bias block sums over the rows

// A dz element as float: bfloat16 bits or a float32.
__device__ __forceinline__ float dz_at(const uint16_t* p, int64_t i) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(p + i)));
}
__device__ __forceinline__ float dz_at(const float* p, int64_t i) { return __ldg(p + i); }

// The weight and bias gradients as the JAX scan's transpose loop sums
// them, walking each direction's steps from its last to its first (walk
// position o = 0, 1, ... is step K - 1 - o), from the accumulators dw0 and
// db0 where given (a walk in chunks of steps), else from zero:
//  * blocks [0, weight_blocks): one element of dw (D, 4H, M) a thread,
//    dw = rnd(dw + rnd(P_t)) over products (D, K, 4H, M) float32, eight
//    steps' loads in flight;
//  * the rest: 32 columns of db (D, 4H) and `chunk` walk positions a
//    block. s_t, the step's dz (N, K, D*4H) summed over the rows as XLA
//    sums a reduce of dz's dtype (windows of 32 rows summed in order; more
//    than 32 windows summed the same way), each add rounded for a
//    bfloat16 dz (DZ = uint16_t, the bfloat16 cell's) and none for a
//    float32 one (a float32 carry's), goes to `partial` (groups, K, 32): 8
//    threads a column take the windows in turn, one thread a step sums a
//    step's windows. The block that finishes its column group last
//    (`counters`, zero on entry) adds the steps up in order, db = rnd(db +
//    rnd(s_t)). Dynamic shared memory: chunk x windows x 32 floats.
template <typename DZ>
__global__ void __launch_bounds__(kSumThreads)
bf16_running_sum_kernel(const float* __restrict__ products, const DZ* __restrict__ dz,
                        const uint16_t* __restrict__ dw0, const uint16_t* __restrict__ db0,
                        uint16_t* __restrict__ dw, uint16_t* __restrict__ db,
                        float* __restrict__ partial, int* __restrict__ counters, int n,
                        int k_len, int dirs, int gates, int64_t m, unsigned reverse_mask,
                        int weight_blocks, int chunk) {
  constexpr bool kRounded = sizeof(DZ) == 2;
  extern __shared__ float win[];
  if (int(blockIdx.x) < weight_blocks) {
    const int64_t per_dir = int64_t(gates) * m;
    const int64_t e = int64_t(blockIdx.x) * kSumThreads + threadIdx.x;
    if (e >= per_dir * dirs) return;
    const int d = int(e / per_dir);
    const int64_t j = e % per_dir;
    const bool rev = (reverse_mask >> d) & 1u;
    const float* p = products + int64_t(d) * k_len * per_dir + j;
    float acc = dw0 ? __bfloat162float(__ushort_as_bfloat16(dw0[e])) : 0.0f;
    for (int s0 = k_len - 1; s0 >= 0; s0 -= 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int s = max(s0 - q, 0), t = rev ? k_len - 1 - s : s;
        v[q] = __ldg(p + int64_t(t) * per_dir);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (s0 - q >= 0) acc = rnd(acc + rnd(v[q]));
      }
    }
    dw[e] = __bfloat16_as_ushort(__float2bfloat16_rn(acc));
    return;
  }
  const int chunks = (k_len + chunk - 1) / chunk, per_dir = gates / 32;
  const int b = blockIdx.x - weight_blocks, group = b / chunks, o0 = (b % chunks) * chunk;
  const int col = threadIdx.x & 31, lane = threadIdx.x >> 5;
  const int d = group / per_dir, j = (group % per_dir) * 32 + col;
  const bool rev = (reverse_mask >> d) & 1u;
  const int windows = (n + 31) / 32, lo = (windows * 32 - n) / 2;
  const int64_t zs = int64_t(dirs) * gates;
  const DZ* src = dz + int64_t(d) * gates + j;
  float* part = partial + int64_t(group) * k_len * 32 + col;
  const int steps = min(chunk, k_len - o0);
  for (int p = lane; p < steps * windows; p += kSumLanes) {
    const int i = p / windows, w = p % windows, s = k_len - 1 - (o0 + i);
    const int t = rev ? k_len - 1 - s : s;
    // The window's 32 rows loaded at once (the padding's rows read as any
    // row and not added: an add of a zero changes nothing), then added in
    // order.
    const int base = 32 * w - lo;
    float v[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      v[q] = dz_at(src, (int64_t(min(max(base + q, 0), n - 1)) * k_len + t) * zs);
    }
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      if (base + q >= 0 && base + q < n) sum = kRounded ? rnd(sum + v[q]) : sum + v[q];
    }
    win[p * 32 + col] = sum;
  }
  __syncthreads();
  for (int i = lane; i < steps; i += kSumLanes) {  // one step's windows a thread
    float* v = win + i * windows * 32 + col;
    int count = windows;
    while (count > 32) {  // a further level of windows, in place
      const int next = (count + 31) / 32, l2 = (next * 32 - count) / 2;
      for (int q = 0; q < next; ++q) {
        const int a = max(0, 32 * q - l2), e = min(count, 32 * q + 32 - l2);
        float sum = 0.0f;
        for (int r = a; r < e; ++r) sum = kRounded ? rnd(sum + v[r * 32]) : sum + v[r * 32];
        v[q * 32] = sum;
      }
      count = next;
    }
    float sum = 0.0f;
    for (int r = 0; r < count; ++r) sum = kRounded ? rnd(sum + v[r * 32]) : sum + v[r * 32];
    part[int64_t(o0 + i) * 32] = sum;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(counters + group, 1) == chunks - 1;
  __syncthreads();
  if (!last || lane != 0) return;
  __threadfence();
  const int64_t at = int64_t(d) * gates + j;
  float acc = db0 ? __bfloat162float(__ushort_as_bfloat16(db0[at])) : 0.0f;
  for (int o = 0; o < k_len; ++o) acc = rnd(acc + rnd(__ldcg(part + int64_t(o) * 32)));
  db[at] = __bfloat16_as_ushort(__float2bfloat16_rn(acc));
}

template <int H>
constexpr int scan_smem() {
  return (kStages * kRows * (4 * H + 8) + 2 * kRows * (H + 8) + 2 * kTable) * 2 + 4 * H * 4;
}

template <int H>
constexpr int train_smem() {
  return (kStages * kBackRows * (4 * H + 8) + 2 * kBackRows * (4 * H + 8) +
          4 * kBackRows * (H + 8) + 2 * kTable) * 2 +
         (H / 16) * 2 * 4 * 2 * 32 * 4;
}

template <int H>
constexpr int backward_smem() {
  return (kStages * kBackRows * (4 * H + 8 + 2 * (H + 8)) + 2 * kBackRows * (4 * H + 8) +
          kTable) * 2 +
         (H / 16) * 2 * 32 * 2 * 4;
}

// The dynamic shared memory a kernel may take above 48 KB, set once per
// device (`done` flags the devices already set).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int H>
int launch(const uint16_t* xp, const uint16_t* w_hh, const uint16_t* bias,
           const uint16_t* h0, const uint16_t* c0, uint16_t* y, uint16_t* hn,
           uint16_t* cn, uint16_t* z_out, uint16_t* c_out, int64_t n, int64_t k_len,
           int64_t dirs, unsigned reverse_mask, cudaStream_t st) {
  static bool done[2][64];
  if (z_out) {  // the training forward
    const dim3 grid(unsigned((n + kBackRows - 1) / kBackRows), unsigned(dirs));
    constexpr int bytes = train_smem<H>();
    const cudaError_t err = allow_smem(bf16_lstm_scan_train_kernel<H>, bytes, done[1]);
    if (err != cudaSuccess) return int(err);
    bf16_lstm_scan_train_kernel<H><<<grid, 4 * H, bytes, st>>>(
        xp, w_hh, bias, h0, c0, y, hn, cn, z_out, c_out, int(n), int(k_len), int(dirs),
        reverse_mask);
    return int(cudaGetLastError());
  }
  const dim3 grid(unsigned((n + kRows - 1) / kRows), unsigned(dirs));
  constexpr int bytes = scan_smem<H>();
  const cudaError_t err = allow_smem(bf16_lstm_scan_kernel<H, false>, bytes, done[0]);
  if (err != cudaSuccess) return int(err);
  bf16_lstm_scan_kernel<H, false><<<grid, 4 * H, bytes, st>>>(
      xp, w_hh, bias, h0, c0, y, hn, cn, z_out, c_out, int(n), int(k_len), int(dirs),
      reverse_mask);
  return int(cudaGetLastError());
}

template <int H>
int launch_backward(const uint16_t* dy, const uint16_t* dhn, const uint16_t* dcn,
                    const uint16_t* gates, const uint16_t* c, const uint16_t* w_hh,
                    const uint16_t* c0, uint16_t* dz, uint16_t* dh0, uint16_t* dc0,
                    int64_t n, int64_t k_len, int64_t dirs, unsigned reverse_mask,
                    cudaStream_t st) {
  const dim3 grid(unsigned((n + kBackRows - 1) / kBackRows), unsigned(dirs));
  constexpr int bytes = backward_smem<H>();
  static bool done[64];
  const cudaError_t err = allow_smem(bf16_lstm_scan_backward_kernel<H>, bytes, done);
  if (err != cudaSuccess) return int(err);
  bf16_lstm_scan_backward_kernel<H><<<grid, 4 * H, bytes, st>>>(
      dy, dhn, dcn, gates, c, w_hh, c0, dz, dh0, dc0, int(n), int(k_len), int(dirs),
      reverse_mask);
  return int(cudaGetLastError());
}

}  // namespace

// Each returns a cudaError_t: 0 when the launch was taken. 1
// (cudaErrorInvalidValue) for a hidden width the kernels have no instance
// of (a multiple of 16 up to 128).
extern "C" int sonicsim_bf16_lstm_scan(const void* xp, const void* w_hh,
                                       const void* bias, const void* h0,
                                       const void* c0, void* y, void* hn,
                                       void* cn, void* z_out, void* c_out, int64_t n,
                                       int64_t k_len, int64_t dirs, int64_t hidden,
                                       int64_t reverse_mask, int device, void* stream) {
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
  auto* zo = static_cast<uint16_t*>(z_out);
  auto* cs = static_cast<uint16_t*>(c_out);
  const unsigned mask = unsigned(reverse_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
#define SONICSIM_CASE(HH) \
    case HH: return launch<HH>(x, w, b, h, c, yo, ho, co, zo, cs, n, k_len, dirs, mask, st);
    SONICSIM_CASE(16) SONICSIM_CASE(32) SONICSIM_CASE(48) SONICSIM_CASE(64)
    SONICSIM_CASE(80) SONICSIM_CASE(96) SONICSIM_CASE(112) SONICSIM_CASE(128)
#undef SONICSIM_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int sonicsim_bf16_lstm_scan_backward(const void* dy, const void* dhn,
                                                const void* dcn, const void* z,
                                                const void* c, const void* w_hh,
                                                const void* c0, void* dz, void* dh0,
                                                void* dc0, int64_t n, int64_t k_len,
                                                int64_t dirs, int64_t hidden,
                                                int64_t reverse_mask, int device,
                                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n == 0 || dirs == 0) return 0;
  const auto* g = static_cast<const uint16_t*>(dy);
  const auto* gh = static_cast<const uint16_t*>(dhn);
  const auto* gc = static_cast<const uint16_t*>(dcn);
  const auto* zz = static_cast<const uint16_t*>(z);
  const auto* cc = static_cast<const uint16_t*>(c);
  const auto* w = static_cast<const uint16_t*>(w_hh);
  const auto* ci = static_cast<const uint16_t*>(c0);
  auto* o = static_cast<uint16_t*>(dz);
  auto* oh = static_cast<uint16_t*>(dh0);
  auto* oc = static_cast<uint16_t*>(dc0);
  const unsigned mask = unsigned(reverse_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
#define SONICSIM_CASE(HH)                                                                \
    case HH: return launch_backward<HH>(g, gh, gc, zz, cc, w, ci, o, oh, oc, n, k_len, \
                                        dirs, mask, st);
    SONICSIM_CASE(16) SONICSIM_CASE(32) SONICSIM_CASE(48) SONICSIM_CASE(64)
    SONICSIM_CASE(80) SONICSIM_CASE(96) SONICSIM_CASE(112) SONICSIM_CASE(128)
#undef SONICSIM_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

// products (D, K, gates, m) float32, dz (N, K, D*gates) bfloat16 or, with
// f32_dz, float32; dw0/db0 (the accumulators to start from, or null) and
// dw (D, gates, m), db (D, gates) bfloat16; partial (D * gates / 32, K, 32)
// float32 scratch and counters (D * gates / 32) int32, zero; gates a
// multiple of 32, and at most 51,200 rows (one step's window sums in 200 KB
// of shared memory).
extern "C" int sonicsim_bf16_running_sum(const void* products, const void* dz,
                                         const void* dw0, const void* db0, void* dw,
                                         void* db, void* partial, void* counters,
                                         int f32_dz, int64_t n, int64_t k_len, int64_t dirs,
                                         int64_t gates, int64_t m, int64_t reverse_mask,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (dirs == 0 || gates == 0 || k_len == 0) return 0;
  if (gates % 32) return int(cudaErrorInvalidValue);
  const int64_t weight_blocks = (dirs * gates * m + kSumThreads - 1) / kSumThreads;
  const int64_t window_bytes = ((n + 31) / 32 > 0 ? (n + 31) / 32 : 1) * 32 * int64_t(sizeof(float));
  constexpr int64_t budget = 200 * 1024;  // of the 227 KB a block may hold
  if (window_bytes > budget) return int(cudaErrorInvalidValue);
  const int64_t chunk = budget / window_bytes < kSumChunk ? budget / window_bytes : kSumChunk;
  const int64_t bias_blocks = dirs * gates / 32 * ((k_len + chunk - 1) / chunk);
  const unsigned blocks = unsigned(weight_blocks + bias_blocks);
  const int bytes = int(chunk * window_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(products);
  const auto* w0 = static_cast<const uint16_t*>(dw0);
  const auto* b0 = static_cast<const uint16_t*>(db0);
  auto* wo = static_cast<uint16_t*>(dw);
  auto* bo = static_cast<uint16_t*>(db);
  auto* part = static_cast<float*>(partial);
  auto* count = static_cast<int*>(counters);
  static bool done[2][64];
  if (f32_dz) {
    err = allow_smem(bf16_running_sum_kernel<float>, int(budget), done[1]);
    if (err != cudaSuccess) return int(err);
    bf16_running_sum_kernel<float><<<blocks, kSumThreads, bytes, st>>>(
        p, static_cast<const float*>(dz), w0, b0, wo, bo, part, count, int(n), int(k_len),
        int(dirs), int(gates), m, unsigned(reverse_mask), int(weight_blocks), int(chunk));
  } else {
    err = allow_smem(bf16_running_sum_kernel<uint16_t>, int(budget), done[0]);
    if (err != cudaSuccess) return int(err);
    bf16_running_sum_kernel<uint16_t><<<blocks, kSumThreads, bytes, st>>>(
        p, static_cast<const uint16_t*>(dz), w0, b0, wo, bo, part, count, int(n), int(k_len),
        int(dirs), int(gates), m, unsigned(reverse_mask), int(weight_blocks), int(chunk));
  }
  return int(cudaGetLastError());
}
