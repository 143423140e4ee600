// Block-Thomas solve sweeps of the nodal wire model, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_tridiag_solve` of
// src/repro/kernels/banded_solve.py (body `_block_tridiag_kernel`).  For
// each batch element b, over a precomputed explicit-inverse factor stack
// Minv (nr blocks of s x s), with z_{-1} = 0 and x_{nr} = 0:
//
//     forward:   z_i = Minv_i (rhs_i + gw * z_{i-1})          i = 0 .. nr-1
//     backward:  x_i = z_i + gw * Minv_i x_{i+1}              i = nr-1 .. 0
//
// Shapes: minv (B, nr, s, s), rhs and out (B, nr, s, k), all contiguous, one
// element type T (float on the solver path, double in the parity tests:
// the reference keeps its input dtype, so nothing is down-cast here).
//
// Order.  The TPU kernel walks the batch in grid order with both scans in
// one grid step.  Here the rhs columns never interact (every sweep is
// Minv_i times a block of columns), so a CUDA block owns one batch element
// b and a slice [k0, k0+KB) of its columns (KB = 8, 16 or 32) and walks
// all 2 nr - 1 steps, forward then backward, by itself: grid (B,
// ceil(k/KB)), no order between blocks, no atomics, and every sum over s
// in one fixed order inside the block.  z is written into `out` on the
// forward sweep and overwritten by x on the backward sweep - no scratch in
// device memory; the thread that writes out[b,i,r,k] forward is the one
// that reads it back backward.
//
// What bounds it.  Per batch element the sweeps are 4*nr*s^2*k flops and
// read Minv twice.  At s=256 (B=8, k=256) that is 1.4e11 flops, three
// times that as 3xTF32 (below): 0.83 ms of the tensor cores.  At the
// solver path's s=64 (B<=8, k=64) it is ~4 us, but the 2 nr - 1 = 127
// steps are one dependent chain - each step's product needs the last
// step's result - so the chain's latency is the floor there, not the
// roofline: a step is at least its 3 s/8 = 24 wgmma one after another
// (~50 cycles each, measured below), the carry's hand-over and a
// barrier, ~1500 cycles by this design's own estimate (~0.1 ms over the
// 127 steps).  Device-memory loads on that chain would cost their
// latency every step, so the factor stream runs ahead of it:
//
// Factor stream.  Warpgroup 1 (producer) streams Minv in tiles of 64 rows
// x 32 columns (wgmma's M by one 128-byte row of floats), in the order the
// sweeps use them - step by step, forward then backward, each step's row
// panels of 64 in turn and each panel's column chunks of 32 - through a
// ring of six shared-memory slots handed over by mbarriers.  Each thread
// keeps four tiles' cp.async copies in flight (16-byte pieces where Minv's
// rows are 16-byte aligned, else element by element; past s zero-filled),
// so the loads run ahead of the sweep, off its chain.  The slot of tile
// t + 4 is free once the consumer holds tile t - 1: it gives a slot back
// when the next one has arrived.
//
// Products (float): 3xTF32 wgmma, as csrc/schur_gemm.cu.  The copies land
// as raw floats where the 128-byte swizzle puts them in a slot's big tile;
// the producer then splits them in place into big = tf32(x) and, in the
// slot's small tile, small = tf32(x - big) (K-major: a row's 32 columns
// are contiguous).  The carry (the step's input, s x KB, laid out [kk][c]:
// K-major as well) sits in shared memory as big and small tiles in two
// ping-pong buffers.  Warpgroup 0 (consumer) runs small.big + big.small +
// big.big for a panel's chunks one commit group each, without waiting
// between them, into accumulators that run through the panel (each
// chunk's twelve products spread over twelve of them, six at KB = 32, so
// that no accumulator takes more than a few truncated sums a chunk); at
// the end of a panel it adds them in a fixed order, writes z or x to
// `out` and the next carry, split, into the other buffer, and one barrier
// of the consumer warpgroup ends the step.  The rhs_{i+1} (forward) or
// z_i (backward) a panel adds is loaded two panels ahead.  The Minv
// recursion amplifies float32 rounding ~4000x at s=256, so real factor
// stacks are held to the float64 evaluation; 3xTF32 drops only
// small.small (~2^-22 of a product).
//
// Measured limits of this design (H100, clock64 inside one block at
// s=64, KB=8): a step takes ~3700 cycles.  Each tf32 wgmma
// with K = 8 costs ~50-65 cycles to issue whatever its N (8 to 32) and
// whether A comes from registers or shared memory, so a step's 24 (3 x
// s/8) are ~1600; the epilogue (the panel's sums, the split carry) ~650
// and issuing the next loads of rhs or z ~600 for 4 values a thread;
// the rest is waits, loop and the barrier.  The step's proxy fence is a
// full membar, so the stores to `out` and those loads come after it.
// A narrow column slice keeps the epilogue short, so KB is the narrowest
// that still fills the card in one wave (launcher).  At s=256 the
// producer's split bounds it as much as the products.
//
// Products (double): on the CUDA cores from the same ring (tiles of 64 x
// 32 doubles, rows padded to 33), each consumer thread one row and
// KB / 2 of the columns, the carry [kk][c] read by broadcast.  It runs
// only in the parity tests.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // consumer warpgroup 0, producer warpgroup 1
constexpr int kRows = 64;       // rows of a tile: wgmma's M
constexpr int kDepth = 32;      // columns of a tile: one 128-byte row (f32)
constexpr int STAGES = 6;       // ring slots
constexpr int kAhead = STAGES - 2;   // tiles a producer thread has in flight
constexpr int kLdD = kDepth + 1;     // double tile row stride

// Shared memory of one block (s, KB), bytes: the ring, the two carry
// buffers and the mbarriers.
template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return sizeof(T) == 4 ? 2 * kRows * 128                  // big, small
                        : (int)sizeof(double) * kRows * kLdD;
}
template <typename T>
__host__ __device__ size_t carry_bytes(int s, int kb) {
  const int chunks = (s + kDepth - 1) / kDepth;
  return sizeof(T) == 4 ? (size_t)2 * chunks * kb * 128   // big, small
                        : sizeof(double) * kb * chunks * kDepth;
}
template <typename T>
size_t smem_bytes(int s, int kb) {
  return 1024 + STAGES * slot_bytes<T>() + 2 * carry_bytes<T>(s, kb)
         + 8 * 2 * STAGES;
}

// Float accumulators of a panel (96 registers at most): a chunk's twelve
// products go to as many of them as fit, so each takes few of the tensor
// cores' truncated sums.
template <int KB>
constexpr int kAcc = KB == 32 ? 6 : 12;

// x = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// Byte offset of element (row r, column j < 32) of a 128-byte-swizzled
// K-major float tile.
__device__ __forceinline__ int sw_off(int r, int j) {
  return r * 128 + ((((j >> 2) ^ r) & 7) << 4) + (j & 3) * 4;
}

// d[0..KB/2) (+)= A (64x8, smem) . B (8xKB, smem), both K-major, tf32
template <int KB>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The sweep's tile t: step (0 .. 2 nr - 2), its block row i, row panel p
// and column chunk c.
struct Tile {
  int i, p, c;
  __device__ __forceinline__ Tile(int t, int nr, int P, int C) {
    c = t % C;
    p = (t / C) % P;
    const int step = t / (C * P);
    i = step < nr ? step : 2 * nr - 2 - step;
  }
};

// Copy this producer thread's share of tile t into ring slot `dst`
// without passing through registers; elements past s are zero-filled.
// float: 16-byte piece u is row q / 8, columns 4 (q % 8) .. + 3, q = tid +
// 128 u, landing where the 128-byte swizzle puts it in the big tile (VEC:
// one 16-byte copy, rows 16-byte aligned; else four 4-byte copies);
// double: element u is row q / 32, column q % 32, in rows of kLdD.
template <typename T, bool VEC>
__device__ __forceinline__ void issue_tile(const T* __restrict__ minv_b,
                                           int t, int nr, int s, int P,
                                           int C, int tid, uint8_t* dst) {
  const Tile tl(t, nr, P, C);
  const T* w = minv_b + (size_t)tl.i * s * s;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int u = 0; u < kRows * kDepth / 4 / 128; ++u) {
      const int q = tid + 128 * u, r = q >> 3, c4 = q & 7;
      const int row = tl.p * kRows + r, col = tl.c * kDepth + 4 * c4;
      const T* src = w + (size_t)row * s + col;
      const uint32_t d = smem_u32(dst + r * 128 + ((c4 ^ (r & 7)) << 4));
      if constexpr (VEC) {
        const int n = row < s ? max(0, min(4, s - col)) : 0;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(n ? src : minv_b), "r"(4 * n)
                     : "memory");
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row < s && col + e < s;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                       :: "r"(d + 4 * e), "l"(ok ? src + e : minv_b),
                          "r"(ok ? 4 : 0) : "memory");
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kRows * kDepth / 128; ++u) {
      const int q = tid + 128 * u, r = q >> 5, j = q & 31;
      const int row = tl.p * kRows + r, col = tl.c * kDepth + j;
      const bool ok = row < s && col < s;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(smem_u32(dst + 8 * (r * kLdD + j))),
                      "l"(ok ? w + (size_t)row * s + col : minv_b),
                      "r"(ok ? 8 : 0) : "memory");
    }
  }
}

// Split this thread's pieces of a float slot in place: the raw values in
// the big tile become big = tf32(x), small = tf32(x - big) goes to the
// small tile at the same offset.
__device__ __forceinline__ void split_slot(uint8_t* slot, int tid) {
#pragma unroll
  for (int u = 0; u < kRows * kDepth / 4 / 128; ++u) {
    const int q = tid + 128 * u, r = q >> 3, c4 = q & 7;
    const int off = r * 128 + ((c4 ^ (r & 7)) << 4);
    const float4 x = *reinterpret_cast<const float4*>(slot + off);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(slot + off) = hi;
    *reinterpret_cast<uint4*>(slot + kRows * 128 + off) = lo;
  }
}

// Element (kk, c) of carry buffer `buf` := val (split for float).
template <typename T, int KB>
__device__ __forceinline__ void put_carry(uint8_t* carry, int buf, int C,
                                          int kk, int c, T val) {
  if constexpr (sizeof(T) == 4) {
    const int tile = KB * 128;                  // one chunk, big or small
    uint8_t* big = carry + (size_t)(2 * buf) * C * tile
                   + (c / kDepth) * tile;
    uint32_t hi, lo;
    split_tf32(val, hi, lo);
    const int off = sw_off(kk, c % kDepth);
    *reinterpret_cast<uint32_t*>(big + off) = hi;
    *reinterpret_cast<uint32_t*>(big + (size_t)C * tile + off) = lo;
  } else {
    reinterpret_cast<T*>(carry)[((size_t)buf * KB + kk) * C * kDepth + c] =
        val;
  }
}

template <typename T, int KB, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) block_tridiag_kernel(
    const T* __restrict__ minv, const T* __restrict__ rhs, T* __restrict__ out,
    int nr, int s, int K, T gw) {
  // this consumer thread's outputs a[e]: float, the accumulator fragment
  // of a 64 x KB wgmma (row 16 warp + g + 8 ((e >> 1) & 1), column
  // 8 (e / 4) + 2 t + (e & 1), g = lane / 4, t = lane % 4); double, row
  // tid % 64 and column (tid / 64) KB/2 + e
  constexpr int NA = KB / 2;
  extern __shared__ uint8_t smem_raw[];
  // rounded up to 1024 bytes by offsetting the shared array itself, so
  // that the compiler keeps shared-memory loads and stores (STS, not ST)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int P = (s + kRows - 1) / kRows, C = (s + kDepth - 1) / kDepth;
  uint8_t* ring = smem;
  uint8_t* carry = ring + STAGES * slot_bytes<T>();
  uint64_t* full = reinterpret_cast<uint64_t*>(carry
                                               + 2 * carry_bytes<T>(s, KB));
  uint64_t* empty = full + STAGES;
  const int k0 = blockIdx.y * KB;
  const size_t blk = (size_t)s * s;
  const T* minv_b = minv + (size_t)blockIdx.x * nr * blk;
  const T* rhs_b = rhs + (size_t)blockIdx.x * nr * s * K;
  T* out_b = out + (size_t)blockIdx.x * nr * s * K;
  const int n_tiles = (2 * nr - 1) * P * C;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 128);        // every producer thread
      mbar_init(&empty[st], 128);       // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: the factor stream, kAhead tiles in flight -----------
    // The consumer gives a slot back once it holds the next tile, so the
    // slot of tile t + kAhead (tile t - 2's) is free once tile t - 1 is in.
    const int tid = threadIdx.x - 128;
    auto issue = [&](int t) {
      if (t < n_tiles) {
        const int slot = t % STAGES, n = t / STAGES;
        if (n > 0) mbar_wait(&empty[slot], (n - 1) & 1);
        issue_tile<T, VEC>(minv_b, t, nr, s, P, C, tid,
                           ring + slot * slot_bytes<T>());
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int t = 0; t < kAhead; ++t) issue(t);
    for (int t = 0; t < n_tiles; ++t) {
      issue(t + kAhead);
      // this thread's copies of tile t have landed
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead) : "memory");
      uint8_t* slot = ring + (t % STAGES) * slot_bytes<T>();
      if constexpr (sizeof(T) == 4) {
        split_slot(slot, tid);
        // the split stores before the tensor cores read them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      mbar_arrive(&full[t % STAGES]);
    }
    return;
  }

  // ---- consumer --------------------------------------------------------
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  auto row_of = [&](int p, int e) {
    return p * kRows + (sizeof(T) == 4
                        ? 16 * warp + lane / 4 + 8 * ((e >> 1) & 1)
                        : tid % 64);
  };
  auto col_of = [&](int e) {
    return sizeof(T) == 4 ? 8 * (e / 4) + 2 * (lane % 4) + (e & 1)
                          : (tid / 64) * NA + e;
  };

  // prologue: the first forward input is rhs_0 (z_{-1} = 0); rows past s
  // and columns past k are zeros
  for (int idx = tid; idx < KB * C * kDepth; idx += 128) {
    const int kk = idx % KB, c = idx / KB;
    put_carry<T, KB>(carry, 0, C, kk, c,
                     (c < s && k0 + kk < K) ? rhs_b[(size_t)c * K + k0 + kk]
                                            : T(0));
  }
  if constexpr (sizeof(T) == 4)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  // The sweeps as G = (2 nr - 1) P panels in order, panel g being row
  // panel g % P of step g / P.  A panel's epilogue needs rhs_{i+1}
  // (forward) or z_i (backward) of its rows: loaded two panels ahead, off
  // the chain, into two register sets that alternate.  Backward this
  // reads z_i, which this thread wrote on an earlier step (two panels
  // ahead never reach past the step being computed).
  const int G = (2 * nr - 1) * P;
  auto load_pre = [&](int g, T (&pre)[NA]) {
    const int step = g / P, p = g % P;
    const bool fwd = step < nr;
    const int i = fwd ? step : 2 * nr - 2 - step;
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int r = row_of(p, e), k = k0 + col_of(e);
      const bool ok = g < G && r < s && k < K && (!fwd || i + 1 < nr);
      const size_t at = ((size_t)(fwd ? i + 1 : i) * s + r) * K + k;
      pre[e] = ok ? (fwd ? rhs_b[at] : out_b[at]) : T(0);
    }
  };

  int cur = 0, tt = 0;
  auto panel = [&](int g, T (&pre)[NA]) {
    const int step = g / P, p = g % P;
    const bool fwd = step < nr;
    const int i = fwd ? step : 2 * nr - 2 - step;
    T acc[NA];
    if constexpr (sizeof(T) == 4) {
      // Minv tiles (A) times the carry's chunks (B), 3xTF32: each chunk's
      // twelve wgmma (k8 steps x small.big, big.small, big.big) spread
      // over kAcc accumulators that run through the whole panel; a
      // chunk's slot goes back once the next chunk's group is issued and
      // its own has retired
      constexpr int NACC = kAcc<KB>;
      const int ct = KB * 128;
      const uint8_t* carry_big = carry + (size_t)(2 * cur) * C * ct;
      float part[NACC][NA];
      for (int c = 0; c < C; ++c, ++tt) {
        const int slot = tt % STAGES;
        mbar_wait(&full[slot], (tt / STAGES) & 1);
        const uint8_t* big = ring + slot * slot_bytes<T>();
        const uint8_t* cb = carry_big + c * ct;
        wgmma_fence();
#pragma unroll
        for (int w = 0; w < 12; ++w) {
          const int k8 = w / 3, prod = w % 3;
          wgmma_tf32<KB>(
              part[w % NACC],
              sw128_desc(big + (prod == 0 ? kRows * 128 : 0) + 32 * k8),
              sw128_desc(cb + (prod == 1 ? (size_t)C * ct : 0) + 32 * k8),
              c > 0 || w >= NACC);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0) mbar_arrive(&empty[(tt - 1) % STAGES]);
      }
      wgmma_wait_all();
      mbar_arrive(&empty[(tt - 1) % STAGES]);
#pragma unroll
      for (int j = 0; j < NACC; ++j) fence_regs<NA>(part[j]);
#pragma unroll
      for (int e = 0; e < NA; ++e) {
        acc[e] = part[0][e];
#pragma unroll
        for (int j = 1; j < NACC; ++j) acc[e] += part[j][e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < NA; ++e) acc[e] = T(0);
      for (int c = 0; c < C; ++c, ++tt) {
        const int slot = tt % STAGES;
        mbar_wait(&full[slot], (tt / STAGES) & 1);
        const T* w = reinterpret_cast<const T*>(ring
                                                + slot * slot_bytes<T>())
                     + (tid % 64) * kLdD;
        const T* x = reinterpret_cast<const T*>(carry)
                     + ((size_t)cur * KB + (tid / 64) * NA) * C * kDepth
                     + c * kDepth;
#pragma unroll 8
        for (int j = 0; j < kDepth; ++j) {
          const T wj = w[j];
#pragma unroll
          for (int e = 0; e < NA; ++e)
            acc[e] = fma(wj, x[(size_t)e * C * kDepth + j], acc[e]);
        }
        mbar_arrive(&empty[slot]);
      }
    }
    // z_i (forward; the next input rhs_{i+1} + gw z_i, or z_{nr-1} itself,
    // the first backward carry) or x_i = z_i + gw Minv_i x_{i+1}
    T y[NA];
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int r = row_of(p, e), kk = col_of(e);
      const bool ok = r < s && k0 + kk < K;
      T nxt;
      if (fwd) {
        y[e] = acc[e];
        nxt = i + 1 < nr ? pre[e] + gw * y[e] : y[e];
      } else {
        y[e] = pre[e] + gw * acc[e];
        nxt = y[e];
      }
      if (r < C * kDepth)
        put_carry<T, KB>(carry, cur ^ 1, C, kk, r, ok ? nxt : T(0));
    }
    if (p == P - 1) {                   // the step's last panel
      // The proxy fence waits for every memory operation of this thread
      // still in flight (it is a full membar), so the device-memory
      // stores and loads of the panel come after it and the barrier:
      // the next step's fence finds them done.
      if constexpr (sizeof(T) == 4)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      cur ^= 1;
    }
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int r = row_of(p, e), k = k0 + col_of(e);
      if (r < s && k < K) out_b[((size_t)i * s + r) * K + k] = y[e];
    }
    load_pre(g + 2, pre);
  };

  T pre_a[NA], pre_b[NA];
  load_pre(0, pre_a);
  load_pre(1, pre_b);
  for (int g = 0; g < G; g += 2) {
    panel(g, pre_a);
    if (g + 1 < G) panel(g + 1, pre_b);
  }
}

template <typename T, int KB, bool VEC>
cudaError_t launch(const T* minv, const T* rhs, T* out, int B, int nr, int s,
                   int K, double gw, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(s, KB);
  cudaError_t err = cudaFuncSetAttribute(
      block_tridiag_kernel<T, KB, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, (K + KB - 1) / KB);
  block_tridiag_kernel<T, KB, VEC><<<grid, kThreads, smem, stream>>>(
      minv, rhs, out, nr, s, K, static_cast<T>(gw));
  return cudaGetLastError();
}

template <typename T, int KB>
cudaError_t launch_kb(const T* m, const T* r, T* o, int B, int nr, int s,
                      int K, double gw, cudaStream_t st) {
  // float: 16-byte copies where every row of Minv starts 16-byte aligned
  // (double copies element by element into its padded rows either way)
  if constexpr (sizeof(T) == 4)
    if (reinterpret_cast<uintptr_t>(m) % 16 == 0 && s % 4 == 0)
      return launch<T, KB, true>(m, r, o, B, nr, s, K, gw, st);
  return launch<T, KB, false>(m, r, o, B, nr, s, K, gw, st);
}

template <typename T>
int dispatch(const void* minv, const void* rhs, void* out, int B, int nr,
             int s, int K, int kb, double gw, void* stream) {
  if (B == 0 || nr == 0 || s == 0 || K == 0) return 0;
  const T* m = static_cast<const T*>(minv);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kb) {
    case 8: return (int)launch_kb<T, 8>(m, r, o, B, nr, s, K, gw, st);
    case 16: return (int)launch_kb<T, 16>(m, r, o, B, nr, s, K, gw, st);
    case 32: return (int)launch_kb<T, 32>(m, r, o, B, nr, s, K, gw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers
// of contiguous tensors: minv (B,nr,s,s), rhs (B,nr,s,k), out (B,nr,s,k),
// all of one type.  `kb` is the column slice per block: 8, 16 or 32.
// Return the launch's cudaError_t (0 on success); nothing is synchronised.
extern "C" int block_tridiag_solve_f32(const void* minv, const void* rhs,
                                       void* out, int B, int nr, int s, int K,
                                       int kb, double gw, void* stream) {
  return dispatch<float>(minv, rhs, out, B, nr, s, K, kb, gw, stream);
}

extern "C" int block_tridiag_solve_f64(const void* minv, const void* rhs,
                                       void* out, int B, int nr, int s, int K,
                                       int kb, double gw, void* stream) {
  return dispatch<double>(minv, rhs, out, B, nr, s, K, kb, gw, stream);
}

// Dynamic shared memory of one block of the (f64, s, kb) instance, bytes.
extern "C" long long block_tridiag_smem_bytes(int f64, int s, int kb) {
  return (long long)(f64 ? smem_bytes<double>(s, kb)
                         : smem_bytes<float>(s, kb));
}

extern "C" const char* block_tridiag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
