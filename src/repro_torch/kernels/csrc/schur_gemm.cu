// Fused Schur-complement update  out = A4 - A3 @ W,  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `schur_update` of
// src/repro/kernels/schur_gemm.py (body `_schur_kernel`): a GEMM whose
// accumulator is initialised from A4 and which subtracts the products, so
// the (I x J) output makes one trip to device memory instead of a
// matmul-then-subtract pair.
//
// Types.  a4 (I,J), a3 (I,K), w (K,J) are all float or all bfloat16; the
// output is float.  Any shapes: ragged edges are masked (zeros staged).
//
// What bounds it.  2*I*J*K flops against 4*(I*J + I*K + K*J + I*J) bytes:
// at the kernel bench's n = 512 and 1024 the operations bound it.  On the
// CUDA cores float32 would take at least 0.004 and 0.032 ms (67 TFLOP/s);
// as three TF32 products on the tensor cores (495 TFLOP/s) at least
// 0.0016 and 0.0130 ms, the floor this kernel is measured against.
//
// Order.  The TPU kernel walks a grid (I/BI, J/BJ, K/BK) in order and
// accumulates over K in its output block.  Here one CUDA block owns one
// output tile and walks the whole K axis itself in 32-deep chunks, so the
// ordered accumulation from A4 stays inside one block: no split of K, no
// atomics.  The chunks of A3 and W go through a ring of four
// shared-memory stages filled by 16-byte `cp.async` (zero-filled past the
// edges; rows not 16-byte aligned are staged element by element), up to
// three chunks ahead of the products.  The tensor cores truncate
// each sum into their accumulator (up to an ulp of it per product: close
// to the 1e-5 limit at n=1024 when one accumulator runs over all of K),
// so each chunk sums into a fresh partial that is added to the running
// sum, which started from A4, in float32.
//
// float32: 3xTF32 on wgmma.  One TF32 product keeps 11 bits of each
// operand and lands ~3e-4 of max|out| from the float32 function at
// n=1024, 33x the 1e-5 the kernel is held to.  So each operand x is split
// into big = tf32(x) (cvt.rna) and small = tf32(x - big), and the
// products small.big + big.small + big.big go into one float32 sum
// (small.small, ~2^-22 of a product, is dropped): ~1e-6 of max|out|, as
// full float32.  tf32 wgmma reads shared-memory operands K-major only, and
// W (K, J) row-major is J-major (TMA cannot transpose it), so the kernel
// computes the transposed problem out^T = A4^T - W^T A3^T: W^T (64 j x 8
// k) is the A operand in registers, each thread's fragments read from the
// W chunk and split there; A3's chunk (BN i rows, k-contiguous: K-major)
// is the B operand, split once per chunk into two 128-byte-swizzled tiles
// (big, small) in shared memory.  The instruction's negate-A subtracts
// the products.  A block owns 64 j x BN i of the output: BN = 64 where
// that gives every SM a block (256 blocks at n=1024), else 32 (n=512: 128
// blocks, not 64).
//
// Run one after another in one warpgroup, a chunk's loads, A3 split,
// W^T split and products add up (each a sizeable share of the time at
// n=1024), so the block is warp-specialised: warpgroup 1 (producer)
// keeps the cp.async ring full and splits each A3 chunk into one of two
// operand buffers while warpgroup 0 (consumer) runs the previous chunk's
// wgmma; mbarriers hand the buffers and ring slots over, and
// `setmaxnreg` gives the consumer's accumulators the producer's spare
// registers.
//
// bfloat16: one bf16 product (exact in float32) on `mma.sync.m16n8k16`,
// float32 sums.  A block owns a 64 x 64 tile; four warps own 32 x 32
// quarters, fragments loaded from the padded chunks (free of bank
// conflicts), the A3 fragments' sign bits flipped to subtract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BK = 32;       // depth of one shared-memory chunk
constexpr int BJ = 64;       // W chunk columns (output j) per block
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int LDW = BJ + 8;  // W chunk row stride (elements)

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes global -> shared, of which `bytes` are read (the rest zeros).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage the chunk of depth k0 of A3 (BI x BK, row stride LDA) and W
// (BK x BJ, row stride LDW) into the ring slot at as, ws, shared by 128
// threads (`tid` 0..127).  VEC: 16-byte cp.async (rows 16-byte aligned),
// else element by element.
template <typename T, int BI, int LDA, bool VEC>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ a3, const T* __restrict__ w, T* as, T* ws,
    int i0, int j0, int k0, int I, int J, int K, int tid) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);            // elements a chunk
    for (int idx = tid; idx < BI * (BK / E); idx += kThreads) {
      const int r = idx / (BK / E), c = (idx % (BK / E)) * E;
      const int i = i0 + r, k = k0 + c;
      const int n = (i < I) ? max(0, min(E, K - k)) : 0;
      cp_async16(as + r * LDA + c, n ? a3 + (size_t)i * K + k : a3,
                 n * (int)sizeof(T));
    }
    for (int idx = tid; idx < BK * (BJ / E); idx += kThreads) {
      const int r = idx / (BJ / E), c = (idx % (BJ / E)) * E;
      const int k = k0 + r, j = j0 + c;
      const int n = (k < K) ? max(0, min(E, J - j)) : 0;
      cp_async16(ws + r * LDW + c, n ? w + (size_t)k * J + j : w,
                 n * (int)sizeof(T));
    }
  } else {
    const T zero = T(0.f);
    for (int idx = tid; idx < BI * BK; idx += kThreads) {
      const int r = idx / BK, c = idx % BK;
      const int i = i0 + r, k = k0 + c;
      as[r * LDA + c] = (i < I && k < K) ? a3[(size_t)i * K + k] : zero;
    }
    for (int idx = tid; idx < BK * BJ; idx += kThreads) {
      const int r = idx / BJ, c = idx % BJ;
      const int k = k0 + r, j = j0 + c;
      ws[r * LDW + c] = (k < K && j < J) ? w[(size_t)k * J + j] : zero;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on wgmma, the transposed problem
// ---------------------------------------------------------------------------

// x = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d[0..32) (+)= -A (64x8, registers) . B (8x64, smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, -1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d[0..16) (+)= -A (64x8, registers) . B (8x32, smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, -1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


template <int BN>
struct Tf32Smem {
  static constexpr int kOperand = BN * 128;            // one split tile
  static constexpr int kRawA = BN * BK;                // floats a stage
  static constexpr int kRawW = BK * LDW;
  static constexpr int kBars = STAGES + 4;       // raw_empty, split_*
  static constexpr size_t kBytes =                     // + 1024: alignment
      1024 + 4 * kOperand + sizeof(float) * STAGES * (kRawA + kRawW)
      + 8 * kBars;
};

// Split the A3 chunk `ca` (BN x BK) into the big and small tiles of the
// B operand, shared by 128 threads: 16-byte column c of row r lands at
// column c ^ (r % 8), the 128-byte swizzle.  Loads first, then the
// splits, then the stores, so that they overlap.
template <int BN>
__device__ __forceinline__ void split_a3(const float* ca, uint8_t* big,
                                         uint8_t* small, int tid) {
  constexpr int N = BN * 8 / kThreads;       // 16-byte columns a thread
  float4 x[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = tid + u * kThreads, r = idx / 8, c = idx % 8;
    x[u] = *reinterpret_cast<const float4*>(ca + r * BK + 4 * c);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = tid + u * kThreads, r = idx / 8, c = idx % 8;
    uint4 hi, lo;
    split_tf32(x[u].x, hi.x, lo.x);
    split_tf32(x[u].y, hi.y, lo.y);
    split_tf32(x[u].z, hi.z, lo.z);
    split_tf32(x[u].w, hi.w, lo.w);
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(big + off) = hi;
    *reinterpret_cast<uint4*>(small + off) = lo;
  }
}

// This thread's W^T fragments of the W chunk `cw`, split: rows jr, jr + 8
// (j), columns t, t + 4 (k) of each 8-deep step.
__device__ __forceinline__ void split_wt(const float* cw, int jr, int t,
                                         uint32_t (&big)[BK / 8][4],
                                         uint32_t (&small)[BK / 8][4]) {
#pragma unroll
  for (int k8 = 0; k8 < BK / 8; ++k8) {
    const float* p = cw + (8 * k8 + t) * LDW + jr;
    split_tf32(p[0], big[k8][0], small[k8][0]);
    split_tf32(p[8], big[k8][1], small[k8][1]);
    split_tf32(p[4 * LDW], big[k8][2], small[k8][2]);
    split_tf32(p[4 * LDW + 8], big[k8][3], small[k8][3]);
  }
}

// Warpgroup 1 (producer) stages chunks through the ring and splits each
// A3 chunk into one of two operand buffers; warpgroup 0 (consumer)
// splits its W^T fragments and runs the wgmma, so that the next chunk's
// loads and split overlap this chunk's products.  mbarriers hand over:
// split_full[b] (operand buffer b ready; raw W of the chunk landed),
// split_empty[b] (its products done), raw_empty[s] (the consumer has read
// ring slot s).
template <int BN, bool VEC>
__global__ void __launch_bounds__(2 * kThreads, 2) schur_tf32_kernel(
    const float* __restrict__ a4, const float* __restrict__ a3,
    const float* __restrict__ w, float* __restrict__ out, int I, int J,
    int K) {
  using L = Tf32Smem<BN>;
  constexpr int NA = BN / 2;                 // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* op = smem;                        // 2 x (big, small) tiles
  float* raw_a = reinterpret_cast<float*>(smem + 4 * L::kOperand);
  float* raw_w = raw_a + STAGES * L::kRawA;
  uint64_t* raw_empty = reinterpret_cast<uint64_t*>(raw_w
                                                    + STAGES * L::kRawW);
  uint64_t* split_full = raw_empty + STAGES;
  uint64_t* split_empty = split_full + 2;
  const int j0 = blockIdx.x * BJ, i0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x % kThreads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&raw_empty[s], kThreads);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&split_full[b], kThreads);
      mbar_init(&split_empty[b], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    // ---- producer: ring loads, A3 split --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    auto stage = [&](int kc) {
      const int slot = kc % STAGES;
      stage_chunk<float, BN, BK, VEC>(a3, w, raw_a + slot * L::kRawA,
                                      raw_w + slot * L::kRawW, i0, j0,
                                      kc * BK, I, J, K, tid);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) stage(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();    // this thread's part of chunk kt
      // ... and every producer thread's (named barrier 1, 128 threads)
      asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
      if (kt + STAGES - 1 < nk) {     // refill the slot of chunk kt - 1
        if (kt > 0) mbar_wait(&raw_empty[(kt - 1) % STAGES],
                              ((kt - 1) / STAGES) & 1);
        stage(kt + STAGES - 1);
      }
      cp_async_commit();
      const int b = kt & 1;
      if (kt >= 2) mbar_wait(&split_empty[b], ((kt >> 1) - 1) & 1);
      uint8_t* big = op + b * 2 * L::kOperand;
      split_a3<BN>(raw_a + (kt % STAGES) * L::kRawA, big,
                   big + L::kOperand, tid);
      // the split stores (generic proxy) before the tensor cores read them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&split_full[b]);
    }
  } else {
    // ---- consumer: W^T fragments, wgmma, the running sum ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int jr = 16 * warp + g;            // j rows jr, jr + 8

    // out^T fragment: acc[4n + e] is (j, i) = (jr + 8 (e >> 1),
    // 8n + 2t + (e & 1)), loaded from A4
    float acc[NA];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + jr + 8 * (e >> 1);
        const int i = i0 + 8 * n + 2 * t + (e & 1);
        acc[4 * n + e] = (i < I && j < J) ? a4[(size_t)i * J + j] : 0.f;
      }

    for (int kt = 0; kt < nk; ++kt) {
      const int b = kt & 1, slot = kt % STAGES;
      mbar_wait(&split_full[b], (kt >> 1) & 1);
      uint32_t a_big[BK / 8][4], a_small[BK / 8][4];
      split_wt(raw_w + slot * L::kRawW, jr, t, a_big, a_small);
      mbar_arrive(&raw_empty[slot]);
      const uint8_t* big = op + b * 2 * L::kOperand;
      const uint8_t* small = big + L::kOperand;
      float part[NA];
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < BK / 8; ++k8) {
        const uint64_t d_big = sw128_desc(big + 32 * k8);
        const uint64_t d_small = sw128_desc(small + 32 * k8);
        if constexpr (BN == 64) {
          wgmma_tf32_n64(part, a_small[k8], d_big, k8 > 0);
          wgmma_tf32_n64(part, a_big[k8], d_small, 1);
          wgmma_tf32_n64(part, a_big[k8], d_big, 1);
        } else {
          wgmma_tf32_n32(part, a_small[k8], d_big, k8 > 0);
          wgmma_tf32_n32(part, a_big[k8], d_small, 1);
          wgmma_tf32_n32(part, a_big[k8], d_big, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NA>(part);
      mbar_arrive(&split_empty[b]);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += part[i];
    }

#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + jr + 8 * (e >> 1);
        const int i = i0 + 8 * n + 2 * t + (e & 1);
        if (i < I && j < J) out[(size_t)i * J + j] = acc[4 * n + e];
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync
// ---------------------------------------------------------------------------

constexpr int LDA_BF16 = BK + 8;   // A3 chunk row stride, 16-byte rows
constexpr size_t kBf16Smem =
    sizeof(__nv_bfloat16) * STAGES * (64 * LDA_BF16 + BK * LDW);

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// part -= A3 chunk . W chunk for this warp's 32 x 32 quarter: rows
// wi + 16 mt + {g, g + 8}, columns wj + 8 nt + 2t + {0, 1}; A fragments
// hold k pairs 2t, 2t + 8 of each 16-deep step.
__device__ __forceinline__ void multiply_bf16(const __nv_bfloat16* as,
                                              const __nv_bfloat16* ws,
                                              int wi, int wj, int g, int t,
                                              float (&part)[2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* p = as + (wi + 16 * mt + g) * LDA_BF16 + kk + 2 * t;
      // pairs along k; the sign bits flipped: the products subtract
      a[mt][0] = *reinterpret_cast<const uint32_t*>(p) ^ 0x80008000u;
      a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA_BF16)
                 ^ 0x80008000u;
      a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8) ^ 0x80008000u;
      a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA_BF16 + 8)
                 ^ 0x80008000u;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* p = ws + (kk + 2 * t) * LDW + wj + 8 * nt + g;
      b[nt][0] = bf16_pair(p[0], p[LDW]);
      b[nt][1] = bf16_pair(p[8 * LDW], p[9 * LDW]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) schur_bf16_kernel(
    const __nv_bfloat16* __restrict__ a4, const __nv_bfloat16* __restrict__ a3,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int I,
    int J, int K) {
  constexpr int BI = 64;
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);       // STAGES x BI x LDA_BF16
  T* ws = as + STAGES * BI * LDA_BF16;          // STAGES x BK x LDW
  const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wi = (warp / 2) * 32, wj = (warp % 2) * 32;

  float acc[2][4][4];                           // initialised from A4
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wi + 16 * mt + g + ((e & 2) ? 8 : 0);
        const int j = j0 + wj + 8 * nt + 2 * t + (e & 1);
        acc[mt][nt][e] = (i < I && j < J) ? widen(a4[(size_t)i * J + j])
                                          : 0.f;
      }

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      stage_chunk<T, BI, LDA_BF16, VEC>(a3, w, as + s * BI * LDA_BF16,
                                        ws + s * BK * LDW, i0, j0, s * BK,
                                        I, J, K, threadIdx.x);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();      // chunk kt has landed
    __syncthreads();                  // ... for every thread; slot kt-1 free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int slot = nxt % STAGES;
      stage_chunk<T, BI, LDA_BF16, VEC>(a3, w, as + slot * BI * LDA_BF16,
                                        ws + slot * BK * LDW, i0, j0,
                                        nxt * BK, I, J, K, threadIdx.x);
    }
    cp_async_commit();
    float part[2][4][4] = {};
    const int slot = kt % STAGES;
    multiply_bf16(as + slot * BI * LDA_BF16, ws + slot * BK * LDW, wi, wj,
                  g, t, part);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wi + 16 * mt + g + ((e & 2) ? 8 : 0);
        const int j = j0 + wj + 8 * nt + 2 * t + (e & 1);
        if (i < I && j < J) out[(size_t)i * J + j] = acc[mt][nt][e];
      }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int BN, bool VEC>
cudaError_t launch_tf32(const float* a4, const float* a3, const float* w,
                        float* out, int I, int J, int K,
                        cudaStream_t stream) {
  constexpr size_t smem = Tf32Smem<BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      schur_tf32_kernel<BN, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((J + BJ - 1) / BJ, (I + BN - 1) / BN);
  schur_tf32_kernel<BN, VEC><<<grid, 2 * kThreads, smem, stream>>>(
      a4, a3, w, out, I, J, K);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_bf16(const __nv_bfloat16* a4, const __nv_bfloat16* a3,
                        const __nv_bfloat16* w, float* out, int I, int J,
                        int K, cudaStream_t stream) {
  constexpr size_t smem = kBf16Smem;
  cudaError_t err = cudaFuncSetAttribute(
      schur_bf16_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((J + BJ - 1) / BJ, (I + 63) / 64);
  schur_bf16_kernel<VEC><<<grid, kThreads, smem, stream>>>(
      a4, a3, w, out, I, J, K);
  return cudaGetLastError();
}

bool rows_aligned(const void* a3, const void* w, int J, int K, size_t elt) {
  return reinterpret_cast<uintptr_t>(a3) % 16 == 0
         && reinterpret_cast<uintptr_t>(w) % 16 == 0
         && ((size_t)K * elt) % 16 == 0 && ((size_t)J * elt) % 16 == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: a4 (I,J), a3 (I,K), w (K,J) of one type (bf16 = 1:
// bfloat16, 0: float), out (I,J) float; `sms` is the card's SM count.
// ceil(I/32) must fit gridDim.y (<= 65535); the launcher checks it.
// Returns the launch's cudaError_t (0 on success); nothing is synchronised.
extern "C" int schur_update_apply(const void* a4, const void* a3,
                                  const void* w, void* out, int bf16, int I,
                                  int J, int K, int sms, void* stream) {
  if (I == 0 || J == 0) return 0;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = const __nv_bfloat16*;
    const B x4 = static_cast<B>(a4), x3 = static_cast<B>(a3),
            xw = static_cast<B>(w);
    return (int)(rows_aligned(a3, w, J, K, 2)
                 ? launch_bf16<true>(x4, x3, xw, o, I, J, K, st)
                 : launch_bf16<false>(x4, x3, xw, o, I, J, K, st));
  }
  const float* x4 = static_cast<const float*>(a4);
  const float* x3 = static_cast<const float*>(a3);
  const float* xw = static_cast<const float*>(w);
  const bool vec = rows_aligned(a3, w, J, K, 4);
  // 64-row tiles where they give every SM a block, else 32
  if ((long)((I + 63) / 64) * ((J + BJ - 1) / BJ) >= sms)
    return (int)(vec ? launch_tf32<64, true>(x4, x3, xw, o, I, J, K, st)
                     : launch_tf32<64, false>(x4, x3, xw, o, I, J, K, st));
  return (int)(vec ? launch_tf32<32, true>(x4, x3, xw, o, I, J, K, st)
                   : launch_tf32<32, false>(x4, x3, xw, o, I, J, K, st));
}

// Dynamic shared memory of one block: bf16, or float32 with 64-row
// (wide) or 32-row tiles, in bytes.
extern "C" int schur_smem_bytes(int bf16, int wide) {
  if (bf16) return (int)kBf16Smem;
  return (int)(wide ? Tf32Smem<64>::kBytes : Tf32Smem<32>::kBytes);
}

extern "C" const char* schur_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
