// Causal (or full) online-softmax attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_flash_kernel`), and computes
// its function, not its block structure:
//
//   s   = (q . k^T) * D^-0.5           float32 (bf16 products are exact)
//   s   = -1e30 where row < col        (causal, by index) or col >= S;
//                                      -inf in the bf16 kernel: p = 0 alike
//   m,l   running row max and denominator (online softmax), float32
//   acc = sum_j exp(s - m) v            float32 sums
//   out = acc / max(l, 1e-30)           rounded once to the inputs' type
//
// Types and shapes.  q, k, v, out are (BH, S, D), contiguous, all float or
// all bfloat16; D is 64 or 128 (a template argument); S is any length:
// rows and keys past S are masked by index here, nothing is padded.  The
// TPU kernel walks the grid (BH, S/bq, S/bk) in order and accumulates over
// its innermost K axis in VMEM scratch; CUDA blocks run concurrently, so
// each block owns a run of query rows of one (batch, head) and walks the
// K/V tiles in order up to the causal diagonal itself (tiles past it are
// skipped, as `pl.when` skips them): no split of K, no atomics.  The grid
// is (ceil(S/BQ), BH), the query tiles in reverse so that the longest
// causal walks start first.
//
// What bounds it.  4 BH D S(S+1)/2 flops on the live lower triangle
// against 4 BH S D elements moved: at the serving path's (128, 1024, 128)
// bf16 the bytes (0.040 ms) and the bf16 tensor-core operations (0.035
// ms) nearly tie; at (32, 8192, 128) the operations bound it (0.56 ms).
// So the bf16 kernel is built for the tensor cores:
//
// bfloat16 (flash_bf16_kernel): FlashAttention-3's shape.  A block owns
// BQ = 128 query rows: two consumer warpgroups of 64 rows (wgmma's M) and
// one producer warpgroup, of which one thread issues TMA loads;
// `setmaxnreg` moves registers from the producer (40) to the consumers
// (232).  Q (128 x D) is loaded once; K and V tiles of BK = 128 keys go
// through a ring of two stages, each tile with its own full and empty
// mbarrier, so the next tile's K loads while this tile's p.v runs.  The
// loads are 3-D (D, S, BH) tensor maps with the 128-byte swizzle, one box
// per 64 columns of D: rows past S of one head are zero-filled by TMA,
// never read from the next head, and keys >= S are masked by index (a
// zero-filled key scores 0, not -1e30).  S = Q K^T is a wgmma with both
// operands in shared memory (Q and K rows are d-contiguous: K-major);
// softmax runs in registers on the accumulator fragments (each thread
// holds two rows; max and sum across the row's quad of lanes by shuffle;
// one fused multiply-add and one ex2 a score, in log2 units).
// O += P V is a wgmma with P from registers and V (d-contiguous, so
// MN-major) transposed from shared memory.  P must be bf16 there, and one
// rounding of p to bf16 (as scaled_dot_product_attention does) puts
// outputs tens of times their bf16 limit away from the float32 function
// on random inputs, so p is split, p = p_hi + p_lo with p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), and both products go into one float32
// accumulator: the error of float32 p, at 1.5x the minimum tensor-core
// work.  The denominator l sums the float32 p.  Only the diagonal tile
// and a ragged last tile are masked.  The epilogue divides, rounds to
// bf16 and stores each thread's pairs of columns, bounds-checked.
// Softmax and the products would take turns inside a warpgroup, so the
// two consumer warpgroups ping-pong (named barriers): in its turn a
// warpgroup issues one tile's Q K^T together with the previous tile's
// P V, then lets the other issue its own while it runs the softmax.
//
// float32 (flash_f32_kernel): the CUDA-core kernel.  A block owns BQ = 64
// query rows and walks 64-key tiles; 256 threads as a 16 x 16 grid (ti,
// tj): thread (ti, tj) owns query rows ti + 16a (a < 4), the scores of
// keys tj + 16b (b < 4) of each tile and the output columns 4 tj + 64c;
// row statistics in registers, combined by half-warp shuffles; Q in
// shared memory, K then V of each tile through one shared buffer, p
// through shared memory; float32 FMA, expf, IEEE division.  Tensor cores
// (3xTF32) for it are later work.

#include <cuda.h>              // CUtensorMap (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int F32_BQ = 64;      // query rows per block
constexpr int F32_BK = 64;      // keys per tile
constexpr int PAD = 4;          // keeps rows 16-byte aligned for float4 reads

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [r0, r0 + 64) of one (S, D) matrix into dst (64 x (D+PAD)
// floats); rows at or past S are zeros.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src, int r0,
                                      int S, float* dst) {
  constexpr int kVecs = D / 4;                 // float4 per row
  for (int idx = threadIdx.x; idx < 64 * kVecs; idx += kF32Threads) {
    const int r = idx / kVecs, c = (idx - r * kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) val = load4(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + PAD) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S,
    float scale, int causal) {
  constexpr int LD = D + PAD;
  constexpr int NC = D / 64;                  // float4 output chunks
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // F32_BQ x LD
  float* kv = qs + F32_BQ * LD;       // F32_BK x LD: K, then V
  float* ps = kv + F32_BK * LD;       // F32_BQ x (F32_BK + PAD)

  const int n_qb = gridDim.x;
  const int qb = n_qb - 1 - blockIdx.x;       // longest walks first
  const size_t base = (size_t)blockIdx.y * S * D;
  const int q0 = qb * F32_BQ;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;

  stage<D>(q + base, q0, S, qs);

  float m[4], l[4], o[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[a][c][e] = 0.f;
  }

  const int n_kb = (S + F32_BK - 1) / F32_BK;
  // causal: tiles whose first key lies past the block's last row are
  // all masked (F32_BQ == F32_BK: every tile after the diagonal)
  const int kend = causal ? min(n_kb, qb + 1) : n_kb;
  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * F32_BK;
    __syncthreads();                 // the last tile's p.v is done with kv
    stage<D>(k + base, k0, S, kv);
    __syncthreads();

    // s = q . k^T for rows ti + 16a, keys tj + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = load4(qs + (ti + 16 * a) * LD + d);
#pragma unroll
      for (int b = 0; b < 4; ++b) kk[b] = load4(kv + (tj + 16 * b) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qv[a].x, kk[b].x, s[a][b]);
          s[a][b] = fmaf(qv[a].y, kk[b].y, s[a][b]);
          s[a][b] = fmaf(qv[a].z, kk[b].z, s[a][b]);
          s[a][b] = fmaf(qv[a].w, kk[b].w, s[a][b]);
        }
    }

    // scale, mask, online softmax; p to shared memory
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ti + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = k0 + tj + 16 * b;
        float x = s[a][b] * scale;
        if ((causal && row < col) || col >= S) x = kNegInf;
        s[a][b] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        sum += p;
        ps[(ti + 16 * a) * (F32_BK + PAD) + tj + 16 * b] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[a][c][e] *= corr;
    }
    __syncthreads();                 // every thread is done reading K
    stage<D>(v + base, k0, S, kv);
    __syncthreads();                 // V and p are staged

    // acc += p . v for rows ti + 16a, columns 4 tj + 64c
#pragma unroll 2
    for (int j = 0; j < F32_BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pv[a] = load4(ps + (ti + 16 * a) * (F32_BK + PAD) + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = load4(kv + (j + jj) * LD + 4 * tj + 64 * c);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = jj == 0 ? pv[a].x : jj == 1 ? pv[a].y
                          : jj == 2 ? pv[a].z : pv[a].w;
            o[a][c][0] = fmaf(p, vv.x, o[a][c][0]);
            o[a][c][1] = fmaf(p, vv.y, o[a][c][1]);
            o[a][c][2] = fmaf(p, vv.z, o[a][c][2]);
            o[a][c][3] = fmaf(p, vv.w, o[a][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ti + 16 * a;
    if (row >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    float* dst = out + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[4 * tj + 64 * c + e] = o[a][c][e] / denom;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BQ = 128;          // query rows per block (two warpgroups)
constexpr int BK = 128;          // keys per K/V tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int kBf16Threads = 384;  // consumer WGs 0, 1; producer WG 2
constexpr int kBox = 64;         // bf16 columns of one 128-byte-swizzled box
constexpr int kRowBytes = kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;

// One TMA box of a 3-D (D, S, BH) tensor map into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Named barriers (0 is __syncthreads): wait for `count` threads, or only
// count this warp in.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

constexpr float kMinusInf = -__builtin_huge_valf();

// 2^x, flushing results below 2^-126 to zero (they add nothing to a sum
// that holds a 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[0..64) (+)= A (64x16, smem, K-major) . B (16x128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..64) += A (64x16, registers) . B (16x128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..32) += A (64x16, registers) . B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
struct Bf16Smem {
  static constexpr int kHalves = D / kBox;           // boxes per row
  static constexpr int kQHalf = BQ * kRowBytes;      // one box of Q
  static constexpr int kKVHalf = BK * kRowBytes;     // one box of K or V
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kKV = kHalves * kKVHalf;      // one K (or V) tile
  static constexpr int kBars = 1 + 4 * STAGES;
  // + 1024: the base is rounded up to the swizzle's 1024-byte alignment
  static constexpr size_t kBytes = 1024 + kQ + 2 * STAGES * kKV + 8 * kBars;
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int S, float scale_log2, int causal) {
  using L = Bf16Smem<D>;
  constexpr int NO = D / 2;          // output accumulators a thread
  constexpr int NS = BK / 2;         // score accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = qs + L::kQ;                      // STAGES K tiles
  uint8_t* vs = ks + STAGES * L::kKV;            // STAGES V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * L::kKV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int qb = gridDim.x - 1 - blockIdx.x;     // longest walks first
  const int bh = blockIdx.y;
  const int q0 = qb * BQ;
  const int n_kb = (S + BK - 1) / BK;
  // causal: BQ == BK, so every tile after the block's diagonal is masked
  const int kend = causal ? min(n_kb, qb + 1) : n_kb;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);     // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the TMA loads in flight ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kQ);
      for (int h = 0; h < L::kHalves; ++h)
        tma_load(qs + h * L::kQHalf, &tq, q_full, h * kBox, q0, bh);
      for (int kb = 0; kb < kend; ++kb) {
        const int s = kb % STAGES, n = kb / STAGES;
        if (n > 0) mbar_wait(&k_empty[s], (n - 1) & 1);
        mbar_expect_tx(&k_full[s], L::kKV);
        for (int h = 0; h < L::kHalves; ++h)
          tma_load(ks + s * L::kKV + h * L::kKVHalf, &tk, &k_full[s],
                   h * kBox, kb * BK, bh);
        if (n > 0) mbar_wait(&v_empty[s], (n - 1) & 1);
        mbar_expect_tx(&v_full[s], L::kKV);
        for (int h = 0; h < L::kHalves; ++h)
          tma_load(vs + s * L::kKV + h * L::kKVHalf, &tv, &v_full[s],
                   h * kBox, kb * BK, bh);
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup -------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // this thread's two rows (accumulator fragment rows r and r + 8)
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int col_in = 2 * (lane % 4);           // + 8 j (+1)
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint8_t* q_wg = qs + wg * 64 * kRowBytes;

    // S = Q K^T (64 x BK) of tile kb, issued
    auto issue_qk = [&](float* sc, int kb) {
      const uint8_t* kt = ks + (kb % STAGES) * L::kKV;
#pragma unroll
      for (int ks16 = 0; ks16 < D / 16; ++ks16) {
        const int h = ks16 / 4, off = (ks16 % 4) * 32;   // bytes in a row
        wgmma_ss_n128(sc, sw128_desc(q_wg + h * L::kQHalf + off),
                      sw128_desc(kt + h * L::kKVHalf + off), ks16 > 0);
      }
    };
    // O += P V of tile kb, issued: p_hi, then p_lo, one accumulator
    auto issue_pv = [&](const uint32_t (*p_hi)[4],
                        const uint32_t (*p_lo)[4], int kb) {
      const uint8_t* vt = vs + (kb % STAGES) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(vt + kk * 16 * kRowBytes,
                                       L::kKVHalf);
        if constexpr (D == 128) {
          wgmma_rs_n128(o, p_hi[kk], dv);
          wgmma_rs_n128(o, p_lo[kk], dv);
        } else {
          wgmma_rs_n64(o, p_hi[kk], dv);
          wgmma_rs_n64(o, p_lo[kk], dv);
        }
      }
    };
    auto phase = [](int kb) { return (kb / STAGES) & 1; };

    mbar_wait(q_full, 0);
    // Ping-pong: the two warpgroups take turns (named barriers 1 and 2)
    // to issue their tensor-core work - this tile's Q K^T with the last
    // tile's P V - so that one's softmax runs under the other's wgmma.
    // The first turn issues Q K^T alone, the last P V alone.
    if (wg == 1) named_arrive(1, 256);           // warpgroup 0 goes first
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];  // the last tile's P
    for (int kb = 0; kb <= kend; ++kb) {
      float sc[NS];
      named_sync(1 + wg, 256);
      if (kb == 0) {
        mbar_wait(&k_full[0], 0);
        wgmma_fence();
        issue_qk(sc, 0);
        wgmma_commit();
        if (kend > 0 || wg == 0) named_arrive(2 - wg, 256);
        wgmma_wait_all();
      } else if (kb < kend) {
        mbar_wait(&k_full[kb % STAGES], phase(kb));
        mbar_wait(&v_full[(kb - 1) % STAGES], phase(kb - 1));
        fence_regs<NO>(o);
        wgmma_fence();
        issue_qk(sc, kb);
        issue_pv(p_hi, p_lo, kb - 1);
        wgmma_commit();
        named_arrive(2 - wg, 256);               // the other's turn
        wgmma_wait_all();
        fence_regs<NO>(o);
      } else {
        mbar_wait(&v_full[(kb - 1) % STAGES], phase(kb - 1));
        fence_regs<NO>(o);
        wgmma_fence();
        issue_pv(p_hi, p_lo, kb - 1);
        wgmma_commit();
        if (wg == 0) named_arrive(2, 256);       // warpgroup 1's last turn
        wgmma_wait_all();
        fence_regs<NO>(o);
        if (lane == 0) mbar_arrive(&v_empty[(kb - 1) % STAGES]);
        break;
      }
      fence_regs<NS>(sc);
      if (lane == 0) {
        mbar_arrive(&k_empty[kb % STAGES]);
        if (kb > 0) mbar_arrive(&v_empty[(kb - 1) % STAGES]);
      }
      const int k0 = kb * BK;

      // mask (a masked score is -inf: its p is 0), online softmax in
      // log2 units: m is the row max of s D^-0.5 log2(e), and
      // p = 2^(s D^-0.5 log2(e) - m) takes one fused multiply-add
      const bool mask = (causal && k0 + BK - 1 > q0 + wg * 64)
                        || k0 + BK > S;
      float mx[2] = {kMinusInf, kMinusInf};      // this tile's raw row max
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (mask) {
          const int row = row0 + ((i & 2) ? 8 : 0);
          const int col = k0 + 8 * (i / 4) + col_in + (i & 1);
          if ((causal && row < col) || col >= S) sc[i] = kMinusInf;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      // p in float32; P = p_hi + p_lo as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;          // fragment pair e
          const int r = e & 1;                   // rows r, r + 8
          const float p0 = ex2(fmaf(sc[i], scale_log2, -m[r]));
          const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -m[r]));
          l[r] += p0 + p1;
          const uint32_t hi = pack_bf16(p0, p1);
          const float2 hf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hi));
          p_hi[kk][e] = hi;
          p_lo[kk][e] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
    }

    // epilogue: the row sums over the quad, divide, round, store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const size_t base = (size_t)bh * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = out + (base + row) * D + col_in;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t v = pack_bf16(o[4 * j + 2 * r] / denom,
                                     o[4 * j + 2 * r + 1] / denom);
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t f32_smem() {
  return sizeof(float) * ((F32_BQ + F32_BK) * (D + PAD)
                          + F32_BQ * (F32_BK + PAD));
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int bh, int S, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + F32_BQ - 1) / F32_BQ, bh);
  flash_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, scale,
      causal);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime so that this library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (D, S, BH) view of a contiguous bf16 (BH, S, D) tensor, in boxes of
// 64 columns x `rows` rows x one head, 128-byte swizzle; reads past S are
// zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int S, int D,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int bh, int S, float scale, int causal,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, S, D, BQ) || !make_map(&tk, k, bh, S, D, BK)
      || !make_map(&tv, v, bh, S, D, BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Bf16Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, bh);
  flash_bf16_kernel<D><<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous, 16-byte aligned (bh, S, D) tensors of one type (bf16 = 1:
// bfloat16, 0: float); D is 64 or 128, bh <= 65535 (gridDim.y); the
// launcher checks all three.  `scale` is D^-0.5 as a float.  Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue if a tensor
// map cannot be encoded); nothing is synchronised.
extern "C" int flash_attention_apply(const void* q, const void* k,
                                     const void* v, void* out, int bf16,
                                     int bh, int S, int D, float scale,
                                     int causal, void* stream) {
  if (bh == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)(D == 64
        ? launch_bf16<64>(q, k, v, out, bh, S, scale, causal, st)
        : launch_bf16<128>(q, k, v, out, bh, S, scale, causal, st));
  return (int)(D == 64
      ? launch_f32<64>(q, k, v, out, bh, S, scale, causal, st)
      : launch_f32<128>(q, k, v, out, bh, S, scale, causal, st));
}

// Dynamic shared memory of one block of the (bf16, D) instance, in bytes.
extern "C" int flash_smem_bytes(int bf16, int D) {
  if (bf16)
    return (int)(D == 64 ? Bf16Smem<64>::kBytes : Bf16Smem<128>::kBytes);
  return (int)(D == 64 ? f32_smem<64>() : f32_smem<128>());
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
