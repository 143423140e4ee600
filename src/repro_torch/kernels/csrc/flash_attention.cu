// Causal (or full) online-softmax attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_flash_kernel`), and computes
// its function, not its block structure:
//
//   s   = (q . k^T) * D^-0.5           float32 (bf16 products are exact;
//                                      float32 ones as three TF32 products)
//   s   = -inf where row < col         (causal, by index) or col >= S: p = 0
//   m,l   running row max and denominator (online softmax), float32
//   acc = sum_j exp(s - m) v            float32 sums
//   out = acc / max(l, 1e-30)           IEEE division, rounded once to the
//                                       inputs' type
//
// Types and shapes.  q, k, v, out are (BH, S, D), contiguous, all float or
// all bfloat16; D is 64 or 128 (a template argument); S is any length and
// BH any count: rows and keys past S are masked by index here, nothing is
// padded.  The TPU kernel walks the grid (BH, S/bq, S/bk) in order and
// accumulates over its innermost K axis in VMEM scratch; CUDA blocks run
// concurrently, so each block owns a run of query rows of one (batch,
// head) and walks the K/V tiles in order up to the causal diagonal itself
// (tiles past it are skipped, as `pl.when` skips them): no split of K, no
// atomics.  The grid is one-dimensional, (query tile, head) folded into
// blockIdx.x with the heads fastest and the query tiles in reverse, so
// that the longest causal walks start first and BH is not bounded by
// gridDim.y's 65535.
//
// What bounds it.  4 BH D S(S+1)/2 flops on the live lower triangle
// against 4 BH S D elements moved: at the serving path's (128, 1024, 128)
// bf16 the bytes (0.040 ms) and the bf16 tensor-core operations (0.035
// ms) nearly tie; at (32, 8192, 128) the operations bound it (0.56 ms).
// In float32 the function costs three TF32 products a product on the
// tensor cores (below), and those operations bound it: 0.052 ms at
// (16, 1024, 128) full attention.  Both kernels are built for the tensor
// cores, in FlashAttention-3's shape: a producer warpgroup fills a ring of
// K/V tiles in shared memory, and consumer warpgroups of 64 query rows
// (wgmma's M) run Q K^T and P V as wgmma with the softmax in registers on
// the accumulator fragments (each thread holds two rows; max and sum
// across the row's quad of lanes by shuffle; one fused multiply-add and
// one ex2 a score, in log2 units).
//
// float32 (flash_f32_kernel): 3xTF32 wgmma.  One TF32 product keeps 11
// bits of each operand and misses the kernel's rule (1e-5 of max|out|
// against the float32 function) tens of times over; every operand x is
// split into big = tf32(x) and small = tf32(x - big), and each product is
// small.big + big.small + big.big into float32 (small.small, ~2^-22 of
// it, is dropped).  The tensor cores truncate each sum into their
// accumulator, so every 32-deep chunk of Q K^T and every tile's P V sums
// into a fresh partial that is added in float32.  tf32 wgmma reads
// shared-memory operands K-major only: Q and K rows are d-contiguous (Q
// K^T is K-major as it stands), but P V reduces over keys, so the
// producer writes V transposed, V^T with keys contiguous.  The producer
// splits with ordinary stores anyway (TMA cannot split), so it writes Q,
// K and V^T as big and small tiles in the 128-byte swizzle on the way, in
// one pass.  P comes from registers: the accumulator fragment of Q K^T
// holds keys 2t, 2t+1 of each 8-key group where the tf32 A fragment wants
// k-positions t, t+4, so the producer permutes the keys inside every
// 8-key group of V^T (even keys first, then odd: one 16-byte chunk each)
// and p is split into p_big, p_small in registers, never in shared
// memory.  A block owns BQ = 64 query rows: one consumer warpgroup and
// one producer warpgroup (256 threads); K/V tiles of 32 keys go through a
// two-stage ring handed over by mbarriers.  Shared memory: Q (64 x D) and
// two stages of K (32 x D) and V^T (D x 32), each big and small: 192 KB
// at D = 128, 96 KB at D = 64.
//
// bfloat16 (flash_bf16_kernel): a block owns BQ = 128 query rows: two
// consumer warpgroups and one producer warpgroup, of which one thread
// issues TMA loads; `setmaxnreg` moves registers from the producer (40) to
// the consumers (232).  Q (128 x D) is loaded once; K and V tiles of BK =
// 128 keys go through a ring of two stages, each tile with its own full
// and empty mbarrier, so the next tile's K loads while this tile's p.v
// runs.  The loads are 3-D (D, S, BH) tensor maps with the 128-byte
// swizzle, one box per 64 columns of D: rows past S of one head are
// zero-filled by TMA, never read from the next head, and keys >= S are
// masked by index (a zero-filled key scores 0, not -inf).  S = Q K^T is a
// wgmma with both operands in shared memory (K-major).  O += P V is a
// wgmma with P from registers (for 16-bit types the accumulator fragment
// is the A fragment) and V (d-contiguous, so MN-major) transposed from
// shared memory.  P must be bf16 there, and one rounding of p to bf16 (as
// scaled_dot_product_attention does) puts outputs tens of times their
// bf16 limit away from the float32 function on random inputs, so p is
// split, p = p_hi + p_lo with p_hi = bf16(p) and p_lo = bf16(p - p_hi),
// and both products go into one float32 accumulator: the error of float32
// p, at 1.5x the minimum tensor-core work.  The denominator l sums the
// float32 p.  Only the diagonal tile and a ragged last tile are masked.
// The epilogue divides, rounds to bf16 and stores each thread's pairs of
// columns, bounds-checked.  Softmax and the products would take turns
// inside a warpgroup, so the two consumer warpgroups ping-pong (named
// barriers): in its turn a warpgroup issues one tile's Q K^T together
// with the previous tile's P V, then lets the other issue its own while
// it runs the softmax.

#include <cuda.h>              // CUtensorMap (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF: m's start
constexpr float kMinusInf = -__builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;

// 2^x, flushing results below 2^-126 to zero (they add nothing to a sum
// that holds a 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The (query tile, head) of this block: blockIdx.x = (n_qb - 1 - qb) * bh
// + head, so the longest causal walks (the last query tiles) come first.
__device__ __forceinline__ void block_tile(int bh, int S, int bq, int& qb,
                                           int& head) {
  const int n_qb = (S + bq - 1) / bq;
  qb = n_qb - 1 - (int)(blockIdx.x / (unsigned)bh);
  head = (int)(blockIdx.x % (unsigned)bh);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;          // query rows per block: one warpgroup
constexpr int F32_BK = 32;          // keys per K/V tile
constexpr int F32_STAGES = 2;       // K/V ring depth
constexpr int kF32Threads = 256;    // consumer WG 0, producer WG 1
constexpr int kSwRow = 128;         // bytes of one swizzled row: 32 floats

template <int D>
struct F32Smem {
  static constexpr int kBoxes = D / 32;            // 128-byte boxes a row
  static constexpr int kQBox = F32_BQ * kSwRow;
  static constexpr int kQ = kBoxes * kQBox;        // Q, big or small
  static constexpr int kKBox = F32_BK * kSwRow;
  static constexpr int kK = kBoxes * kKBox;        // a K tile, big or small
  static constexpr int kVt = D * kSwRow;           // a V^T tile, big or small
  static constexpr int kStage = 2 * kK + 2 * kVt;
  static constexpr int kBars = 1 + 2 * F32_STAGES;
  // + 1024: the base is rounded up to the swizzle's 1024-byte alignment
  static constexpr size_t kBytes = 1024 + 2 * kQ + F32_STAGES * kStage
                                   + 8 * kBars;
};

// x = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// Four floats split and stored as 16 bytes at byte `off` of two tiles.
__device__ __forceinline__ void store_split(uint8_t* big, uint8_t* small,
                                            int off, float4 x) {
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(big + off) = hi;
  *reinterpret_cast<uint4*>(small + off) = lo;
}

// Rows [r0, r0 + ROWS) of one (S, D) matrix, rows past S zero, as this
// producer thread's share (`tid` 0..127): float4 u is row idx / (D/4),
// columns 4 (idx % (D/4)) .. + 3, idx = tid + 128 u.
template <int D, int ROWS>
struct RowTile {
  static constexpr int V = D / 4;                  // float4 a row
  static constexpr int N = ROWS * V / 128;         // float4 a thread
  float4 x[N];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int r0, int S, int tid) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = tid + 128 * u, r = idx / V, c = idx % V;
      x[u] = r0 + r < S
          ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D)
                  + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // K-major, 128-byte swizzle: box c / 8 (ROWS x 128 bytes), row r,
  // 16-byte column (c % 8) ^ (r % 8)
  __device__ __forceinline__ void store(uint8_t* big, uint8_t* small,
                                        int tid) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = tid + 128 * u, r = idx / V, c = idx % V;
      store_split(big, small,
                  (c / 8) * (ROWS * kSwRow) + r * kSwRow
                      + (((c % 8) ^ (r & 7)) << 4), x[u]);
    }
  }
};

// Keys [k0, k0 + 32) of V (S, D), keys past S zero, written as V^T (D rows
// of 32 keys, 128-byte swizzle) with the keys of every 8-key group g in
// the order 0, 2, 4, 6, 1, 3, 5, 7: task u of this thread is column d =
// idx % D and the even (e = 0) or odd (e = 1) keys of group g, idx / D =
// 2 g + e, idx = tid + 128 u; they land in 16-byte chunk 2 g + e of row d.
template <int D>
struct VtTile {
  static constexpr int N = 8 * D / 128;            // tasks a thread
  float x[N][4];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int k0, int S, int tid) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = tid + 128 * u, d = idx % D, ge = idx / D;
      const int key = k0 + 8 * (ge >> 1) + (ge & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[u][i] = key + 2 * i < S ? __ldg(src + (size_t)(key + 2 * i) * D + d)
                                  : 0.f;
    }
  }
  __device__ __forceinline__ void store(uint8_t* big, uint8_t* small,
                                        int tid) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = tid + 128 * u, d = idx % D, ge = idx / D;
      store_split(big, small, d * kSwRow + ((ge ^ (d & 7)) << 4),
                  make_float4(x[u][0], x[u][1], x[u][2], x[u][3]));
    }
  }
};

// d[0..16) (+)= A (64x8, smem, K-major) . B (8x32, smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_ss_n32(float* d, uint64_t da,
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

// d[0..64) (+)= A (64x8, registers) . B (8x128, smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_rs_n128(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d[0..32) (+)= A (64x8, registers) . B (8x64, smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d,
                                                  const uint32_t* a,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int BH, int S,
    float scale_log2, int causal) {
  using L = F32Smem<D>;
  constexpr int NO = D / 2;                // output accumulators a thread
  constexpr int NS = F32_BK / 2;           // score accumulators a thread
  constexpr int NCH = D / 32;              // 32-deep chunks of Q K^T
  constexpr int NK8 = F32_BK / 8;          // 8-key steps of P V
  extern __shared__ uint8_t smem_raw[];
  // rounded up to 1024 bytes by offsetting the shared array itself, so
  // that the compiler keeps shared-memory loads and stores (STS, not ST)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_big = smem;
  uint8_t* q_small = q_big + L::kQ;
  uint8_t* ring = q_small + L::kQ;          // stage: K big, K small, V^T
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + F32_STAGES * L::kStage);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                // K and V^T of a stage written
  uint64_t* empty = full + F32_STAGES;      // ... and read by the products

  int qb, bh;
  block_tile(BH, S, F32_BQ, qb, bh);
  const int q0 = qb * F32_BQ;
  const size_t base = (size_t)bh * S * D;
  const int n_kb = (S + F32_BK - 1) / F32_BK;
  // causal: tiles whose first key lies past the block's last row are masked
  const int kend = causal ? min(n_kb, (q0 + F32_BQ - 1) / F32_BK + 1) : n_kb;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 128);             // every producer thread
      mbar_init(&empty[s], 4);              // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: loads, splits, swizzles, V transposed ---------------
    const int tid = threadIdx.x - 128;
    {
      RowTile<D, F32_BQ> qt;
      qt.load(q + base, q0, S, tid);
      qt.store(q_big, q_small, tid);
    }
    // the split stores (generic proxy) before the tensor cores read them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(q_full);
    for (int kb = 0; kb < kend; ++kb) {
      const int s = kb % F32_STAGES, n = kb / F32_STAGES;
      RowTile<D, F32_BK> kt;
      VtTile<D> vt;
      kt.load(k + base, kb * F32_BK, S, tid);   // in flight while waiting
      vt.load(v + base, kb * F32_BK, S, tid);
      if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
      uint8_t* st = ring + s * L::kStage;
      kt.store(st, st + L::kK, tid);
      vt.store(st + 2 * L::kK, st + 2 * L::kK + L::kVt, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[s]);
    }
  } else {
    // ---- consumer: 64 query rows ---------------------------------------
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;
    // this thread's two rows (accumulator fragment rows r and r + 8)
    const int row0 = q0 + warp * 16 + lane / 4;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int kb = 0; kb < kend; ++kb) {
      const int s = kb % F32_STAGES;
      mbar_wait(&full[s], (kb / F32_STAGES) & 1);
      const uint8_t* k_big = ring + s * L::kStage;
      const uint8_t* k_small = k_big + L::kK;
      const uint8_t* vt_big = k_big + 2 * L::kK;
      const uint8_t* vt_small = vt_big + L::kVt;

      // S = Q K^T, each 32-deep chunk of D into its own partial
      float part[NCH][NS];
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int k8 = 0; k8 < 4; ++k8) {
          const int qo = ch * L::kQBox + 32 * k8;
          const int ko = ch * L::kKBox + 32 * k8;
          const uint64_t qb_d = sw128_desc(q_big + qo);
          const uint64_t kb_d = sw128_desc(k_big + ko);
          wgmma_tf32_ss_n32(part[ch], sw128_desc(q_small + qo), kb_d,
                            k8 > 0);
          wgmma_tf32_ss_n32(part[ch], qb_d, sw128_desc(k_small + ko), 1);
          wgmma_tf32_ss_n32(part[ch], qb_d, kb_d, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      float sc[NS];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) fence_regs<NS>(part[ch]);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] = part[0][i];
#pragma unroll
        for (int ch = 1; ch < NCH; ++ch) sc[i] += part[ch][i];
      }

      // mask, online softmax in log2 units: m is the row max of
      // s D^-0.5 log2(e), and p = 2^(s D^-0.5 log2(e) - m)
      const int k0 = kb * F32_BK;
      const bool mask = (causal && k0 + F32_BK - 1 > q0) || k0 + F32_BK > S;
      float mx[2] = {kMinusInf, kMinusInf};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (mask) {
          const int row = row0 + ((i & 2) ? 8 : 0);
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
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
      // p as tf32 A fragments, split: for keys 8 kk + (2t, 2t + 1) of rows
      // (r, r + 8), a[0], a[1] are k-position t (key 2t) and a[2], a[3]
      // k-position t + 4 (key 2t + 1), V^T's order
      uint32_t p_big[NK8][4], p_small[NK8][4];
#pragma unroll
      for (int kk = 0; kk < NK8; ++kk) {
        const float p00 = ex2(fmaf(sc[4 * kk], scale_log2, -m[0]));
        const float p01 = ex2(fmaf(sc[4 * kk + 1], scale_log2, -m[0]));
        const float p10 = ex2(fmaf(sc[4 * kk + 2], scale_log2, -m[1]));
        const float p11 = ex2(fmaf(sc[4 * kk + 3], scale_log2, -m[1]));
        l[0] += p00 + p01;
        l[1] += p10 + p11;
        split_tf32(p00, p_big[kk][0], p_small[kk][0]);
        split_tf32(p10, p_big[kk][1], p_small[kk][1]);
        split_tf32(p01, p_big[kk][2], p_small[kk][2]);
        split_tf32(p11, p_big[kk][3], p_small[kk][3]);
      }

      // this tile's P V into a fresh partial
      float op[NO];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK8; ++kk) {
        const uint64_t vb_d = sw128_desc(vt_big + 32 * kk);
        if constexpr (D == 128) {
          wgmma_tf32_rs_n128(op, p_small[kk], vb_d, kk > 0);
          wgmma_tf32_rs_n128(op, p_big[kk], sw128_desc(vt_small + 32 * kk),
                             1);
          wgmma_tf32_rs_n128(op, p_big[kk], vb_d, 1);
        } else {
          wgmma_tf32_rs_n64(op, p_small[kk], vb_d, kk > 0);
          wgmma_tf32_rs_n64(op, p_big[kk], sw128_desc(vt_small + 32 * kk),
                            1);
          wgmma_tf32_rs_n64(op, p_big[kk], vb_d, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(op);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < NO; ++i)
        o[i] = fmaf(o[i], corr[(i >> 1) & 1], op[i]);
    }

    // epilogue: the row sums over the quad, divide, store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      float* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
            o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
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
    int BH, int S, float scale_log2, int causal) {
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

  int qb, bh;
  block_tile(BH, S, BQ, qb, bh);                 // longest walks first
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

// One block per (query tile, head), folded into blockIdx.x (at most
// 2^31 - 1 blocks).
bool grid_1d(int bh, int S, int bq, unsigned& blocks) {
  const long long n = (long long)((S + bq - 1) / bq) * bh;
  blocks = (unsigned)n;
  return n <= 0x7fffffffLL;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int bh, int S, float scale, int causal,
                       cudaStream_t stream) {
  unsigned blocks;
  if (!grid_1d(bh, S, F32_BQ, blocks)) return cudaErrorInvalidValue;
  constexpr size_t smem = F32Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<D><<<blocks, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), bh, S,
      scale * kLog2e, causal);
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
  unsigned blocks;
  if (!grid_1d(bh, S, BQ, blocks)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, S, D, BQ) || !make_map(&tk, k, bh, S, D, BK)
      || !make_map(&tv, v, bh, S, D, BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Bf16Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_bf16_kernel<D><<<blocks, kBf16Threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), bh, S, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous, 16-byte aligned (bh, S, D) tensors of one type (bf16 = 1:
// bfloat16, 0: float); D is 64 or 128; the launcher checks all three.
// `scale` is D^-0.5 as a float.  Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue if a tensor map cannot be encoded or the
// grid would pass 2^31 - 1 blocks); nothing is synchronised.
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
  return (int)(D == 64 ? F32Smem<64>::kBytes : F32Smem<128>::kBytes);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
