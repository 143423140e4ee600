// Differential crossbar MVM with fused converters, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `crossbar_mvm` and `crossbar_mvm_batched`
// of src/repro/kernels/crossbar_mvm.py (bodies `_crossbar_mvm_kernel` and
// `_crossbar_mvm_batched_kernel`; the single-array entry is the L=1 case).
// For every array l of a stack, batch row b and output row r:
//
//     out[l,b,r] = ADC( (sum_c (gpos - gneg)[l,r,c] * DAC(v[l,b,c]))
//                        * (-inv_g0) )
//
// with inv_g0 = 1/g0 rounded once to float on the host, as the Pallas kernel
// multiplies by it (the jnp oracle divides by g0 instead; the two differ by
// float rounding only).  The ADC fires after the COMPLETE sum over c.
//
// Types.  v and the conductances are float or bfloat16, independently.  v
// is widened to float before the DAC.  The differential subtract runs in
// the conductances' type - for bf16 the difference is rounded to bf16 -
// and is widened after it, as `(gpos - gneg).astype(f32)` does.  All sums
// are float; the output is float.
//
// What bounds it.  Per call the inputs are L*B*C v elements and 2*L*R*C
// conductances, the output L*B*R floats; the products 2*L*B*R*C flops a
// product.  At the kernel bench's (B, R, C) = (512, 1024, 1024) the
// operations bound it; at the batched bench's (16, 128, 128, 128) the bytes.
//
// Design, two kernels a call:
//  1. `dac_kernel` runs the DAC once per element of v (the IEEE divide of
//     quantize.cuh) and writes x (L, B, C) float: the integer codes
//     q = rint(clip(v) / step) where they are exact in tf32 (bits <= 12:
//     |q| <= 2^11, and tf32 keeps 11 significant bits), to be scaled by
//     the step in the epilogue; otherwise the quantised value q * step;
//     with an ideal DAC the widened v (skipped for float v: x is v).
//  2. `crossbar_tf32_kernel`: the product on the tensor cores, tf32
//     `wgmma` m64n32k8 with x as the A operand (64 batch rows, from
//     registers) and G = gpos - gneg as the B operand (32 output rows,
//     K-major in shared memory: both operands are K-major as stored).
//     The products that reach float32 accuracy:
//       - x exact in tf32 (codes, or bf16 v) and G float:  x.G_hi + x.G_lo
//       - x exact, G bf16 (exact in tf32):                 x.G
//       - x float (ideal DAC, float v), G float:  3xTF32,
//                                     x_lo.G_hi + x_hi.G_lo + x_hi.G_hi
//       - x float, G bf16:                        x_lo.G + x_hi.G
//     (hi = tf32(y) by cvt.rna, lo = tf32(y - hi); a single tf32 product
//     lands ~3e-4 of max|out| off, far outside the 1e-5 rule: see
//     tests/test_torch_kernels.py -k crossbar_needs).  The difference is
//     formed once, before any split: two products gpos.x - gneg.x would
//     cancel catastrophically (the two conductances are close).
//     A block owns a 64 x 32 output tile of one array and walks all of C in
//     32-deep chunks, so the ADC sees the complete sum with no split of C
//     and no atomics.  In warpgroup 1 (producer) two warps stage each
//     chunk of x, gpos and gneg through a 4-slot cp.async ring completing
//     on mbarriers (zero-filled past every edge; rows not 16-byte aligned
//     are staged element by element), and two warps form and split G into
//     128-byte-swizzled tiles in one of two operand buffers.  The split's
//     proxy fence compiles to a full memory barrier of its thread, which
//     would wait for every copy that thread has in flight: so the threads
//     that fence issue no copies, and the ring stays full.  Warpgroup 0
//     (consumer) reads its x fragments from the ring,
//     splits them where needed and runs the chunk's wgmma into a fresh
//     partial sum that is added to the running float sum (the tensor cores
//     truncate each sum into their accumulator).  mbarriers hand over the
//     buffers and ring slots; `setmaxnreg` gives the consumer the
//     producer's spare registers.  The epilogue scales by the step and
//     -inv_g0, applies the ADC and stores.  The grid is one-dimensional
//     ((array, batch tile, row tile) folded, row tiles fastest), so any L
//     and any B run.  Tiles are 64 x 32: on an H100 at (512, 1024, 1024)
//     64-wide row tiles were a little faster in 3xTF32 and much slower on
//     codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "quantize.cuh"

namespace {

constexpr int kThreads = 128;   // one warpgroup
constexpr int kHalf = 64;       // producer threads that load, and that split
constexpr int BM = 64;          // batch rows per block: wgmma's M
constexpr int BK = 32;          // depth of a chunk: one 128-byte f32 row
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int BN = 32;          // output rows per block: wgmma's N
constexpr int LDX = BK + 4;     // x chunk row stride: fragment reads hit
                                // 32 banks (4 g + t)

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// gpos - gneg in the conductances' own type, then widened
__device__ __forceinline__ float difference(float p, float n) {
  return p - n;
}
__device__ __forceinline__ float difference(__nv_bfloat16 p,
                                            __nv_bfloat16 n) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(p) - __bfloat162float(n)));
}

// ---------------------------------------------------------------------------
// 1. the DAC, once per element
// ---------------------------------------------------------------------------

// mode 0: x = v (widened); 1: x = rint(clip(v) / step), the code;
// 2: x = quantize(v), the code times the step.
template <typename TV>
__global__ void dac_kernel(const TV* __restrict__ v, float* __restrict__ x,
                           size_t n, int mode, int bits, float step,
                           float fs) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float y = widen(v[i]);
    if (mode == 1) {
      y = y < -fs ? -fs : (y > fs ? fs : y);
      y = rintf(y / step);
    } else if (mode == 2) {
      y = quantize(y, bits, step, fs);
    }
    x[i] = y;
  }
}

// ---------------------------------------------------------------------------
// 2. the product: tf32 wgmma, producer / consumer warpgroups
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, of which `bytes` are read (the rest zeros).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// y = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float y, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(y));
  const float rest = y - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d[0..16) (+)= A (64x8, registers) . B (8x32, smem, K-major), tf32
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <typename TG>
struct Smem {
  static constexpr int kOperand = BN * 128;            // one split G tile
  static constexpr int kRawX = BM * LDX * 4;           // bytes a stage
  static constexpr int kRawG = BN * BK * (int)sizeof(TG);
  static constexpr int kStage = kRawX + 2 * kRawG;
  static constexpr int kBars = 2 * STAGES + 4;     // raw_*, split_*
  static constexpr size_t kBytes =                     // + 1024: alignment
      1024 + 4 * kOperand + (size_t)STAGES * kStage + 8 * kBars;
};

// Stage chunk c0 of x (BM rows from b0, row stride LDX) and of gpos, gneg
// (BN rows from r0, row stride BK) into one ring slot, shared by the 64
// loading threads (`tid` 0..63).  VEC: 16-byte cp.async (every row 16-byte
// aligned), else element by element; zeros past every edge.
template <typename TG, bool VEC>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ x, const TG* __restrict__ gp,
    const TG* __restrict__ gn, uint8_t* slot, int b0, int r0, int c0, int B,
    int R, int C, int tid) {
  float* xs = reinterpret_cast<float*>(slot);
  TG* ps = reinterpret_cast<TG*>(slot + Smem<TG>::kRawX);
  TG* ns = ps + BN * BK;
  if constexpr (VEC) {
    for (int idx = tid; idx < BM * (BK / 4); idx += kHalf) {
      const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const int b = b0 + r, k = c0 + c;
      const int n = (b < B) ? max(0, min(4, C - k)) : 0;
      cp_async16(xs + r * LDX + c, n ? x + (size_t)b * C + k : x, 4 * n);
    }
    constexpr int E = 16 / sizeof(TG);
    for (int idx = tid; idx < BN * (BK / E); idx += kHalf) {
      const int r = idx / (BK / E), c = (idx % (BK / E)) * E;
      const int rr = r0 + r, k = c0 + c;
      const int n = (rr < R) ? max(0, min(E, C - k)) : 0;
      const size_t o = (size_t)rr * C + k;
      cp_async16(ps + r * BK + c, n ? gp + o : gp, n * (int)sizeof(TG));
      cp_async16(ns + r * BK + c, n ? gn + o : gn, n * (int)sizeof(TG));
    }
  } else {
    for (int idx = tid; idx < BM * BK; idx += kHalf) {
      const int r = idx / BK, c = idx % BK;
      const int b = b0 + r, k = c0 + c;
      xs[r * LDX + c] = (b < B && k < C) ? x[(size_t)b * C + k] : 0.f;
    }
    const TG zero = TG(0.f);
    for (int idx = tid; idx < BN * BK; idx += kHalf) {
      const int r = idx / BK, c = idx % BK;
      const int rr = r0 + r, k = c0 + c;
      const bool in = rr < R && k < C;
      const size_t o = (size_t)rr * C + k;
      ps[r * BK + c] = in ? gp[o] : zero;
      ns[r * BK + c] = in ? gn[o] : zero;
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&y)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  y[0] = q.x; y[1] = q.y; y[2] = q.z; y[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      __nv_bfloat16 (&y)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  y[0] = lo.x; y[1] = lo.y; y[2] = hi.x; y[3] = hi.y;
}

// Form G = gpos - gneg of a staged chunk and write it as the B operand:
// 16-byte column c of row r at column c ^ (r % 8) (the 128-byte swizzle),
// split into big and small tiles (GSPLIT), else one tile (bf16
// differences are exact in tf32).  Shared by the 64 splitting threads.
template <typename TG, bool GSPLIT>
__device__ __forceinline__ void form_g(const uint8_t* slot, uint8_t* big,
                                       uint8_t* small, int tid) {
  const TG* ps = reinterpret_cast<const TG*>(slot + Smem<TG>::kRawX);
  const TG* ns = ps + BN * BK;
  constexpr int N = BN * 8 / kHalf;          // 16-byte columns a thread
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = tid + u * kHalf, r = idx / 8, c = idx % 8;
    TG p[4], n[4];
    load4(ps + r * BK + 4 * c, p);
    load4(ns + r * BK + 4 * c, n);
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = difference(p[e], n[e]);
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    if constexpr (GSPLIT) {
      uint4 hi, lo;
      split_tf32(g[0], hi.x, lo.x);
      split_tf32(g[1], hi.y, lo.y);
      split_tf32(g[2], hi.z, lo.z);
      split_tf32(g[3], hi.w, lo.w);
      *reinterpret_cast<uint4*>(big + off) = hi;
      *reinterpret_cast<uint4*>(small + off) = lo;
    } else {
      *reinterpret_cast<float4*>(big + off) =
          make_float4(g[0], g[1], g[2], g[3]);
    }
  }
}

// This thread's A fragments of the x chunk `xs`: rows jr, jr + 8 (batch),
// columns t, t + 4 of each 8-deep step; split into big and small (ASPLIT)
// or taken as they are (exact in tf32).
template <bool ASPLIT>
__device__ __forceinline__ void x_fragments(const float* xs, int jr, int t,
                                            uint32_t (&big)[BK / 8][4],
                                            uint32_t (&small)[BK / 8][4]) {
#pragma unroll
  for (int k8 = 0; k8 < BK / 8; ++k8) {
    const float* p = xs + jr * LDX + 8 * k8 + t;
    const float y[4] = {p[0], p[8 * LDX], p[4], p[8 * LDX + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (ASPLIT) split_tf32(y[e], big[k8][e], small[k8][e]);
      else big[k8][e] = __float_as_uint(y[e]);
    }
  }
}

template <typename TG, bool ASPLIT, bool VEC>
__global__ void __launch_bounds__(2 * kThreads, 2) crossbar_tf32_kernel(
    const float* __restrict__ x, const TG* __restrict__ gpos,
    const TG* __restrict__ gneg, float* __restrict__ out, int B, int R,
    int C, float scale, int adc_bits, float adc_step, float fs) {
  using L = Smem<TG>;
  constexpr bool GSPLIT = sizeof(TG) == 4;
  constexpr int NA = BN / 2;                 // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_align<1024>(smem_raw);
  uint8_t* op = smem;                        // 2 x (big, small) G tiles
  uint8_t* ring = smem + 4 * L::kOperand;
  uint64_t* raw_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * L::kStage);
  uint64_t* raw_empty = raw_full + STAGES;
  uint64_t* split_full = raw_empty + STAGES;
  uint64_t* split_empty = split_full + 2;

  // (array, batch tile, row tile), row tiles fastest
  const int n_r = (R + BN - 1) / BN, n_b = (B + BM - 1) / BM;
  const int r_tile = blockIdx.x % n_r;
  const int rest = blockIdx.x / n_r;
  const int b0 = (rest % n_b) * BM, r0 = r_tile * BN;
  const size_t l = rest / n_b;
  const float* x_l = x + l * B * C;
  const TG* gp_l = gpos + l * R * C;
  const TG* gn_l = gneg + l * R * C;
  const int nk = (C + BK - 1) / BK;
  const int tid = threadIdx.x % kThreads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&raw_full[s], kHalf);
      mbar_init(&raw_empty[s], kThreads + kHalf);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&split_full[b], kHalf);
      mbar_init(&split_empty[b], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    // ---- producer: two warps load, two split ---------------------------
    // The loaders never fence, so their copies stay in flight STAGES
    // chunks ahead; the splitters' proxy fence (a full memory barrier of
    // the thread in SASS) then waits for no load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    if (tid < kHalf) {
      for (int kc = 0; kc < nk; ++kc) {
        const int slot = kc % STAGES;
        if (kc >= STAGES) mbar_wait(&raw_empty[slot], (kc / STAGES - 1) & 1);
        stage_chunk<TG, VEC>(x_l, gp_l, gn_l, ring + slot * L::kStage,
                                 b0, r0, kc * BK, B, R, C, tid);
        if constexpr (VEC) {          // arrives when this thread's copies land
          asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
                       :: "r"(smem_u32(&raw_full[slot])) : "memory");
        } else {
          mbar_arrive(&raw_full[slot]);
        }
      }
    } else {
      for (int kt = 0; kt < nk; ++kt) {
        const int slot = kt % STAGES, b = kt & 1;
        mbar_wait(&raw_full[slot], (kt / STAGES) & 1);
        if (kt >= 2) mbar_wait(&split_empty[b], ((kt >> 1) - 1) & 1);
        uint8_t* big = op + b * 2 * L::kOperand;
        form_g<TG, GSPLIT>(ring + slot * L::kStage, big,
                               big + L::kOperand, tid - kHalf);
        mbar_arrive(&raw_empty[slot]);
        // the stores (generic proxy) before the tensor cores read them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&split_full[b]);
      }
    }
  } else {
    // ---- consumer: x fragments, wgmma, the running sum -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int jr = 16 * warp + g;            // batch rows jr, jr + 8

    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int b = kt & 1, slot = kt % STAGES;
      mbar_wait(&split_full[b], (kt >> 1) & 1);
      mbar_wait(&raw_full[slot], (kt / STAGES) & 1);   // x landed (done)
      uint32_t a_big[BK / 8][4], a_small[BK / 8][4];
      x_fragments<ASPLIT>(
          reinterpret_cast<const float*>(ring + slot * L::kStage), jr, t,
          a_big, a_small);
      mbar_arrive(&raw_empty[slot]);
      const uint8_t* big = op + b * 2 * L::kOperand;
      const uint8_t* small = big + L::kOperand;
      float part[NA];
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < BK / 8; ++k8) {
        const uint64_t d_big = sw128_desc(big + 32 * k8);
        if constexpr (ASPLIT) {
          wgmma_n32(part, a_small[k8], d_big, k8 > 0);
          if constexpr (GSPLIT)
            wgmma_n32(part, a_big[k8], sw128_desc(small + 32 * k8), 1);
          wgmma_n32(part, a_big[k8], d_big, 1);
        } else {
          if constexpr (GSPLIT)
            wgmma_n32(part, a_big[k8], sw128_desc(small + 32 * k8),
                      k8 > 0);
          wgmma_n32(part, a_big[k8], d_big, GSPLIT || k8 > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NA>(part);
      mbar_arrive(&split_empty[b]);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += part[i];
    }

    // acc[4n + e] is (b, r) = (jr + 8 (e >> 1), 8n + 2t + (e & 1))
    float* out_l = out + l * B * R;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bb = b0 + jr + 8 * (e >> 1);
        const int r = r0 + 8 * n + 2 * t + (e & 1);
        if (bb < B && r < R)
          out_l[(size_t)bb * R + r] =
              quantize(acc[4 * n + e] * scale, adc_bits, adc_step, fs);
      }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename TG, bool ASPLIT, bool VEC>
cudaError_t launch_tf32(const float* x, const void* gpos, const void* gneg,
                        float* out, int L, int B, int R, int C, float scale,
                        int adc_bits, float adc_step, float fs,
                        cudaStream_t stream) {
  constexpr size_t smem = Smem<TG>::kBytes;
  auto kernel = crossbar_tf32_kernel<TG, ASPLIT, VEC>;
  // the shared-memory opt-in persists: made once a device (the call costs
  // the host a little every launch)
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = true;
  }
  const long long blocks = (long long)L * ((B + BM - 1) / BM)
                           * ((R + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 2 * kThreads, smem, stream>>>(
      x, static_cast<const TG*>(gpos), static_cast<const TG*>(gneg), out, B,
      R, C, scale, adc_bits, adc_step, fs);
  return cudaGetLastError();
}

template <typename TG, bool ASPLIT>
cudaError_t launch_vec(bool vec, const float* x, const void* gpos,
                       const void* gneg, float* out, int L, int B, int R,
                       int C, float scale, int adc_bits, float adc_step,
                       float fs, cudaStream_t stream) {
  return vec ? launch_tf32<TG, ASPLIT, true>(x, gpos, gneg, out, L, B, R, C,
                                             scale, adc_bits, adc_step, fs,
                                             stream)
             : launch_tf32<TG, ASPLIT, false>(x, gpos, gneg, out, L, B, R,
                                              C, scale, adc_bits, adc_step,
                                              fs, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: v (L,B,C), gpos and gneg (L,R,C), out (L,B,R) float,
// and x (L,B,C) float scratch for the DAC pass (unused, may be null, when
// v is float and the DAC ideal).  v_bf16 / g_bf16 pick bfloat16 (1) or
// float (0) for v and for the conductances.  `codes` (DAC on) writes the
// integer codes and scales by the step in the epilogue - only where they
// are exact in tf32 (dac_bits <= 12).  `sms` is the card's SM count (it
// sizes the DAC pass's grid).
// Returns the first launch error (0 on success); nothing is synchronised.
extern "C" int crossbar_mvm_apply(const void* v, const void* gpos,
                                  const void* gneg, void* out, void* x,
                                  int v_bf16, int g_bf16, int L, int B,
                                  int R, int C, float neg_inv_g0,
                                  int dac_bits, float dac_step, int codes,
                                  int adc_bits, float adc_step, float fs,
                                  int sms, void* stream) {
  if (L == 0 || B == 0 || R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* xs = static_cast<const float*>(v);
  float scale = neg_inv_g0;
  const int mode = dac_bits > 0 ? (codes ? 1 : 2) : 0;
  if (mode || v_bf16) {
    const size_t n = (size_t)L * B * C;
    if (n > 0) {
      const size_t want = (n + 255) / 256, most = (size_t)sms * 8;
      const int blocks = (int)(want < most ? want : most);
      if (v_bf16)
        dac_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
            static_cast<const __nv_bfloat16*>(v), static_cast<float*>(x), n,
            mode, dac_bits, dac_step, fs);
      else
        dac_kernel<float><<<blocks, 256, 0, st>>>(
            static_cast<const float*>(v), static_cast<float*>(x), n, mode,
            dac_bits, dac_step, fs);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    xs = static_cast<const float*>(x);
    if (mode == 1) scale = dac_step * neg_inv_g0;
  }
  // x is exact in tf32 as codes or as widened bf16
  const bool exact = mode == 1 || (mode == 0 && v_bf16);
  const size_t g_elt = g_bf16 ? 2 : 4;
  const bool vec = aligned16(xs) && aligned16(gpos) && aligned16(gneg)
                   && (C * 4) % 16 == 0 && (C * g_elt) % 16 == 0;
#define XBAR_ARGS \
  vec, xs, gpos, gneg, o, L, B, R, C, scale, adc_bits, adc_step, fs, st
  if (g_bf16)
    return (int)(exact ? launch_vec<__nv_bfloat16, false>(XBAR_ARGS)
                       : launch_vec<__nv_bfloat16, true>(XBAR_ARGS));
  return (int)(exact ? launch_vec<float, false>(XBAR_ARGS)
                     : launch_vec<float, true>(XBAR_ARGS));
#undef XBAR_ARGS
}

// Dynamic shared memory of one block of the product kernel, bfloat16 (1)
// or float conductances, in bytes.
extern "C" int crossbar_smem_bytes(int g_bf16) {
  return (int)(g_bf16 ? Smem<__nv_bfloat16>::kBytes : Smem<float>::kBytes);
}

extern "C" const char* crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
