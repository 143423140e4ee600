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
// Design.  The TPU kernel walks a grid (L, B/BB, R/BR, C/BC) in order and
// accumulates over the C axis in its output block.  Here one CUDA block owns
// one (BB x BR) output tile of one array (grid (ceil(R/BR), ceil(B/BB), L))
// and walks the whole C axis itself, so the ADC sees the complete sum with
// no split of C across blocks and no atomics.  Each step of that walk stages
// a BC-wide chunk through shared memory: v quantised on load (the DAC),
// gpos - gneg formed on load; each thread then accumulates a 4 x 4 register
// tile of outputs in float.  The epilogue scales by -inv_g0, applies the ADC
// and stores.  Ragged edges (any B, R, C) are masked: out-of-range loads are
// zeros, which the DAC keeps at zero and which add nothing.
//
// What bounds it.  Per call the inputs are (L*B*C) v elements and 2*L*R*C
// conductances, the output L*B*R floats; the products 2*L*B*R*C flops.  At
// the kernel bench's (B, R, C) = (512, 1024, 1024) that is 12.6 MB against
// 1.07 GFLOP: f32 FMA throughput bounds it (0.016 ms at 67 TFLOP/s).  At
// the batched bench's (16, 128, 128, 128) it is 4.2 MB against 67 MFLOP:
// memory bounds it.  At the example's B=1 a block computes one useful row
// of its 64: launch latency bounds it.  Tensor cores (TF32/bf16 wgmma)
// and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BB = 64;   // batch rows per block
constexpr int BR = 64;   // output rows per block
constexpr int BC = 32;   // columns per shared-memory chunk
constexpr int TB = 4;    // batch rows per thread
constexpr int TR = 4;    // output rows per thread
constexpr int PAD = 4;   // keeps rows 16-byte aligned for float4 reads
static_assert((BB / TB) * (BR / TR) == kThreads, "thread tile");

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

template <typename TV, typename TG>
__global__ void __launch_bounds__(kThreads) crossbar_kernel(
    const TV* __restrict__ v, const TG* __restrict__ gpos,
    const TG* __restrict__ gneg, float* __restrict__ out, int B, int R,
    int C, float neg_inv_g0, int dac_bits, float dac_step, int adc_bits,
    float adc_step, float fs) {
  __shared__ __align__(16) float vs[BC][BB + PAD];  // DAC(v), c-major
  __shared__ __align__(16) float gs[BC][BR + PAD];  // gpos - gneg, c-major
  const size_t l = blockIdx.z;
  const int b0 = blockIdx.y * BB, r0 = blockIdx.x * BR;
  const TV* v_l = v + l * B * C;
  const TG* gp_l = gpos + l * R * C;
  const TG* gn_l = gneg + l * R * C;
  const int tr = threadIdx.x % (BR / TR);   // this thread's rows tr*TR..
  const int tb = threadIdx.x / (BR / TR);   // and batch rows tb*TB..

  float acc[TB][TR];
#pragma unroll
  for (int i = 0; i < TB; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    // stage the chunk: consecutive threads read consecutive c (coalesced)
    for (int idx = threadIdx.x; idx < BB * BC; idx += kThreads) {
      const int bb = idx / BC, cc = idx - bb * BC;
      const int b = b0 + bb, c = c0 + cc;
      float x = 0.f;
      if (b < B && c < C)
        x = quantize(widen(v_l[(size_t)b * C + c]), dac_bits, dac_step, fs);
      vs[cc][bb] = x;
    }
    for (int idx = threadIdx.x; idx < BR * BC; idx += kThreads) {
      const int rr = idx / BC, cc = idx - rr * BC;
      const int r = r0 + rr, c = c0 + cc;
      float x = 0.f;
      if (r < R && c < C) {
        const size_t o = (size_t)r * C + c;
        x = difference(gp_l[o], gn_l[o]);
      }
      gs[cc][rr] = x;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < BC; ++cc) {
      const float4 vb = *reinterpret_cast<const float4*>(&vs[cc][tb * TB]);
      const float4 gr = *reinterpret_cast<const float4*>(&gs[cc][tr * TR]);
      const float va[TB] = {vb.x, vb.y, vb.z, vb.w};
      const float ga[TR] = {gr.x, gr.y, gr.z, gr.w};
#pragma unroll
      for (int i = 0; i < TB; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(va[i], ga[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out_l = out + l * B * R;
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const int b = b0 + tb * TB + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int r = r0 + tr * TR + j;
      if (r < R)
        out_l[(size_t)b * R + r] =
            quantize(acc[i][j] * neg_inv_g0, adc_bits, adc_step, fs);
    }
  }
}

template <typename TV, typename TG>
cudaError_t launch(const void* v, const void* gpos, const void* gneg,
                   float* out, int L, int B, int R, int C, float neg_inv_g0,
                   int dac_bits, float dac_step, int adc_bits,
                   float adc_step, float fs, cudaStream_t stream) {
  dim3 grid((R + BR - 1) / BR, (B + BB - 1) / BB, L);
  crossbar_kernel<TV, TG><<<grid, kThreads, 0, stream>>>(
      static_cast<const TV*>(v), static_cast<const TG*>(gpos),
      static_cast<const TG*>(gneg), out, B, R, C, neg_inv_g0, dac_bits,
      dac_step, adc_bits, adc_step, fs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: v (L,B,C), gpos and gneg (L,R,C), out (L,B,R) float.
// v_bf16 / g_bf16 pick bfloat16 (1) or float (0) for v and for the
// conductances.  L must fit gridDim.z (<= 65535) and ceil(B/64) gridDim.y;
// the launcher checks both.  Returns the launch's cudaError_t (0 on
// success); nothing is synchronised.
extern "C" int crossbar_mvm_apply(const void* v, const void* gpos,
                                  const void* gneg, void* out, int v_bf16,
                                  int g_bf16, int L, int B, int R, int C,
                                  float neg_inv_g0, int dac_bits,
                                  float dac_step, int adc_bits,
                                  float adc_step, float fs, void* stream) {
  if (L == 0 || B == 0 || R == 0) return 0;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XBAR_ARGS \
  v, gpos, gneg, o, L, B, R, C, neg_inv_g0, dac_bits, dac_step, adc_bits, \
      adc_step, fs, st
  if (v_bf16 && g_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(XBAR_ARGS);
  if (v_bf16) return (int)launch<__nv_bfloat16, float>(XBAR_ARGS);
  if (g_bf16) return (int)launch<float, __nv_bfloat16>(XBAR_ARGS);
  return (int)launch<float, float>(XBAR_ARGS);
#undef XBAR_ARGS
}

extern "C" const char* crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
