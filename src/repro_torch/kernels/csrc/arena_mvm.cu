// Arena tile program of the BlockAMC arena executor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `arena_packed_apply` of
// src/repro/kernels/arena_mvm.py (body `_arena_packed_kernel`; its M=1 entry
// `arena_level_apply` is the same body).  For each instance i and each tile
// t IN SCHEDULE ORDER:
//
//     v   = sum_j sign[t,j] * arena[i, in_off[t,j] : +C, :]     (C x K)
//     out = ADC(ops[i,t] @ DAC(v))                               (R x K)
//     arena[i, out_off[t] : +R, :]  =  out   if out_init[t]
//                                   +=  out  otherwise
//
// Design.  The TPU kernel walks a grid (M, T) in order.  A CUDA grid has no
// order, but every rhs column passes through the whole cascade on its own:
// the gathers, the products and both quantisers act column by column.  So a
// block owns a column slice [k0, k0+KB) of one instance and walks all T
// tiles itself, with no synchronisation across blocks: grid (M, ceil(K/KB)).
// One step of the loop:
//   1. gather the J signed windows into shared memory (KB x C, row stride
//      C+1 so neither the gather's writes nor the product's reads conflict
//      on banks), DAC, __syncthreads();
//   2. one warp per output row: lanes split C, read ops[i,t,r,:] straight
//      from global memory (coalesced; an R x C f32 tile of 256 x 256 is
//      256 KB and does not fit in shared memory), accumulate in f32 and
//      reduce across the warp with shuffles;
//   3. ADC, then set or add into the arena window in global memory,
//      __syncthreads().
// The gather finishes before any write, because a tile may read the window
// it writes; no atomics anywhere, because the tiles of one MVM tile-row add
// into one window and must do so in schedule order.
//
// Quantisation is `quantize` of quantize.cuh (shared with crossbar_mvm.cu):
// clip, IEEE divide by the step, round half to even, multiply back.
//
// What bounds it.  Per call the operators are 4*M*T*R*C bytes and the
// products 2*M*T*R*C*K flops.  At the serving main path (M=16, T=23,
// R=C=64, K=8) that is 6.0 MB and 24 MFLOP: memory and launch latency bound
// it.  At M=128, K=128 it is 48 MB and 3.1 GFLOP: f32 FMA throughput bounds
// it.  This first version is simple and correct; tensor cores (TF32
// wgmma/mma.sync) and staging the operators through TMA are later work.
//
// Window offsets come from the compile-time allocator and are checked where
// they are made; a window that would leave the arena is skipped here, so a
// bad offset can never touch memory outside the buffer.

#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;

template <int KB>
__global__ void __launch_bounds__(kThreads) arena_packed_kernel(
    float* __restrict__ arena, const float* __restrict__ ops,
    const int* __restrict__ in_offs, const float* __restrict__ in_signs,
    const int* __restrict__ out_offs, const int* __restrict__ out_init,
    int S, int K, int T, int R, int C, int J, int dac_bits, float dac_step,
    int adc_bits, float adc_step, float fs) {
  extern __shared__ float vs[];  // vs[kk * (C + 1) + c]
  const int cp = C + 1;
  const int k0 = blockIdx.y * KB;
  float* arena_i = arena + (size_t)blockIdx.x * S * K;
  const float* ops_i = ops + (size_t)blockIdx.x * T * R * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int t = 0; t < T; ++t) {
    // 1. signed whole-window gather (kk fastest: coalesced along K), DAC
    for (int idx = threadIdx.x; idx < C * KB; idx += blockDim.x) {
      const int c = idx / KB, kk = idx - c * KB, k = k0 + kk;
      float acc = 0.f;
      if (k < K) {
        for (int j = 0; j < J; ++j) {
          const int off = in_offs[t * J + j];
          if (off < 0 || off > S - C) continue;
          acc += in_signs[t * J + j] * arena_i[(size_t)(off + c) * K + k];
        }
      }
      vs[kk * cp + c] = quantize(acc, dac_bits, dac_step, fs);
    }
    __syncthreads();

    // 2-3. one warp per output row, then ADC and set/add into the arena
    const float* w = ops_i + (size_t)t * R * C;
    const int o = out_offs[t];
    const bool init = out_init[t] != 0;
    const bool o_ok = o >= 0 && o <= S - R;
    for (int r = warp; r < R; r += n_warps) {
      float acc[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) acc[kk] = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float wv = w[(size_t)r * C + c];
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) acc[kk] = fmaf(wv, vs[kk * cp + c],
                                                       acc[kk]);
      }
      float mine = 0.f;  // lane kk keeps column kk's sum
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        float s = acc[kk];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, m);
        if (lane == kk) mine = s;
      }
      const int k = k0 + lane;
      if (o_ok && lane < KB && k < K) {
        const float val = quantize(mine, adc_bits, adc_step, fs);
        float* dst = arena_i + (size_t)(o + r) * K + k;
        *dst = init ? val : *dst + val;
      }
    }
    __syncthreads();
  }
}

template <int KB>
cudaError_t launch(float* arena, const float* ops, const int* in_offs,
                   const float* in_signs, const int* out_offs,
                   const int* out_init, int M, int S, int K, int T, int R,
                   int C, int J, int dac_bits, float dac_step, int adc_bits,
                   float adc_step, float fs, cudaStream_t stream) {
  const size_t smem = (size_t)KB * (C + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        arena_packed_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(M, (K + KB - 1) / KB);
  arena_packed_kernel<KB><<<grid, kThreads, smem, stream>>>(
      arena, ops, in_offs, in_signs, out_offs, out_init, S, K, T, R, C, J,
      dac_bits, dac_step, adc_bits, adc_step, fs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: arena (M,S,K) f32 updated in place, ops (M,T,R,C) f32,
// in_offs/in_signs (T,J) i32/f32, out_offs/out_init (T,) i32.  `kb` is the
// column slice per block, a power of two up to 32.  Returns the launch's
// cudaError_t (0 on success); nothing is synchronised.
extern "C" int arena_packed_apply_f32(
    void* arena, const void* ops, const void* in_offs, const void* in_signs,
    const void* out_offs, const void* out_init, int M, int S, int K, int T,
    int R, int C, int J, int kb, int dac_bits, float dac_step, int adc_bits,
    float adc_step, float fs, void* stream) {
  if (M == 0 || K == 0 || T == 0 || R == 0) return 0;
  float* a = static_cast<float*>(arena);
  const float* w = static_cast<const float*>(ops);
  const int* io = static_cast<const int*>(in_offs);
  const float* is = static_cast<const float*>(in_signs);
  const int* oo = static_cast<const int*>(out_offs);
  const int* oi = static_cast<const int*>(out_init);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARENA_LAUNCH(KB_)                                                   \
  case KB_:                                                                 \
    return (int)launch<KB_>(a, w, io, is, oo, oi, M, S, K, T, R, C, J,      \
                            dac_bits, dac_step, adc_bits, adc_step, fs, st);
  switch (kb) {
    ARENA_LAUNCH(1)
    ARENA_LAUNCH(2)
    ARENA_LAUNCH(4)
    ARENA_LAUNCH(8)
    ARENA_LAUNCH(16)
    ARENA_LAUNCH(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ARENA_LAUNCH
}

extern "C" const char* arena_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
