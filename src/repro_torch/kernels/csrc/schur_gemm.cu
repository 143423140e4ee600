// Fused Schur-complement update  out = A4 - A3 @ W,  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `schur_update` of
// src/repro/kernels/schur_gemm.py (body `_schur_kernel`): a GEMM whose
// accumulator is initialised from A4 and which subtracts the products, so
// the (I x J) output makes one trip to device memory instead of a
// matmul-then-subtract pair.
//
// Types.  a4 (I,J), a3 (I,K), w (K,J) are all float or all bfloat16; bf16
// values are widened to float on load.  Every sum is float (TF32 is not
// used); the output is float.
//
// Design.  The TPU kernel walks a grid (I/BI, J/BJ, K/BK) in order and
// accumulates over K in its output block.  Here one CUDA block owns one
// (BI x BJ) output tile (grid (ceil(J/BJ), ceil(I/BI))) and walks the whole
// K axis itself, with no split of K across blocks and no atomics.  Each
// thread holds a 4 x 4 register tile, loaded from A4 first; every step of
// the walk stages a BK-deep chunk of A3 (transposed, k-major) and of W
// through shared memory, and each thread subtracts its products with
// fused multiply-adds.  One store follows.  Ragged edges are masked:
// out-of-range loads are zeros.
//
// What bounds it.  2*I*J*K flops against 4*(I*J + I*K + K*J + I*J) bytes:
// at the kernel bench's n = 512 and 1024 the flops bound it (0.004 and
// 0.032 ms at 67 TFLOP/s on the CUDA cores).  This simple tiling reaches a
// fraction of that; tensor cores (TF32/bf16 wgmma) fed by TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BI = 64;   // output rows per block
constexpr int BJ = 64;   // output columns per block
constexpr int BK = 32;   // depth of one shared-memory chunk
constexpr int TI = 4;    // output rows per thread
constexpr int TJ = 4;    // output columns per thread
constexpr int PAD = 4;   // keeps rows 16-byte aligned for float4 reads
static_assert((BI / TI) * (BJ / TJ) == kThreads, "thread tile");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) schur_kernel(
    const T* __restrict__ a4, const T* __restrict__ a3,
    const T* __restrict__ w, float* __restrict__ out, int I, int J, int K) {
  __shared__ __align__(16) float as[BK][BI + PAD];  // A3 chunk, k-major
  __shared__ __align__(16) float ws[BK][BJ + PAD];  // W chunk
  const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;
  const int tj = threadIdx.x % (BJ / TJ);   // columns tj*TJ..
  const int ti = threadIdx.x / (BJ / TJ);   // rows ti*TI..

  float acc[TI][TJ];                        // initialised from A4
#pragma unroll
  for (int a = 0; a < TI; ++a) {
    const int i = i0 + ti * TI + a;
#pragma unroll
    for (int b = 0; b < TJ; ++b) {
      const int j = j0 + tj * TJ + b;
      acc[a][b] = (i < I && j < J) ? widen(a4[(size_t)i * J + j]) : 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A3 rows are k-contiguous: consecutive threads read consecutive k
    for (int idx = threadIdx.x; idx < BI * BK; idx += kThreads) {
      const int ii = idx / BK, kk = idx - ii * BK;
      const int i = i0 + ii, k = k0 + kk;
      as[kk][ii] = (i < I && k < K) ? widen(a3[(size_t)i * K + k]) : 0.f;
    }
    // W rows are j-contiguous
    for (int idx = threadIdx.x; idx < BK * BJ; idx += kThreads) {
      const int kk = idx / BJ, jj = idx - kk * BJ;
      const int k = k0 + kk, j = j0 + jj;
      ws[kk][jj] = (k < K && j < J) ? widen(w[(size_t)k * J + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ti * TI]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tj * TJ]);
      const float ar[TI] = {av.x, av.y, av.z, av.w};
      const float wr[TJ] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int b = 0; b < TJ; ++b) acc[a][b] = fmaf(-ar[a], wr[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TI; ++a) {
    const int i = i0 + ti * TI + a;
    if (i >= I) continue;
#pragma unroll
    for (int b = 0; b < TJ; ++b) {
      const int j = j0 + tj * TJ + b;
      if (j < J) out[(size_t)i * J + j] = acc[a][b];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a4, const void* a3, const void* w,
                   float* out, int I, int J, int K, cudaStream_t stream) {
  dim3 grid((J + BJ - 1) / BJ, (I + BI - 1) / BI);
  schur_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a4), static_cast<const T*>(a3),
      static_cast<const T*>(w), out, I, J, K);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: a4 (I,J), a3 (I,K), w (K,J) of one type (bf16 = 1:
// bfloat16, 0: float), out (I,J) float.  ceil(I/64) must fit gridDim.y
// (<= 65535); the launcher checks it.  Returns the launch's cudaError_t
// (0 on success); nothing is synchronised.
extern "C" int schur_update_apply(const void* a4, const void* a3,
                                  const void* w, void* out, int bf16, int I,
                                  int J, int K, void* stream) {
  if (I == 0 || J == 0) return 0;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)launch<__nv_bfloat16>(a4, a3, w, o, I, J, K, st);
  return (int)launch<float>(a4, a3, w, o, I, J, K, st);
}

extern "C" const char* schur_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
