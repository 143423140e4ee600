// Causal (or full) online-softmax attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_flash_kernel`), and computes
// its function, not its block structure:
//
//   s   = (q . k^T) * D^-0.5           float32, inputs widened to float32
//   s   = -1e30 where row < col        (causal, by index) or col >= S
//   m,l   running row max and denominator (online softmax)
//   acc = sum_j exp(s - m) v            float32, p kept in float32
//   out = acc / max(l, 1e-30)           cast to the inputs' type
//
// Types and shapes.  q, k, v, out are (BH, S, D), contiguous, all float or
// all bfloat16; D is 64 or 128 (a template argument); S is any length:
// rows and keys past S are bounds-checked here, nothing is padded.
//
// Design.  The TPU kernel walks the grid (BH, S/bq, S/bk) in order and
// accumulates over its innermost K axis in VMEM scratch, revisiting the
// output block.  CUDA blocks run concurrently, so that ordered
// accumulation stays inside one block: a block owns BQ = 64 query rows of
// one (batch, head) and walks the K/V tiles of BK = 64 keys in order up to
// the causal diagonal itself (tiles past it are skipped, as `pl.when`
// skips them); no split of K, no atomics.  The grid is (ceil(S/BQ), BH),
// the query tiles in reverse so that the longest causal walks start first.
//
// 256 threads, as a 16 x 16 grid (ti, tj).  Thread (ti, tj) owns query
// rows ti + 16a (a < 4): the scores of keys tj + 16b (b < 4) of each
// tile, and the output columns 4 tj + 64c (c < D/64, four each).  Its
// rows' max, denominator and output accumulators stay in its registers
// for the whole walk; the 16 threads of a row (one half-warp) combine
// their row max and row sum with shuffles.  Q stays in shared memory; K,
// then V, of each tile pass through one shared buffer; the probabilities
// p go through shared memory from the (row, key) layout of the scores to
// the (row, column) layout of p.v.  The interleaved ownership keeps the
// float4 shared reads free of bank conflicts.  Every product is a
// float32 fused multiply-add on the CUDA cores; expf, IEEE division, no
// fast-math.
//
// What bounds it.  4 BH D S(S+1)/2 flops on the live lower triangle
// against 4 BH S D elements moved.  At the serving path's (128, 1024, 128)
// in bf16 the card could do it in 0.040 ms (bytes; the operations take
// 0.035 ms at the bf16 tensor-core peak), at (32, 8192, 128) in 0.56 ms
// (operations).  This kernel runs on the CUDA cores, whose f32 peak alone
// puts the serving shape at 0.51 ms; tensor cores (mma.sync / wgmma on
// bf16) fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int PAD = 4;        // keeps rows 16-byte aligned for float4 reads
constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

__device__ __forceinline__ void narrow(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);    // round to nearest even, as torch
}

// Four consecutive elements of a row, widened to float.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage rows [r0, r0 + 64) of one (S, D) matrix into dst (64 x (D+PAD)
// floats); rows at or past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int S, float* dst) {
  constexpr int kVecs = D / 4;                 // float4 per row
  for (int idx = threadIdx.x; idx < 64 * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx - r * kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) val = load4(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + PAD) + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, float scale,
    int causal) {
  constexpr int LD = D + PAD;
  constexpr int NC = D / 64;                  // float4 output chunks
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // BQ x LD
  float* kv = qs + BQ * LD;                   // BK x LD: K, then V
  float* ps = kv + BK * LD;                   // BQ x (BK + PAD)

  const int n_qb = gridDim.x;
  const int qb = n_qb - 1 - blockIdx.x;       // longest walks first
  const size_t base = (size_t)blockIdx.y * S * D;
  const int q0 = qb * BQ;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;

  stage<T, D>(q + base, q0, S, qs);

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

  const int n_kb = (S + BK - 1) / BK;
  // causal: tiles whose first key lies past the block's last row are
  // all masked (BQ == BK, so that is every tile after the diagonal)
  const int kend = causal ? min(n_kb, qb + 1) : n_kb;
  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                 // the last tile's p.v is done with kv
    stage<T, D>(k + base, k0, S, kv);
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
        ps[(ti + 16 * a) * (BK + PAD) + tj + 16 * b] = p;
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
    stage<T, D>(v + base, k0, S, kv);
    __syncthreads();                 // V and p are staged

    // acc += p . v for rows ti + 16a, columns 4 tj + 64c
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pv[a] = load4(ps + (ti + 16 * a) * (BK + PAD) + j);
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
    T* dst = out + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        narrow(o[a][c][e] / denom, dst + 4 * tj + 64 * c + e);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int S, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int LD = D + PAD;
  constexpr size_t smem =
      sizeof(float) * ((BQ + BK) * LD + BQ * (BK + PAD));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, bh);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int bh, int S, int D, float scale, int causal,
                     cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(q, k, v, out, bh, S, scale, causal,
                                    stream);
  if (D == 128) return launch<T, 128>(q, k, v, out, bh, S, scale, causal,
                                      stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous (bh, S, D) tensors of one type (bf16 = 1: bfloat16, 0: float);
// D is 64 or 128, bh <= 65535 (gridDim.y); the launcher checks both.
// `scale` is D^-0.5 as a float.  Returns the launch's cudaError_t (0 on
// success); nothing is synchronised.
extern "C" int flash_attention_apply(const void* q, const void* k,
                                     const void* v, void* out, int bf16,
                                     int bh, int S, int D, float scale,
                                     int causal, void* stream) {
  if (bh == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, bh, S, D, scale,
                                        causal, st);
  return (int)dispatch<float>(q, k, v, out, bh, S, D, scale, causal, st);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
