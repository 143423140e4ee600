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
// Design.  The TPU kernel walks the batch in grid order with both scans in
// one grid step.  Here the rhs columns never interact (every sweep is
// Minv_i times a block of columns), so a CUDA block owns one batch element
// b and a slice [k0, k0+KB) of its columns and walks all nr block rows,
// forward then backward, by itself: grid (B, ceil(k/KB)), no order between
// blocks, no atomics.  The carry (s x KB) lives in shared memory in two
// ping-pong buffers laid out [kk][c] with row stride s+1: step i reads one
// and the lane that finishes row r writes the next step's input into the
// other, so each step needs one barrier.  z is written into `out` on the
// forward sweep and overwritten by x on the backward sweep - no scratch in
// device memory.  The thread that writes out[b,i,r,k] on the forward sweep
// is the one that reads it back on the backward sweep (the same warp owns
// row r in both), so no fence is needed between the sweeps.
//
// One product step: each warp owns RU consecutive output rows at a time;
// lanes split the s columns of those Minv_i rows and read them straight
// from device memory, coalesced (an s=256 block is 256 KB in f32 and
// 512 KB in f64, more than a block's 227 KB of shared memory, so Minv is
// never staged), RU*4 independent loads per lane in flight before any is
// used - the sweeps are a chain of dependent steps, so the latency of
// these loads, not their bandwidth, sets the pace.  Each lane accumulates
// RU x KB partial dots in registers; a recursive-halving shuffle leaves
// column kk's sum in lane kk (KB-1 + log2(32/KB) shuffles a row).  The
// next step's rhs (forward) or z (backward) is loaded before the product.
// Rows past s and columns past k are loaded as zero and never stored:
// nothing is padded.
//
// What bounds it.  Per batch element the sweeps are 4*nr*s^2*k flops
// (two products of s x s by s x k per block row) and read Minv twice.  At
// nr=s=k=256 that is 1.7e10 flops per crossbar: f32 FMA throughput bounds a
// Monte-Carlo batch.  At the solver path's s=64, B<=4 the work is ~4 us at
// either peak, but the 2*nr dependent steps (one barrier and one round of
// device-memory loads each) bound it: latency.  This first version is
// simple and correct; tensor cores (TF32/FP64 wgmma), TMA staging of the
// next Minv_i block and a warp-per-column-tile layout are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCU = 4;  // column chunks of 32 each lane loads per round

// Rows a warp takes at once: at most 8, and few enough that the RU*KB
// accumulators stay within 256 bytes of registers a thread.
template <typename T, int KB>
struct Rows {
  static constexpr int fit = 256 / (int)sizeof(T) / KB;
  static constexpr int value = fit >= 8 ? 8 : (fit >= 1 ? fit : 1);
};

// Sum each of the KB columns of acc[] over the warp's 32 lanes; lane l
// ends with column (l & (KB-1)), so lanes 0..KB-1 hold columns 0..KB-1.
// Recursive halving: KB-1 shuffles, then log2(32/KB) more.
template <typename T, int KB>
__device__ __forceinline__ T warp_columns(T (&acc)[KB], int lane) {
#pragma unroll
  for (int h = KB / 2; h >= 1; h /= 2) {
    const bool upper = lane & h;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const T send = upper ? acc[j] : acc[j + h];
      const T keep = upper ? acc[j + h] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  T v = acc[0];
#pragma unroll
  for (int m = KB; m < 32; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Rows r0 .. r0+RU-1 of w (s x s, row-major) times the carry `in`
// ([kk][c], row stride sp): lane kk < KB of the warp gets out[u] = the
// column-kk dot of row r0+u.  Each lane issues RU*kCU independent loads of
// w per round (coalesced along c) before it uses any of them.
template <typename T, int KB, int RU>
__device__ __forceinline__ void rows_times_carry(const T* __restrict__ w,
                                                 const T* in, int s, int sp,
                                                 int r0, int lane,
                                                 T (&out)[RU]) {
  T acc[RU][KB];
#pragma unroll
  for (int u = 0; u < RU; ++u)
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) acc[u][kk] = T(0);
  for (int c0 = lane; c0 < s; c0 += 32 * kCU) {
    T wv[RU][kCU];
#pragma unroll
    for (int u = 0; u < RU; ++u)
#pragma unroll
      for (int v = 0; v < kCU; ++v) {
        const int r = r0 + u, c = c0 + 32 * v;
        wv[u][v] = (r < s && c < s) ? w[(size_t)r * s + c] : T(0);
      }
#pragma unroll
    for (int v = 0; v < kCU; ++v) {
      const int c = c0 + 32 * v;
      if (c < s) {
        T x[KB];
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) x[kk] = in[kk * sp + c];
#pragma unroll
        for (int u = 0; u < RU; ++u)
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) acc[u][kk] += wv[u][v] * x[kk];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < RU; ++u) out[u] = warp_columns<T, KB>(acc[u], lane);
}

template <typename T, int KB>
__global__ void __launch_bounds__(kThreads, 2) block_tridiag_kernel(
    const T* __restrict__ minv, const T* __restrict__ rhs, T* __restrict__ out,
    int nr, int s, int K, T gw) {
  constexpr int RU = Rows<T, KB>::value;
  extern __shared__ unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // 2 x [KB][s+1]
  const int sp = s + 1;
  const int k0 = blockIdx.y * KB;
  const size_t blk = (size_t)s * s;
  const T* minv_b = minv + (size_t)blockIdx.x * nr * blk;
  const T* rhs_b = rhs + (size_t)blockIdx.x * nr * s * K;
  T* out_b = out + (size_t)blockIdx.x * nr * s * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int k = k0 + lane;
  const bool col_ok = lane < KB && k < K;

  // prologue: the first forward input is rhs_0 (z_{-1} = 0)
  for (int idx = threadIdx.x; idx < s * KB; idx += blockDim.x) {
    const int c = idx / KB, kk = idx - c * KB;
    buf[kk * sp + c] = (k0 + kk < K) ? rhs_b[(size_t)c * K + k0 + kk] : T(0);
  }
  __syncthreads();

  // forward sweep: z_i = Minv_i t_i, next input t_{i+1} = rhs_{i+1} + gw z_i
  int cur = 0;
  for (int i = 0; i < nr; ++i) {
    const T* w = minv_b + (size_t)i * blk;
    const T* in = buf + cur * KB * sp;
    T* nxt = buf + (cur ^ 1) * KB * sp;
    for (int r0 = warp * RU; r0 < s; r0 += n_warps * RU) {
      T rn[RU];  // rhs_{i+1}, loaded before the product needs the carry
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int r = r0 + u;
        rn[u] = (col_ok && r < s && i + 1 < nr)
                    ? rhs_b[((size_t)(i + 1) * s + r) * K + k] : T(0);
      }
      T z[RU];
      rows_times_carry<T, KB, RU>(w, in, s, sp, r0, lane, z);
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int r = r0 + u;
        if (lane < KB && r < s) {
          if (col_ok) out_b[((size_t)i * s + r) * K + k] = z[u];
          // the last z is also the first backward carry (x_{nr-1} = z_{nr-1})
          nxt[lane * sp + r] = (i + 1 < nr) ? rn[u] + gw * z[u] : z[u];
        }
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  // backward sweep: x_i = z_i + gw * Minv_i x_{i+1}; x_{nr-1} = z_{nr-1}
  // is already in `out` and in the carry
  for (int i = nr - 2; i >= 0; --i) {
    const T* w = minv_b + (size_t)i * blk;
    const T* in = buf + cur * KB * sp;
    T* nxt = buf + (cur ^ 1) * KB * sp;
    for (int r0 = warp * RU; r0 < s; r0 += n_warps * RU) {
      T zi[RU];  // z_i, written by this same lane on the forward sweep
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int r = r0 + u;
        zi[u] = (col_ok && r < s) ? out_b[((size_t)i * s + r) * K + k] : T(0);
      }
      T y[RU];
      rows_times_carry<T, KB, RU>(w, in, s, sp, r0, lane, y);
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int r = r0 + u;
        if (lane < KB && r < s) {
          const T x = col_ok ? zi[u] + gw * y[u] : T(0);
          if (col_ok) out_b[((size_t)i * s + r) * K + k] = x;
          nxt[lane * sp + r] = x;
        }
      }
    }
    cur ^= 1;
    __syncthreads();
  }
}

template <typename T, int KB>
cudaError_t launch(const T* minv, const T* rhs, T* out, int B, int nr, int s,
                   int K, double gw, cudaStream_t stream) {
  const size_t smem = (size_t)2 * KB * (s + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_tridiag_kernel<T, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, (K + KB - 1) / KB);
  block_tridiag_kernel<T, KB><<<grid, kThreads, smem, stream>>>(
      minv, rhs, out, nr, s, K, static_cast<T>(gw));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* minv, const void* rhs, void* out, int B, int nr,
             int s, int K, int kb, double gw, void* stream) {
  if (B == 0 || nr == 0 || s == 0 || K == 0) return 0;
  const T* m = static_cast<const T*>(minv);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRIDIAG_LAUNCH(KB_) \
  case KB_:                 \
    return (int)launch<T, KB_>(m, r, o, B, nr, s, K, gw, st);
  switch (kb) {
    TRIDIAG_LAUNCH(1)
    TRIDIAG_LAUNCH(2)
    TRIDIAG_LAUNCH(4)
    TRIDIAG_LAUNCH(8)
    TRIDIAG_LAUNCH(16)
    TRIDIAG_LAUNCH(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TRIDIAG_LAUNCH
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers
// of contiguous tensors: minv (B,nr,s,s), rhs (B,nr,s,k), out (B,nr,s,k),
// all of one type.  `kb` is the column slice per block, a power of two up
// to 32.  Return the launch's cudaError_t (0 on success); nothing is
// synchronised.
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

extern "C" const char* block_tridiag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
