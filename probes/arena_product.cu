// Design probe: the arena tile program's product on its chain of
// dependent tiles, on the CUDA cores (FMAs) or the tensor cores (3xTF32
// wgmma).  Not a kernel of the port: `probes/arena_product.py` builds and
// times it to decide which the arena kernel (csrc/arena_mvm.cu) should use.
//
// Each block walks T steps of y_{t+1} = A y_t + y_0 with one 64 x 64 tile
// A in shared memory and y (64 rows x KB columns) handed from step to step
// through shared memory: the arena kernel's product and its set-or-add,
// without the gather, the converters or the operator stream (which run
// off the chain or beside it).
//
//   fma: 8 warps, 8 rows each; a warp's lanes split into KB column lanes x
//        32/KB c-lanes, FMAs over c, then the arena kernel's halving
//        butterfly (`reduce_rows`); y read by broadcast from [kk][c] rows.
//   tc:  one warpgroup; A split once into tf32 big and small parts, 128-byte
//        swizzled K-major tiles; y kept split the same way as wgmma's B
//        operand (N = max(8, KB) rows); a step is 2 chunks x 4 k8-steps x
//        3 products = 24 m64nNk8 wgmma, a fresh accumulator per 32-deep
//        chunk, then each thread adds y_0, splits its outputs into the
//        other B buffer, fences the async proxy and joins one barrier.
//   tc_split (KB = 16): the tensor cores as an instance of the arena
//        kernel would run them: A arrives raw (as in a ring slot) and both
//        consumer warpgroups split it into the tiles on the chain every
//        step (a proxy fence and a barrier), then each runs 24 m64n8k8
//        wgmma for its 8 of the 16 columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/csrc/hopper.cuh"

namespace {

constexpr int R = 64, C = 64;       // the main path's tile
constexpr int kRowsPerWarp = 8;

// ---- fma -------------------------------------------------------------------

template <int CL>
__device__ __forceinline__ int reduce_rows(float (&v)[kRowsPerWarp],
                                           int lane, int& first) {
  int n = kRowsPerWarp;
  first = 0;
#pragma unroll
  for (int o = CL / 2; o >= 1; o >>= 1) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp / 2; ++i) {
        if (i < n / 2) {
          const float send = up ? v[i] : v[i + n / 2];
          const float keep = up ? v[i + n / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (up) first += n / 2;
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return n;
}

// as csrc/arena_mvm.cu::v_stride
template <int KB>
__host__ __device__ constexpr int fma_stride() {
  return C + ((32 / KB - C) % 32 + 32) % 32;
}

template <int KB>
size_t fma_smem() {
  return 4 * ((size_t)R * C + 3 * KB * fma_stride<KB>());
}

template <int KB>
__global__ void __launch_bounds__(256) fma_kernel(const float* ops,
                                                  const float* y0,
                                                  float* out, int T, int) {
  extern __shared__ float fsm[];
  constexpr int CL = 32 / KB, CP = fma_stride<KB>();
  float* w = fsm;
  float* ys = fsm + R * C;               // 2 buffers of [kk][c], then y0
  const float* y0s = ys + 2 * KB * CP;
  const float* ops_b = ops + (size_t)blockIdx.x * R * C;
  const float* y0_b = y0 + (size_t)blockIdx.x * R * KB;
  for (int i = threadIdx.x; i < R * C; i += 256) w[i] = ops_b[i];
  for (int i = threadIdx.x; i < R * KB; i += 256) {
    ys[(i % KB) * CP + i / KB] = y0_b[i];
    ys[2 * KB * CP + (i % KB) * CP + i / KB] = y0_b[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kk = lane / CL, cl = lane % CL;
  const float* wr = w + warp * kRowsPerWarp * C;
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* x = ys + cur * KB * CP + kk * CP;
    float acc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = cl; c < C; c += CL) {
      const float xv = x[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        acc[i] = fmaf(wr[i * C + c], xv, acc[i]);
    }
    int first;
    const int n = reduce_rows<CL>(acc, lane, first);
    float* y = ys + (cur ^ 1) * KB * CP + kk * CP;
    if (cl % (CL > kRowsPerWarp ? CL / kRowsPerWarp : 1) == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + first + i;
        if (i < n) y[r] = acc[i] + y0s[kk * CP + r];
      }
    }
    cur ^= 1;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * KB; i += 256)
    out[(size_t)blockIdx.x * R * KB + i] = ys[cur * KB * CP
                                              + (i % KB) * CP + i / KB];
}

// ---- tc --------------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ int sw_off(int r, int j) {
  return r * 128 + ((((j >> 2) ^ r) & 7) << 4) + (j & 3) * 4;
}

template <int N>
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

constexpr int kATile = R * 128;     // one 32-deep chunk of A: 8 KB

template <int N>
__host__ __device__ constexpr int b_tile() { return N * 128; }

template <int N>
size_t tc_smem() {
  return 1024 + 4 * kATile + 2 * 4 * b_tile<N>();
}

template <int N>
__global__ void __launch_bounds__(128) tc_kernel(const float* ops,
                                                 const float* y0,
                                                 float* out, int T,
                                                 int KB) {
  extern __shared__ uint8_t tsm[];
  uint8_t* a = smem_align<1024>(tsm);   // [chunk][big, small]
  uint8_t* bb = a + 4 * kATile;         // [buffer][chunk][big, small]
  constexpr int BT = b_tile<N>(), NA = N / 2;
  const int tid = threadIdx.x;
  const float* ops_b = ops + (size_t)blockIdx.x * R * C;
  const float* y0_b = y0 + (size_t)blockIdx.x * R * KB;
  for (int i = tid; i < R * C; i += 128) {
    const int r = i / C, c = i % C;
    uint32_t big, small;
    split_tf32(ops_b[i], big, small);
    uint8_t* at = a + 2 * (c / 32) * kATile + sw_off(r, c % 32);
    *reinterpret_cast<uint32_t*>(at) = big;
    *reinterpret_cast<uint32_t*>(at + kATile) = small;
  }
  for (int i = tid; i < 2 * 4 * BT / 4; i += 128)
    reinterpret_cast<uint32_t*>(bb)[i] = 0u;
  __syncthreads();
  auto put = [&](int buf, int r, int n, float x) {
    uint32_t big, small;
    split_tf32(x, big, small);
    uint8_t* at = bb + (buf * 4 + 2 * (r / 32)) * BT + sw_off(n, r % 32);
    *reinterpret_cast<uint32_t*>(at) = big;
    *reinterpret_cast<uint32_t*>(at + BT) = small;
  };
  for (int i = tid; i < R * KB; i += 128) put(0, i / KB, i % KB, y0_b[i]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  int row[NA], col[NA];
  float base[NA], last[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    row[e] = 16 * warp + lane / 4 + 8 * ((e >> 1) & 1);
    col[e] = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
    base[e] = col[e] < KB ? y0_b[row[e] * KB + col[e]] : 0.f;
    last[e] = base[e];
  }
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const uint8_t* bcur = bb + cur * 4 * BT;
    float part[2][NA];
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int w = 0; w < 12; ++w) {
        const int k8 = w / 3, prod = w % 3;   // small.big, big.small, big.big
        wgmma_tf32<N>(
            part[ch],
            sw128_desc(a + (2 * ch + (prod == 0)) * kATile + 32 * k8),
            sw128_desc(bcur + (2 * ch + (prod == 1)) * BT + 32 * k8),
            w > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NA>(part[0]);
    fence_regs<NA>(part[1]);
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      last[e] = part[0][e] + part[1][e] + base[e];
      if (col[e] < KB) put(cur ^ 1, row[e], col[e], last[e]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    cur ^= 1;
  }
#pragma unroll
  for (int e = 0; e < NA; ++e)
    if (col[e] < KB)
      out[(size_t)blockIdx.x * R * KB + row[e] * KB + col[e]] = last[e];
}

__global__ void __launch_bounds__(256) tc_split_kernel(const float* ops,
                                                       const float* y0,
                                                       float* out, int T,
                                                       int) {
  constexpr int KB = 16, BT = b_tile<16>();
  extern __shared__ uint8_t tsm[];
  uint8_t* a = smem_align<1024>(tsm);   // [chunk][big, small]
  uint8_t* bb = a + 4 * kATile;         // [buffer][chunk][big, small]
  float* raw = reinterpret_cast<float*>(bb + 2 * 4 * BT);   // R x C
  const int tid = threadIdx.x;
  const float* ops_b = ops + (size_t)blockIdx.x * R * C;
  const float* y0_b = y0 + (size_t)blockIdx.x * R * KB;
  for (int i = tid; i < R * C; i += 256) raw[i] = ops_b[i];
  for (int i = tid; i < 2 * 4 * BT / 4; i += 256)
    reinterpret_cast<uint32_t*>(bb)[i] = 0u;
  __syncthreads();
  auto put = [&](uint8_t* t, int tile, int r, int n, float x) {
    uint32_t big, small;
    split_tf32(x, big, small);
    uint8_t* at = t + 2 * (r / 32) * tile + sw_off(n, r % 32);
    *reinterpret_cast<uint32_t*>(at) = big;
    *reinterpret_cast<uint32_t*>(at + tile) = small;
  };
  for (int i = tid; i < R * KB; i += 256) put(bb, BT, i / KB, i % KB, y0_b[i]);

  const int warp = tid / 32, lane = tid % 32, wg = warp / 4;
  int row[4], col[4];
  float base[4], last[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    row[e] = 16 * (warp % 4) + lane / 4 + 8 * (e >> 1);
    col[e] = 8 * wg + 2 * (lane % 4) + (e & 1);
    base[e] = y0_b[row[e] * KB + col[e]];
    last[e] = base[e];
  }
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < R * C; i += 256)      // A: row i / C, depth i % C
      put(a, kATile, i % C, i / C, raw[i]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint8_t* bcur = bb + cur * 4 * BT;
    float part[2][4];
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int w = 0; w < 12; ++w) {
        const int k8 = w / 3, prod = w % 3;   // small.big, big.small, big.big
        wgmma_tf32<8>(
            part[ch],
            sw128_desc(a + (2 * ch + (prod == 0)) * kATile + 32 * k8),
            sw128_desc(bcur + (2 * ch + (prod == 1)) * BT + wg * 1024
                       + 32 * k8),
            w > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4>(part[0]);
    fence_regs<4>(part[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      last[e] = part[0][e] + part[1][e] + base[e];
      put(bb + (cur ^ 1) * 4 * BT, BT, row[e], col[e], last[e]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[(size_t)blockIdx.x * R * KB + row[e] * KB + col[e]] = last[e];
}

size_t tc_split_smem() {
  return 1024 + 4 * kATile + 2 * 4 * b_tile<16>() + 4 * R * C;
}

using Kernel = void (*)(const float*, const float*, float*, int, int);

int launch(Kernel kernel, int threads, size_t smem, size_t pad, int blocks,
           cudaStream_t st, const float* ops, const float* y0, float* out,
           int T, int KB) {
  const size_t bytes = smem > pad ? smem : pad;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, bytes, st>>>(ops, y0, out, T, KB);
  return (int)cudaGetLastError();
}

}  // namespace

// tc 0: fma, 1: 3xTF32 wgmma, 2: tc_split (KB = 16).  ops (blocks, 64,
// 64), y0 and out (blocks, 64, KB) float, KB in {1, 8, 16}.  `pad` raises
// the block's dynamic shared memory (to the arena kernel's at the case:
// as many blocks an SM).
extern "C" int probe_run(int tc, int KB, const float* ops, const float* y0,
                         float* out, int blocks, int T, long long pad,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t p = (size_t)pad;
  if (tc == 2)
    return KB == 16 ? launch(tc_split_kernel, 256, tc_split_smem(), p, blocks,
                             st, ops, y0, out, T, KB)
                    : -1;
  if (tc)
    return KB <= 8 ? launch(tc_kernel<8>, 128, tc_smem<8>(), p, blocks, st,
                            ops, y0, out, T, KB)
                   : launch(tc_kernel<16>, 128, tc_smem<16>(), p, blocks, st,
                            ops, y0, out, T, KB);
  switch (KB) {
    case 1:
      return launch(fma_kernel<1>, 256, fma_smem<1>(), p, blocks, st, ops,
                    y0, out, T, KB);
    case 8:
      return launch(fma_kernel<8>, 256, fma_smem<8>(), p, blocks, st, ops,
                    y0, out, T, KB);
    case 16:
      return launch(fma_kernel<16>, 256, fma_smem<16>(), p, blocks, st, ops,
                    y0, out, T, KB);
  }
  return -1;
}
