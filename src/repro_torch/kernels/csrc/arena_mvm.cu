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
// Order.  The TPU kernel walks a grid (M, T) in order.  A CUDA grid has no
// order, but every rhs column passes through the whole cascade on its own:
// the gathers, the products and both quantisers act column by column.  So a
// block owns a column slice [k0, k0+KB) of one instance and walks all T
// tiles itself, with no synchronisation across blocks: grid (M, ceil(K/KB)).
// The gather of a tile finishes before its write, because a tile may read
// the window it writes; nothing is atomic, because the tiles of one MVM
// tile-row add into one window and must do so in schedule order.
//
// What bounds it.  Per call the operators are 4*M*T*R*C bytes and the
// products 2*M*T*R*C*K flops.  At the serving main path (M=16, T=23,
// R=C=64, K=8) that is 6.0 MB and 24 MFLOP, a bound of 2 us; what a block
// actually waits on is latency: 23 dependent tiles, each a gather, a
// product and a write that the next tile may read.  So nothing on that
// chain touches device memory (the `smem` instance):
//   * the block's arena slice (S rows x KB columns) and the window
//     metadata are loaded into shared memory once, by cp.async all in
//     flight together, and the slice is written back once at the end; the
//     next tile's first four window terms and its output window are read
//     into registers while the current tile's products run;
//   * the operators never depend on the cascade, so one producer warp
//     streams ops[i] - one contiguous run of T*R*C floats, read front to
//     back - through a ring of 64-row panels with 1-D bulk copies (TMA)
//     completing on mbarriers, as far ahead of the consumers as the ring
//     reaches.  A panel whose start or length is not a multiple of 16
//     bytes (C % 4 != 0) gets its ragged head and tail by 4-byte cp.async
//     on the same mbarrier, and lands in its slot at the same offset mod 16
//     as in device memory;
//   * eight consumer warps run each tile: gather the J signed windows and
//     DAC into shared memory (kk fastest, so neither the arena reads nor
//     the writes conflict on banks), then per panel each warp owns 8 rows:
//     its lanes split into KB column lanes x 32/KB c-lanes (W reads are
//     broadcasts of 32/KB consecutive floats; v reads hit 32 banks through
//     the row stride), accumulate in f32 on the CUDA cores, reduce the
//     c-lanes by a halving butterfly (8 rows over 32 lanes in 9 shuffles),
//     ADC and set or add into the shared slice.  Two consumer barriers a
//     tile: v ready; the tile's writes done before the next gather.
// The product stays on FMAs.  At the serving shape (1 column a block) a
// 64 x 64 tile as 3xTF32 wgmma is 24 instructions, each tens of cycles to
// issue, slower on the chain than the tile's 4K FMAs.  At 16 columns a
// block the FMAs are bound by the shared-memory loads of ops and the
// tensor cores multiply faster, but only with ops split ahead: split on
// the chain, in tiles that halve the blocks an SM, they lose
// (probes/arena_product.py times all three; PERF.md).
//
// A slice that does not fit in shared memory even at KB = 1 (S above ~50k
// rows) runs the `global` instance: the same walk with the arena in device
// memory and one warp per output row reading ops straight from device
// memory.  The launcher picks the instance and KB from the shapes alone.
//
// Quantisation is `quantize` of quantize.cuh (shared with crossbar_mvm.cu):
// clip, IEEE divide by the step, round half to even, multiply back.
//
// Window offsets come from the compile-time allocator and are checked where
// they are made; a window that would leave the arena is skipped here, so a
// bad offset can never touch memory outside the buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "quantize.cuh"

namespace {

// ---------------------------------------------------------------------------
// smem instance: the slice in shared memory, ops streamed through a ring
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;                      // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kSmemThreads = kConsumers + 32;  // + the producer warp
constexpr int kRowsPerWarp = 8;
constexpr int kPanel = kWarps * kRowsPerWarp;  // rows of one ring slot: 64
constexpr int kTerms = 4;       // window terms a tile read ahead, in registers

// Floats of one ring slot: a 64-row panel of C, up to 3 floats of
// misalignment in front, rounded up to 128 bytes.
__host__ __device__ __forceinline__ int slot_floats(int C) {
  return (kPanel * C + 3 + 31) / 32 * 32;
}

// Row stride of the DAC'd tile v (KB rows of C): congruent to 32/KB mod 32,
// so lane (kk, cl) = kk * 32/KB + cl reads bank (kk * 32/KB + cl) % 32.
__host__ __device__ __forceinline__ int v_stride(int C, int KB) {
  const int cl = 32 / KB;
  return C + ((cl - C) % 32 + 32) % 32;
}

// Shared memory of one block, in bytes: the ring, its 2 x stages mbarriers,
// the window metadata, the arena slice (S x KB) and v (exported as
// arena_smem_bytes, which kernels/arena_mvm.py::plan sizes launches by).
__host__ __device__ __forceinline__ size_t smem_bytes(int S, int T, int J,
                                                      int C, int KB,
                                                      int stages) {
  return 128 + 4 * ((size_t)stages * slot_floats(C)) + 16 * (size_t)stages
         + 4 * (2 * (size_t)T * J + 2 * (size_t)T)
         + 4 * ((size_t)S * KB + (size_t)KB * v_stride(C, KB));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Reduce v[8] (this lane's partial sums of 8 rows) over the CL lanes that
// share lane / CL (the lane bits below CL).  Halving steps while a lane
// holds more than one row - each lane keeps half the rows and adds its
// partner's share of them - then plain ones.  Afterwards v[0..n) holds
// the whole sums of rows first + [0, n), n = max(1, 8 / CL) as returned,
// and lanes that differ only in the plain steps' bits hold the same sums.
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

// Copy n floats of ops at src into the ring slot at `slot`, completing on
// `full`: the 16-byte-aligned body by one bulk copy, a ragged head and tail
// by 4-byte cp.async; the data lands at slot + (src % 16) / 4.  One thread.
__device__ __forceinline__ void copy_panel(float* slot, const float* src,
                                           int n, uint64_t* full) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) / 4;
  float* dst = slot + mis;
  const int head = mis ? min(n, 4 - mis) : 0;
  const int body = (n - head) / 4 * 4;
  for (int e = 0; e < head; ++e) cp_async_4(dst + e, src + e);
  for (int e = head + body; e < n; ++e) cp_async_4(dst + e, src + e);
  if (head + body < n || head) cp_async_mbar_arrive(full);
  mbar_expect_tx(full, 4u * body);
  if (body) bulk_copy_g2s(dst + head, src + head, 4u * body, full);
}

template <int KB>
__global__ void __launch_bounds__(kSmemThreads) arena_smem_kernel(
    float* __restrict__ arena, const float* __restrict__ ops,
    const int* __restrict__ in_offs, const float* __restrict__ in_signs,
    const int* __restrict__ out_offs, const int* __restrict__ out_init,
    int S, int K, int T, int R, int C, int J, int stages, int dac_bits,
    float dac_step, int adc_bits, float adc_step, float fs) {
  constexpr int CL = 32 / KB;                // c-lanes of one column lane
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_align<128>(smem_raw));
  const int slot = slot_floats(C);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * slot);
  uint64_t* empty = full + stages;
  int* m_in = reinterpret_cast<int*>(empty + stages);   // T x J
  float* m_sign = reinterpret_cast<float*>(m_in + T * J);
  int* m_out = reinterpret_cast<int*>(m_sign + T * J);   // T
  int* m_init = m_out + T;
  float* as = reinterpret_cast<float*>(m_init + T);      // S x KB
  float* vs = as + S * KB;                               // KB x v_stride
  const int cp = v_stride(C, KB);
  const int k0 = blockIdx.y * KB;
  float* arena_i = arena + (size_t)blockIdx.x * S * K;
  const float* ops_i = ops + (size_t)blockIdx.x * T * R * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int panels = (R + kPanel - 1) / kPanel;

  // the window metadata and the block's arena slice into shared memory:
  // the consumers' cp.async, all in flight at once
  if (warp < kWarps) {
    for (int idx = threadIdx.x; idx < T * J; idx += kConsumers) {
      cp_async_4(m_in + idx, in_offs + idx);
      cp_async_4(m_sign + idx, in_signs + idx);
    }
    for (int t = threadIdx.x; t < T; t += kConsumers) {
      cp_async_4(m_out + t, out_offs + t);
      cp_async_4(m_init + t, out_init + t);
    }
    for (int idx = threadIdx.x; idx < S * KB; idx += kConsumers) {
      const int r = idx / KB, kk = idx % KB, k = k0 + kk;
      if (k < K) cp_async_4(as + idx, arena_i + (size_t)r * K + k);
      else as[idx] = 0.f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: stream ops[i] panel by panel through the ring --------
    if (lane == 0) {
      for (int q = 0; q < T * panels; ++q) {
        const int s = q % stages;
        if (q >= stages) mbar_wait(&empty[s], (q / stages - 1) & 1);
        const int t = q / panels, r0 = (q % panels) * kPanel;
        copy_panel(ring + s * slot,
                   ops_i + (size_t)t * R * C + (size_t)r0 * C,
                   min(kPanel, R - r0) * C, &full[s]);
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  consumer_sync();

  const int kk = lane / CL, cl = lane % CL;
  constexpr int kPlain = CL > kRowsPerWarp ? CL / kRowsPerWarp - 1 : 0;
  const bool writer = (cl & kPlain) == 0;
  const int ops_mis = static_cast<int>(
      reinterpret_cast<uintptr_t>(ops_i) & 15) / 4;
  int slot_i = 0, phase = 0;            // the ring slot and its parity

  // The next tile's first kTerms window terms (offset, or -1 for a window
  // skipped, and sign) and its output window, read into registers while
  // the current tile's products run: off the chain of dependent tiles.
  int n_off[kTerms], n_out = 0, n_init = 0;
  float n_sign[kTerms];
  auto read_terms = [&](int t) {
#pragma unroll
    for (int j = 0; j < kTerms; ++j) {
      const int off = j < J ? m_in[t * J + j] : -1;
      const bool ok = off >= 0 && off <= S - C;
      n_off[j] = ok ? off : -1;
      n_sign[j] = ok ? m_sign[t * J + j] : 0.f;
    }
    n_out = m_out[t];
    n_init = m_init[t];
  };
  read_terms(0);
  for (int t = 0; t < T; ++t) {
    // 1. signed whole-window gather, DAC
    for (int idx = threadIdx.x; idx < C * KB; idx += kConsumers) {
      const int c = idx / KB, k_ = idx % KB;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kTerms; ++j)
        if (n_off[j] >= 0) acc += n_sign[j] * as[(n_off[j] + c) * KB + k_];
      for (int j = kTerms; j < J; ++j) {
        const int off = m_in[t * J + j];
        if (off < 0 || off > S - C) continue;
        acc += m_sign[t * J + j] * as[(off + c) * KB + k_];
      }
      vs[k_ * cp + c] = quantize(acc, dac_bits, dac_step, fs);
    }
    consumer_sync();

    // 2-3. per panel: 8 rows a warp, then ADC and set/add into the slice
    const int o = n_out;
    const bool init = n_init != 0;
    const bool o_ok = o >= 0 && o <= S - R;
    if (t + 1 < T) read_terms(t + 1);
    for (int p = 0; p < panels; ++p) {
      const int r0 = p * kPanel;
      // the panel lands at its offset mod 16 bytes in device memory
      const int mis = (ops_mis + static_cast<unsigned>(t) * R * C
                       + static_cast<unsigned>(r0) * C) & 3;
      const float* w = ring + slot_i * slot + mis + warp * kRowsPerWarp * C;
      float acc[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.f;
      mbar_wait(&full[slot_i], phase);
      if (r0 + warp * kRowsPerWarp < R) {     // warp-uniform
#pragma unroll 4
        for (int c = cl; c < C; c += CL) {
          const float x = vs[kk * cp + c];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            acc[i] = fmaf(w[i * C + c], x, acc[i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot_i]);  // this warp is done
      if (++slot_i == stages) {
        slot_i = 0;
        phase ^= 1;
      }
      int first;
      const int n = reduce_rows<CL>(acc, lane, first);
      if (writer && o_ok) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = r0 + warp * kRowsPerWarp + first + i;
          if (i < n && r < R) {
            const float val = quantize(acc[i], adc_bits, adc_step, fs);
            float* dst = as + (o + r) * KB + kk;
            *dst = init ? val : *dst + val;
          }
        }
      }
    }
    consumer_sync();
  }

  for (int idx = threadIdx.x; idx < S * KB; idx += kConsumers) {
    const int r = idx / KB, kk_ = idx % KB, k = k0 + kk_;
    if (k < K) arena_i[(size_t)r * K + k] = as[idx];
  }
}

// ---------------------------------------------------------------------------
// global instance: the arena in device memory (a slice too large for
// shared memory), one warp per output row reading ops from device memory
// ---------------------------------------------------------------------------

constexpr int kGlobalThreads = 256;

template <int KB>
__global__ void __launch_bounds__(kGlobalThreads) arena_global_kernel(
    float* __restrict__ arena, const float* __restrict__ ops,
    const int* __restrict__ in_offs, const float* __restrict__ in_signs,
    const int* __restrict__ out_offs, const int* __restrict__ out_init,
    int S, int K, int T, int R, int C, int J, int dac_bits, float dac_step,
    int adc_bits, float adc_step, float fs) {
  extern __shared__ float gvs[];  // gvs[kk * (C + 1) + c]
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
      gvs[kk * cp + c] = quantize(acc, dac_bits, dac_step, fs);
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
        for (int kk = 0; kk < KB; ++kk) acc[kk] = fmaf(wv, gvs[kk * cp + c],
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  float* arena;
  const float* ops;
  const int* in_offs;
  const float* in_signs;
  const int* out_offs;
  const int* out_init;
  int M, S, K, T, R, C, J, stages, dac_bits;
  float dac_step;
  int adc_bits;
  float adc_step, fs;
  cudaStream_t stream;
};

template <int KB>
cudaError_t launch_smem(const Args& a) {
  const size_t smem = smem_bytes(a.S, a.T, a.J, a.C, KB, a.stages);
  cudaError_t err = cudaFuncSetAttribute(
      arena_smem_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.M, (a.K + KB - 1) / KB);
  arena_smem_kernel<KB><<<grid, kSmemThreads, smem, a.stream>>>(
      a.arena, a.ops, a.in_offs, a.in_signs, a.out_offs, a.out_init, a.S,
      a.K, a.T, a.R, a.C, a.J, a.stages, a.dac_bits, a.dac_step, a.adc_bits,
      a.adc_step, a.fs);
  return cudaGetLastError();
}

template <int KB>
cudaError_t launch_global(const Args& a) {
  const size_t smem = (size_t)KB * (a.C + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        arena_global_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.M, (a.K + KB - 1) / KB);
  arena_global_kernel<KB><<<grid, kGlobalThreads, smem, a.stream>>>(
      a.arena, a.ops, a.in_offs, a.in_signs, a.out_offs, a.out_init, a.S,
      a.K, a.T, a.R, a.C, a.J, a.dac_bits, a.dac_step, a.adc_bits,
      a.adc_step, a.fs);
  return cudaGetLastError();
}

template <int KB>
cudaError_t launch(const Args& a) {
  return a.stages > 0 ? launch_smem<KB>(a) : launch_global<KB>(a);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: arena (M,S,K) f32 updated in place, ops (M,T,R,C) f32,
// in_offs/in_signs (T,J) i32/f32, out_offs/out_init (T,) i32.  `kb` is the
// column slice per block, a power of two up to 32; `stages` > 0 runs the
// smem instance with a ring of that many slots (its shared memory is
// arena_smem_bytes), 0 the global instance.  Returns the launch's
// cudaError_t (0 on success); nothing is synchronised.
extern "C" int arena_packed_apply_f32(
    void* arena, const void* ops, const void* in_offs, const void* in_signs,
    const void* out_offs, const void* out_init, int M, int S, int K, int T,
    int R, int C, int J, int kb, int stages, int dac_bits, float dac_step,
    int adc_bits, float adc_step, float fs, void* stream) {
  if (M == 0 || K == 0 || T == 0 || R == 0) return 0;
  const Args a{static_cast<float*>(arena), static_cast<const float*>(ops),
               static_cast<const int*>(in_offs),
               static_cast<const float*>(in_signs),
               static_cast<const int*>(out_offs),
               static_cast<const int*>(out_init), M, S, K, T, R, C, J,
               stages, dac_bits, dac_step, adc_bits, adc_step, fs,
               static_cast<cudaStream_t>(stream)};
  switch (kb) {
    case 1: return (int)launch<1>(a);
    case 2: return (int)launch<2>(a);
    case 4: return (int)launch<4>(a);
    case 8: return (int)launch<8>(a);
    case 16: return (int)launch<16>(a);
    case 32: return (int)launch<32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of the smem instance, in bytes.
extern "C" long long arena_smem_bytes(int S, int T, int J, int C, int kb,
                                      int stages) {
  return (long long)smem_bytes(S, T, J, C, kb, stages);
}

extern "C" const char* arena_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
