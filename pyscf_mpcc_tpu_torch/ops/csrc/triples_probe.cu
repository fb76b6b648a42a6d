// The (T) design probes, for Hopper (sm_90a): four small kernels that
// measure what the resident (T) kernel leans on.
//
// Replaces the TPU kernels of tools/triples_probe_v6.py, each computing
// what its Pallas kernel measures rather than what the TPU needed:
//
//   dispatch  (p1_dispatch, :53)  an empty kernel; block 0 writes
//             out[0] = x[0].  Bound: the launch itself (no bytes, no
//             operations).  Launched on grids of T and T x T blocks.
//   smem      (p2_vmem, :79)      copies row 0 of x into dynamic shared
//             memory and returns scr[0].  The TPU bisected its VMEM
//             scratch; here the caller bisects the dynamic shared-memory
//             bytes a block may launch with, and a refused size comes back
//             as the CUDA error of cudaFuncSetAttribute or of the launch
//             (cleared before returning).
//   dots      (p3_dots, :123)     the resident design's dot shapes in the
//             kernel: C = a . b, (M x K) . (K x N), recomputed reps times;
//             the first 128 columns of every repeat are summed into out
//             (M x 128) and every element of every repeat into a per-block
//             fp64 checksum, so the whole product is checked, not only what
//             the TPU kernel returned.  Bound: operations, 2 M K N reps
//             (85.4 GFLOP at shape A): 1.27 ms on the fp32 cores, 0.086 ms
//             at the bf16 tensor-core peak, three times that for split.
//             Design: 128 x 128 output tile per block of 256 threads; the
//             k-loop stages 128 x 32 tiles of a and 32 x 128 tiles of b in
//             fp32 through shared memory with cp.async, double buffered,
//             the ragged last k-step zero-filled by the copy itself; the
//             repeats are a loop around the k-loop, so every repeat
//             streams a and b again from L2, as a resident cell streams
//             its t2 slices.  Modes: f32 (FFMA, 8 x 8 outputs a thread),
//             bf16 and split (mma.sync m16n8k16, operands rounded to bf16
//             while their fragments are loaded, mma_bf16.cuh).
//   stream    (p4_stream, :154)   reads every byte of t2 and ov once (62.5
//             MB at the probe's shapes) with 16-byte loads in a
//             grid-stride loop, four loads in flight a thread, and writes
//             fp64 per-block partial sums; one extra block computes the
//             TPU probe's value, sum(t2 row 0) + sum(ov row 0).  Bound:
//             bytes, 62.5 MB at 3.35 TB/s = 18.7 us.  The TPU kernel's
//             body read one row because its BlockSpec DMA fetched the rest;
//             here the kernel must read it all itself.
//
// Every C entry returns cudaGetLastError() after its launch; the wrappers
// in pyscf_mpcc_tpu_torch/tools/triples_probe_v6.py raise unless it is 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "triples_epilogue.cuh"   // triples::block_sum

namespace {

using triples::block_sum;

// ---------------------------------------------------------------------------
// p1
// ---------------------------------------------------------------------------
__global__ void dispatch_kernel(const float* x, float* out) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) out[0] = x[0];
}

// ---------------------------------------------------------------------------
// p2
// ---------------------------------------------------------------------------
constexpr int kSmemThreads = 256;

__global__ void smem_kernel(const float* x, int n, float* out) {
  extern __shared__ float scr[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) scr[i] = x[i];
  __syncthreads();
  if (threadIdx.x == 0) out[0] = scr[0];
}

// ---------------------------------------------------------------------------
// p3
// ---------------------------------------------------------------------------
enum Mode { kF32 = 0, kSplit = 1, kBf16 = 2 };

constexpr int kDotThreads = 256;
constexpr int kBM = 128;            // output rows a block
constexpr int kBN = 128;            // output columns a block
constexpr int kBK = 32;             // k depth of one staged chunk
constexpr int kSA = kBK + 8;        // row stride of staged a (floats)
constexpr int kSB = kBN + 4;        // row stride of staged b (floats)
constexpr int kOutCols = 128;       // columns of out (the TPU's w[:, :128])
constexpr int kStageFloats = kBM * kSA + kBK * kSB;
constexpr int kDotSmem = 2 * kStageFloats * 4;   // bytes, two stages

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;     // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// stage the chunk at k0: a rows m0.., b columns n0.., k beyond K zeroed
__device__ __forceinline__ void load_chunk(float* st, const float* a,
                                           const float* b, int K, int N,
                                           int m0, int n0, int k0) {
  float* sA = st;
  float* sB = st + kBM * kSA;
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kBM * kBK / 4 / kDotThreads; ++u) {
    const int c = tid + u * kDotThreads;
    const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
    const bool ok = k0 + kc < K;
    cp_async16(sA + r * kSA + kc,
               ok ? a + (long long)(m0 + r) * K + k0 + kc : a, ok);
  }
#pragma unroll
  for (int u = 0; u < kBK * kBN / 4 / kDotThreads; ++u) {
    const int c = tid + u * kDotThreads;
    const int kr = c / (kBN / 4), nc = (c % (kBN / 4)) * 4;
    const bool ok = k0 + kr < K;
    cp_async16(sB + kr * kSB + nc,
               ok ? b + (long long)(k0 + kr) * N + n0 + nc : b, ok);
  }
}

// mode f32: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and
// columns 4 tx + c, 64 + 4 tx + c; acc[8 i + j]
__device__ __forceinline__ void chunk_ffma(const float* st, float* acc) {
  const float* sA = st;
  const float* sB = st + kBM * kSA;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a4[i] = *reinterpret_cast<const float4*>(sA + (ty + 16 * i) * kSA + kq);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(sB + (kq + c) * kSB + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sB + (kq + c) * kSB + 64 + 4 * tx);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = c == 0 ? a4[i].x : c == 1 ? a4[i].y
                       : c == 2 ? a4[i].z : a4[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[8 * i + j] += av * bv[j];
      }
    }
  }
}

// modes bf16 and split: warp w owns rows 64 (w / 4).. and columns
// 32 (w % 4)..: 4 x 4 tiles of 16 x 8; acc[4 (4 mt + nt) + e].  The
// fragments are read from the fp32 staging and rounded to bf16 here.
template <bool kSplitMode>
__device__ __forceinline__ void chunk_mma(const float* st, float* acc) {
  const float* sA = st;
  const float* sB = st + kBM * kSA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* col = sB + wn + 8 * nt + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks + 2 * t + 8 * h;
        mma::split2(col[k * kSB], col[(k + 1) * kSB], bh[nt][h], bl[nt][h]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm + 16 * mt + g + 8 * (q & 1);
        const int k = ks + 2 * t + 8 * (q >> 1);
        const float2 v = *reinterpret_cast<const float2*>(sA + r * kSA + k);
        mma::split2(v.x, v.y, ah[q], al[q]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* c = acc + 4 * (4 * mt + nt);
        mma::mma_bf16(c, ah, bh[nt]);
        if (kSplitMode) {
          mma::mma_bf16(c, ah, bl[nt]);
          mma::mma_bf16(c, al, bh[nt]);
        }
      }
    }
  }
}

// block-local (row, column) of acc[idx]
template <int kMode>
__device__ __forceinline__ void acc_coord(int idx, int& r, int& c) {
  if (kMode == kF32) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int i = idx >> 3, j = idx & 7;
    r = ty + 16 * i;
    c = (j < 4) ? 4 * tx + j : 64 + 4 * tx + (j - 4);
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int tile = idx >> 2, e = idx & 3, mt = tile >> 2, nt = tile & 3;
    r = (warp >> 2) * 64 + 16 * mt + g + 8 * (e >> 1);
    c = (warp & 3) * 32 + 8 * nt + 2 * t + (e & 1);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kDotThreads)
dots_kernel(const float* a, const float* b, int M, int K, int N, int reps,
            float* out, double* checksum) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  float acc[64];
  double csum = 0.0;
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    load_chunk(smem, a, b, K, N, m0, n0, 0);
    cp_async_commit();
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load_chunk(smem + ((kt + 1) & 1) * kStageFloats, a, b, K, N, m0, n0,
                   (kt + 1) * kBK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* st = smem + (kt & 1) * kStageFloats;
      if (kMode == kF32)
        chunk_ffma(st, acc);
      else
        chunk_mma<kMode == kSplit>(st, acc);
      __syncthreads();          // the stage is free for the next load
    }
    // every element into the checksum; the first 128 columns into out
    // (one block owns each out element, and one thread owns it over reps)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      csum += (double)acc[i];
      int r, c;
      acc_coord<kMode>(i, r, c);
      if (n0 + c < kOutCols) {
        float* o = out + (long long)(m0 + r) * kOutCols + n0 + c;
        *o = (rep == 0 ? 0.f : *o) + acc[i];
      }
    }
  }
  const double s = block_sum(csum);
  if (threadIdx.x == 0) checksum[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

template <int kMode>
int launch_dots(const float* a, const float* b, int M, int K, int N, int reps,
                float* out, double* checksum, cudaStream_t stream) {
  auto kern = dots_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kDotSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(N / kBN, M / kBM), kDotThreads, kDotSmem, stream>>>(
      a, b, M, K, N, reps, out, checksum);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// p4
// ---------------------------------------------------------------------------
constexpr int kStreamThreads = 512;

__device__ __forceinline__ double sum4(const float4 v) {
  return ((double)v.x + (double)v.y) + ((double)v.z + (double)v.w);
}

__device__ __forceinline__ double stream_sum(const float4* __restrict__ p,
                                             long long n4, long long i,
                                             long long stride) {
  double s = 0.0;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 v0 = __ldg(p + i), v1 = __ldg(p + i + stride);
    const float4 v2 = __ldg(p + i + 2 * stride);
    const float4 v3 = __ldg(p + i + 3 * stride);
    s += (sum4(v0) + sum4(v1)) + (sum4(v2) + sum4(v3));
  }
  for (; i < n4; i += stride) s += sum4(__ldg(p + i));
  return s;
}

// blocks 0 .. gridDim.x - 2 stream t2 and ov; the last block sums row 0
// of each (fp64 per row, each rounded to fp32, added in fp32)
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const float4* t2, long long n_t2, const float4* ov,
              long long n_ov, int row_t2, int row_ov, double* partial,
              float* value) {
  const int nb = gridDim.x - 1;
  if ((int)blockIdx.x == nb) {
    const float* t = reinterpret_cast<const float*>(t2);
    const float* v = reinterpret_cast<const float*>(ov);
    double st = 0.0, sv = 0.0;
    for (int i = threadIdx.x; i < row_t2; i += blockDim.x) st += t[i];
    for (int i = threadIdx.x; i < row_ov; i += blockDim.x) sv += v[i];
    st = block_sum(st);
    __syncthreads();            // block_sum's shared scratch is reused
    sv = block_sum(sv);
    if (threadIdx.x == 0) value[0] = (float)st + (float)sv;
    return;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)nb * blockDim.x;
  const double s = stream_sum(t2, n_t2 / 4, i, stride)
                   + stream_sum(ov, n_ov / 4, i, stride);
  const double tot = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = tot;
}

}  // namespace

extern "C" {

int probe_dispatch(const void* x, void* out, int gx, int gy, void* stream) {
  dispatch_kernel<<<dim3(gx, gy), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// launch the smem kernel with `bytes` of dynamic shared memory; a size the
// card refuses returns its CUDA error, cleared
int probe_smem(const void* x, int n, int bytes, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  smem_kernel<<<1, kSmemThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// blocks of the smem kernel an SM holds at `bytes` of dynamic shared memory
int probe_smem_occupancy(int bytes, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, smem_kernel, kSmemThreads, bytes);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device
int probe_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

int probe_dots_tile() { return kBM; }   // kBM == kBN

// out (M, 128) fp32, checksum (M / 128, N / 128) fp64; M and N multiples
// of 128, K of 4 (16-byte rows)
int probe_dots(int mode, const void* a, const void* b, int M, int K, int N,
               int reps, void* out, void* checksum, void* stream) {
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  double* pc = static_cast<double*>(checksum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kF32) return launch_dots<kF32>(pa, pb, M, K, N, reps, po, pc, s);
  if (mode == kSplit)
    return launch_dots<kSplit>(pa, pb, M, K, N, reps, po, pc, s);
  if (mode == kBf16)
    return launch_dots<kBf16>(pa, pb, M, K, N, reps, po, pc, s);
  return (int)cudaErrorInvalidValue;
}

// partial (nblocks,) fp64, value (1,) fp32; n_t2 and n_ov multiples of 4
int probe_stream(const void* t2, long long n_t2, const void* ov,
                 long long n_ov, int row_t2, int row_ov, int nblocks,
                 void* partial, void* value, void* stream) {
  stream_kernel<<<nblocks + 1, kStreamThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(t2), n_t2, static_cast<const float4*>(ov),
      n_ov, row_t2, row_ov, static_cast<double*>(partial),
      static_cast<float*>(value));
  return (int)cudaGetLastError();
}

}  // extern "C"
