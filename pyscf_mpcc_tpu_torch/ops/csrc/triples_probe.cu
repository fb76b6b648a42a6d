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
//             In every mode the repeats are a loop around the k-loop, so
//             every repeat streams a and b again from L2, as a resident
//             cell streams its t2 slices; where the output tiles are fewer
//             than the blocks the card holds, the repeats are split over
//             groups of blocks, each writing its own partial out and
//             checksums, which the wrapper sums (no atomics).
//             bf16 and split: the wrapper splits a and b into bf16 once a
//             call and tiles them in stage order (the resident kernel's
//             ov_operand and t2_operand), so the loop only copies and
//             multiplies, as the resident kernel's W1 loop does.  A block
//             of 128 x 256 outputs: one producer warp issues a stage's
//             bulk copies (bulk_copy.cuh) into a ring of six 24 KB stages
//             counted by mbarriers; two consumer warpgroups, a 64 x 256
//             accumulator each, run wgmma m64n256k16 (wgmma_bf16.cuh) and
//             release each stage on its empty barrier.  Every block
//             streams (128 + 256) K bf16 rows a repeat from L2 (1.06 GB
//             at shape A in bf16, twice that in split); the kernel's
//             copy-only form streams that at 9-15 TB/s on an H100 80GB
//             HBM3 at 700 W, so the MMA side sets the pace (PERF.md §6).
//             f32: FFMA, 128 x 128 outputs a block of 256 threads, two
//             blocks an SM; a is transposed once a call, so a stage holds
//             16 rows of a^T and of b (cp.async, three stages, the ragged
//             last rows zero-filled by the copy) and both fragments of a
//             thread's 8 x 8 outputs are 16-byte loads, those of step
//             k + 1 loaded while step k multiplies.
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

#include "triples_epilogue.cuh"   // triples::block_sum
#include "wgmma_bf16.cuh"

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

constexpr int kOutCols = 128;       // columns of out (the TPU's w[:, :128])
constexpr int kCsTile = 128;        // edge of a checksum tile

// Block b of a grid of ntile * nsplit blocks takes output tile b % ntile
// (tm = tile % mt along M, tn = tile / mt along N) and repeat group
// g = b / ntile, the repeats [g reps / nsplit, (g + 1) reps / nsplit).
struct Work {
  int tm, tn, g, r0, r1;
};

__device__ __forceinline__ Work work_of(int mt, int ntile, int nsplit,
                                        int reps) {
  Work w;
  const int tile = (int)blockIdx.x % ntile;
  w.g = (int)blockIdx.x / ntile;
  w.tm = tile % mt;
  w.tn = tile / mt;
  w.r0 = (int)((long long)w.g * reps / nsplit);
  w.r1 = (int)((long long)(w.g + 1) * reps / nsplit);
  return w;
}

// ---- mode f32: FFMA ---------------------------------------------------------
constexpr int kFfmaThreads = 256;
constexpr int kFfmaTile = 128;      // output rows and columns of a block
constexpr int kFfmaBK = 16;         // k depth of a stage
constexpr int kFfmaStages = 3;
// a stage: A^T [BK][128] (k-major rows of a^T), then B [BK][128]
constexpr int kFfmaStageFloats = 2 * kFfmaBK * kFfmaTile;
constexpr int kFfmaSmem = kFfmaStages * kFfmaStageFloats * 4;   // bytes

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

// stage the rows k0 .. k0 + BK of aT (K x M, columns m0..) and of b (K x N,
// columns n0..); rows at K or beyond are zero-filled by the copy itself
__device__ __forceinline__ void ffma_stage(float* st, const float* aT,
                                           const float* b, int K, int M,
                                           int N, int m0, int n0, int k0) {
  constexpr int kPieces = kFfmaTile / 4;        // 16-byte pieces of a row
  constexpr int kHalf = kFfmaBK * kPieces;      // pieces of one operand
#pragma unroll
  for (int u = 0; u < 2 * kHalf / kFfmaThreads; ++u) {
    const int e = threadIdx.x + u * kFfmaThreads;
    const bool isb = e >= kHalf;
    const int p = isb ? e - kHalf : e;
    const int r = p / kPieces, c = (p % kPieces) * 4, k = k0 + r;
    const bool ok = k < K;
    const float* src = isb ? b + (long long)k * N + n0 + c
                           : aT + (long long)k * M + m0 + c;
    cp_async16(st + (isb ? kFfmaBK * kFfmaTile : 0) + r * kFfmaTile + c,
               ok ? src : aT, ok);
  }
}

// thread (ty, tx) of a 16 x 16 grid owns rows 4 ty + i and 64 + 4 ty + i,
// columns 4 tx + j and 64 + 4 tx + j (i, j < 4): acc[i][j], i and j >= 4
// being the second halves.  A fragment is four 16-byte shared loads.
struct Frag {
  float4 a0, a1, b0, b1;
};

__device__ __forceinline__ void ffma_frag(Frag& f, const float* st, int kk,
                                          int ty, int tx) {
  const float* sa = st + kk * kFfmaTile;
  const float* sb = st + (kFfmaBK + kk) * kFfmaTile;
  f.a0 = *reinterpret_cast<const float4*>(sa + 4 * ty);
  f.a1 = *reinterpret_cast<const float4*>(sa + 64 + 4 * ty);
  f.b0 = *reinterpret_cast<const float4*>(sb + 4 * tx);
  f.b1 = *reinterpret_cast<const float4*>(sb + 64 + 4 * tx);
}

__device__ __forceinline__ void ffma_step(float (&acc)[8][8], const Frag& f) {
  const float a[8] = {f.a0.x, f.a0.y, f.a0.z, f.a0.w,
                      f.a1.x, f.a1.y, f.a1.z, f.a1.w};
  const float b[8] = {f.b0.x, f.b0.y, f.b0.z, f.b0.w,
                      f.b1.x, f.b1.y, f.b1.z, f.b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// the staged chunk into acc; the fragments of step kk + 1 are loaded
// while step kk multiplies
__device__ __forceinline__ void ffma_chunk(float (&acc)[8][8], const float* st,
                                           int ty, int tx) {
  Frag f[2];
  ffma_frag(f[0], st, 0, ty, tx);
#pragma unroll
  for (int kk = 0; kk < kFfmaBK; ++kk) {
    if (kk + 1 < kFfmaBK) ffma_frag(f[(kk + 1) & 1], st, kk + 1, ty, tx);
    ffma_step(acc, f[kk & 1]);
  }
}

// aT (K x M) and b (K x N) fp32; block tile 128 x 128, two blocks an SM
__global__ void __launch_bounds__(kFfmaThreads, 2)
dots_ffma_kernel(const float* aT, const float* b, int M, int K, int N,
                 int reps, int nsplit, float* outp, double* csp) {
  extern __shared__ __align__(16) float smem[];
  const int mt = M / kFfmaTile, nct = N / kCsTile;
  const Work w = work_of(mt, mt * nct, nsplit, reps);
  const int m0 = w.tm * kFfmaTile, n0 = w.tn * kFfmaTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nk = (K + kFfmaBK - 1) / kFfmaBK;
  const int total = (w.r1 - w.r0) * nk;       // stages over the group
  float* out = outp + (long long)w.g * M * kOutCols;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  double csum = 0.0;
  // the ring runs on across repeats: stage it holds chunk it % nk
#pragma unroll
  for (int s = 0; s < kFfmaStages - 1; ++s) {
    if (s < total)
      ffma_stage(smem + s * kFfmaStageFloats, aT, b, K, M, N, m0, n0,
                 (s % nk) * kFfmaBK);
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kFfmaStages - 2>();
    __syncthreads();        // chunk it landed; chunk it - 1 is consumed
    const int nx = it + kFfmaStages - 1;
    if (nx < total)
      ffma_stage(smem + (nx % kFfmaStages) * kFfmaStageFloats, aT, b, K, M,
                 N, m0, n0, (nx % nk) * kFfmaBK);
    cp_async_commit();
    ffma_chunk(acc, smem + (it % kFfmaStages) * kFfmaStageFloats, ty, tx);
    if (it % nk != nk - 1) continue;
    // a repeat ends: every element into the checksum, the block's
    // columns into out where they are its first 128 (the same thread owns
    // an out element over the repeats of its group)
    const bool first = it < nk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) csum += (double)acc[i][j];
      if (w.tn == 0) {
        const int r = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
        float4* p = reinterpret_cast<float4*>(out + (long long)r * kOutCols);
        float4 v0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        float4 v1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        if (!first) {
          const float4 o0 = p[tx], o1 = p[16 + tx];
          v0.x += o0.x; v0.y += o0.y; v0.z += o0.z; v0.w += o0.w;
          v1.x += o1.x; v1.y += o1.y; v1.z += o1.z; v1.w += o1.w;
        }
        p[tx] = v0;
        p[16 + tx] = v1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }
  const double s = block_sum(csum);
  if (threadIdx.x == 0)
    csp[((long long)w.g * mt + w.tm) * nct + w.tn] = s;
}

// ---- modes split and bf16: wgmma fed by bulk copies -------------------------
constexpr int kMmaBM = 128;         // output rows of a block
constexpr int kMmaBN = 256;         // output columns of a block
constexpr int kConsumers = 2;       // warpgroup wr: rows 64 wr.., all columns
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kMmaThreads = 32 * (kProducerWarp + 1);   // 288
constexpr int kMmaStages = 6;

// A stage of one k-chunk, [A hi][A lo][B hi][B lo] (lo parts in mode split
// only): A (128 rows x KC) K-major, B (KC x 256) MN-major, both tiles of
// core matrices (wgmma_bf16.cuh) adjacent along k at 128 bytes (LBO),
// along m or n at SBO.  The wrapper lays the operands out in this order
// (ov_operand, t2_operand), so a stage is one bulk copy per part.
template <bool kSplitMode>
struct DotTile {
  static constexpr int KC = kSplitMode ? 16 : 32;   // k depth of a stage
  static constexpr int H = kSplitMode ? 2 : 1;      // parts: hi (, lo)
  static constexpr int SBO = KC / 8 * 128;
  static constexpr int A_HALF = kMmaBM * KC * 2;    // bytes
  static constexpr int B_HALF = kMmaBN * KC * 2;
  static constexpr int STAGE = H * (A_HALF + B_HALF);
};
constexpr int kMmaStageBytes = DotTile<true>::STAGE;         // 24 KB
static_assert(DotTile<false>::STAGE == kMmaStageBytes, "stage size");
constexpr int kMmaSmem = kMmaStages * kMmaStageBytes;

struct MmaOps {
  const unsigned char* a[2];   // tiled a, hi and lo
  const unsigned char* b[2];   // tiled b, hi and lo
};

// warpgroup wr's 64 x 256 product of the staged chunk, added to acc
template <bool kSplitMode>
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          float (&acc)[128], int wr) {
  using Tl = DotTile<kSplitMode>;
  const uint32_t a0 = wgmma::smem_u32(st) + wr * 8 * Tl::SBO;
  const uint32_t b0 = wgmma::smem_u32(st) + Tl::H * Tl::A_HALF;
#pragma unroll
  for (int s = 0; s < Tl::KC / 16; ++s) {     // k16 steps: 2 core matrices
    const uint64_t ah = wgmma::desc(a0 + 256 * s, 128, Tl::SBO);
    const uint64_t bh = wgmma::desc(b0 + 256 * s, 128, Tl::SBO);
    wgmma::mma_m64n256k16(acc, ah, bh);
    if (kSplitMode) {
      const uint64_t al = wgmma::desc(a0 + Tl::A_HALF + 256 * s, 128, Tl::SBO);
      const uint64_t bl = wgmma::desc(b0 + Tl::B_HALF + 256 * s, 128, Tl::SBO);
      wgmma::mma_m64n256k16(acc, ah, bl);
      wgmma::mma_m64n256k16(acc, al, bh);
    }
  }
}

// Tiled operands (Kp = K padded to KC): a (Kp/KC, M/8, KC/8, 8, 8), b
// (Kp/KC, N/8, KC/8, 8, 8).  One producer warp (its lane 0) issues the
// bulk copies of each stage into a ring of kMmaStages, counted by the
// stage's full barrier; the 8 consumer warps wait on it, multiply, and
// release the stage on its empty barrier.  A last block of an N that is an
// odd multiple of 128 copies 128 columns of B: its product's columns
// 128.. are never read.  kFeed: the consumers only wait and release (the
// copy rate alone; out and the checksums are not computed).
template <bool kSplitMode, bool kFeed>
__global__ void __launch_bounds__(kMmaThreads, 1)
dots_mma_kernel(const MmaOps op, int M, int Kp, int N, int reps, int nsplit,
                float* outp, double* csp) {
  using Tl = DotTile<kSplitMode>;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMmaStages], empty[kMmaStages];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = M / kMmaBM, nct = N / kCsTile;
  const Work w = work_of(mt, mt * ((N + kMmaBN - 1) / kMmaBN), nsplit, reps);
  const int m0 = w.tm * kMmaBM, n0 = w.tn * kMmaBN;
  const int nk = Kp / Tl::KC;
  const int total = (w.r1 - w.r0) * nk;       // stages over the group
  if (tid == 0) {
    for (int s = 0; s < kMmaStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], 4 * kConsumers);
    }
    wgmma::mbar_init_fence();
  }
  __syncthreads();
  // the checksums of the block's two 128-column tiles
  double cs0 = 0.0, cs1 = 0.0;
  if (warp == kProducerWarp) {
    if (lane == 0) {
      const uint32_t bbytes = min(kMmaBN, N - n0) * Tl::KC * 2;
#pragma unroll 1
      for (int it = 0; it < total; ++it) {
        const int s = it % kMmaStages, c = it % nk;
        wgmma::mbar_wait(&empty[s], ((it / kMmaStages) & 1) ^ 1);
        unsigned char* st = ring + s * kMmaStageBytes;
        const long long aoff = ((long long)c * M + m0) * Tl::KC * 2;
        const long long boff = ((long long)c * N + n0) * Tl::KC * 2;
        wgmma::mbar_expect_tx(&full[s], Tl::H * (Tl::A_HALF + bbytes));
#pragma unroll
        for (int h = 0; h < Tl::H; ++h) {
          wgmma::bulk_copy(st + h * Tl::A_HALF, op.a[h] + aoff, Tl::A_HALF,
                           &full[s]);
          wgmma::bulk_copy(st + Tl::H * Tl::A_HALF + h * Tl::B_HALF,
                           op.b[h] + boff, bbytes, &full[s]);
        }
      }
    }
    __syncwarp();
  } else {
    const int wr = warp >> 2, wq = warp & 3;
    const int g8 = lane >> 2, q = lane & 3;
    float* out = outp + (long long)w.g * M * kOutCols;
    float acc[128];
    int it = 0;
#pragma unroll 1
    for (int rep = w.r0; rep < w.r1; ++rep) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int c = 0; c < nk; ++c, ++it) {
        const int s = it % kMmaStages;
        wgmma::mbar_wait(&full[s], (it / kMmaStages) & 1);
        __syncwarp();
        if (!kFeed) {
          wgmma::fence_operands(acc);
          wgmma::fence();
          mma_stage<kSplitMode>(ring + s * kMmaStageBytes, acc, wr);
          wgmma::commit();
          wgmma::wait<0>();
          wgmma::fence_operands(acc);
        }
        __syncwarp();
        if (lane == 0) wgmma::mbar_arrive(&empty[s]);
      }
      // a repeat ends: acc[4 j + 2 h + e] is C[16 wq + g8 + 8 h][8 j + 2 q
      // + e] of the warpgroup's 64 x 256 tile, columns 0..127 for j < 16
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        cs0 += (double)acc[i];
        cs1 += (double)acc[64 + i];
      }
      if (!kFeed && w.tn == 0) {     // out: the block's columns 0..127
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + 64 * wr + 16 * wq + g8 + 8 * h;
          float2* p = reinterpret_cast<float2*>(out + (long long)r * kOutCols);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            if (rep > w.r0) {
              const float2 o = p[4 * j + q];
              v.x += o.x;
              v.y += o.y;
            }
            p[4 * j + q] = v;
          }
        }
      }
    }
  }
  const double s0 = block_sum(cs0);
  __syncthreads();            // block_sum's shared scratch is reused
  const double s1 = block_sum(cs1);
  if (tid == 0) {
    double* cs = csp + ((long long)w.g * mt + w.tm) * nct + 2 * w.tn;
    cs[0] = s0;
    if (2 * w.tn + 1 < nct) cs[1] = s1;
  }
}

template <bool kSplitMode, bool kFeed>
int launch_mma(const MmaOps& op, int M, int Kp, int N, int reps, int nsplit,
               float* outp, double* csp, cudaStream_t stream) {
  auto kern = dots_mma_kernel<kSplitMode, kFeed>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const int ntile = (M / kMmaBM) * ((N + kMmaBN - 1) / kMmaBN);
  kern<<<ntile * nsplit, kMmaThreads, kMmaSmem, stream>>>(
      op, M, Kp, N, reps, nsplit, outp, csp);
  return (int)cudaGetLastError();
}

int launch_ffma(const float* aT, const float* b, int M, int K, int N,
                int reps, int nsplit, float* outp, double* csp,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dots_ffma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFfmaSmem);
  if (err != cudaSuccess) return (int)err;
  const int ntile = (M / kFfmaTile) * (N / kFfmaTile);
  dots_ffma_kernel<<<ntile * nsplit, kFfmaThreads, kFfmaSmem, stream>>>(
      aT, b, M, K, N, reps, nsplit, outp, csp);
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

template <bool kSplitMode>
int mma_blocks_per_sm(int* blocks) {
  auto kern = dots_mma_kernel<kSplitMode, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, kMmaThreads, kMmaSmem);
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

// the dots kernel of a mode: geometry[0..3] = its output tile (rows,
// columns), the k depth of a stage (in modes split and bf16 the chunk of
// the tiled operands) and the blocks an SM holds
int probe_dots_geometry(int mode, int* geometry) {
  int blocks = 0;
  int err;
  if (mode == kF32) {
    err = (int)cudaFuncSetAttribute(
        dots_ffma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFfmaSmem);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dots_ffma_kernel, kFfmaThreads, kFfmaSmem);
    geometry[0] = geometry[1] = kFfmaTile;
    geometry[2] = kFfmaBK;
  } else if (mode == kSplit || mode == kBf16) {
    const bool split = mode == kSplit;
    err = split ? mma_blocks_per_sm<true>(&blocks)
                : mma_blocks_per_sm<false>(&blocks);
    geometry[0] = kMmaBM;
    geometry[1] = kMmaBN;
    geometry[2] = split ? DotTile<true>::KC : DotTile<false>::KC;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  geometry[3] = blocks;
  return err;
}

// out_part (nsplit, M, 128) fp32 and cs_part (nsplit, M/128, N/128) fp64,
// one partial per repeat group; M and N multiples of 128, 1 <= nsplit <=
// reps.  Mode f32: a = a^T (K x M) and b (K x N), fp32 (a_lo, b_lo
// unused).  Modes split and bf16: the tiled bf16 parts (a_lo and b_lo in
// split only), K the padded depth, a multiple of the stage's; feed runs
// the copy-only form (out_part and cs_part are not computed).
int probe_dots(int mode, int feed, const void* a, const void* a_lo,
               const void* b, const void* b_lo, int M, int K, int N,
               int reps, int nsplit, void* out_part, void* cs_part,
               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % kCsTile || N % kCsTile
      || nsplit < 1 || nsplit > reps)
    return (int)cudaErrorInvalidValue;
  float* po = static_cast<float*>(out_part);
  double* pc = static_cast<double*>(cs_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kF32) {
    if (feed) return (int)cudaErrorInvalidValue;
    return launch_ffma(static_cast<const float*>(a),
                       static_cast<const float*>(b), M, K, N, reps, nsplit,
                       po, pc, s);
  }
  using Bytes = const unsigned char*;
  const MmaOps op = {{static_cast<Bytes>(a), static_cast<Bytes>(a_lo)},
                     {static_cast<Bytes>(b), static_cast<Bytes>(b_lo)}};
  if (mode == kSplit) {
    if (K % DotTile<true>::KC) return (int)cudaErrorInvalidValue;
    return feed ? launch_mma<true, true>(op, M, K, N, reps, nsplit, po, pc, s)
                : launch_mma<true, false>(op, M, K, N, reps, nsplit, po, pc,
                                          s);
  }
  if (mode == kBf16) {
    if (K % DotTile<false>::KC) return (int)cudaErrorInvalidValue;
    return feed ? launch_mma<false, true>(op, M, K, N, reps, nsplit, po, pc,
                                          s)
                : launch_mma<false, false>(op, M, K, N, reps, nsplit, po, pc,
                                           s);
  }
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
