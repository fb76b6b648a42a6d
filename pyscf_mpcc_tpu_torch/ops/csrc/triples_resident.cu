// CCSD(T) tile energy with the W1 contractions inside the kernel, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pyscf_mpcc_tpu/ops/triples_resident.py:238
// _combine_resident (the Pallas body of tile_energy_resident).  For every
// cell (a, b, c) of a virtual tile triple it computes the same energy as
// triples_combine.cu, but builds the six W1 terms itself,
//
//   w1_p[i',j',k'] = sum_f (i'x|fy) t2[k',j',z,f],   p = (x, y, z),
//
// so W never reaches device memory (the fused engine writes and re-reads
// 6 T^3 o^3 values, 403 MB per tile in fp32 at o = 32, T = 8).
//
// What bounds it on this card: operations.  Per tile the W1 dots are
// 6 T^3 o^3 F multiply-adds (85.4 GFLOP at o = 32, T = 8, F = 424) and the
// w2 dots 6 T^3 o^4 (6.4 GFLOP); the inputs it must read are about 63 MB.
// In mode f32 the dots run on the CUDA cores (FFMA, DFMA for fp64): about
// 1.37 ms at 67 TFLOP/s.  In modes split and bf16 they run on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate): split forms each
// operand's bf16 (hi, lo) pair while staging it and sums hi.hi + hi.lo +
// lo.hi, the function of the JAX package's bf16x3 mode; bf16 takes hi.hi.
//
// Design (simple first): one block per (tile, a, b, c) cell; cells of
// weight zero return at once.  The cell's W (o^3 values, padded) stays in
// shared memory.  The two perms that share a t2 slice, (x,y,z) and
// (y,x,z), run as one GEMM: the two (o x F) ov rows stacked over one
// (F x o^2) slice of t2, read through strides straight from the persistent
// t2 array.  The block computes the (2o x o^2) product in 64 x 256 chunks
// held in registers over a k-loop staged through shared memory (the next
// k-chunk is fetched into registers while the current one is multiplied),
// then adds each chunk into W through the perm's index map, rows of the
// first perm and of the second in two passes so that no element is
// written twice at once.  The w2 dots, V, Z and the energy are the device
// code of triples_combine.cu (triples_epilogue.cuh).  Each block writes one
// partial energy; the host wrapper sums them in fp64.
//
// Trouble known and left for later: every cell re-reads its three t2
// slices (about 5.2 MB at the bench shape, 2.7 GB per tile through L2);
// 512 cells at one block per SM make 3.9 waves; mma.sync and not wgmma,
// no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "triples_epilogue.cuh"

namespace {

using triples::CellPtrs;
using triples::perm_id;
using triples::perm_of;
using triples::slot_stride;

constexpr int kThreads = 512;
constexpr int kBM = 64;       // GEMM rows per pass (two stacked ov blocks)
constexpr int kBN = 256;      // GEMM columns per pass (occupied pairs)
constexpr int kPadA = 4;      // row padding of the staged A (FFMA form)
constexpr int kMmaBK = 32;    // k depth of one staged chunk (MMA form)
constexpr int kSK = kMmaBK + 8;  // bf16 row stride of the MMA staging

enum Mode { kF32 = 0, kSplit = 1, kBf16 = 2 };

template <typename T>
__host__ __device__ constexpr int ffma_bk() {
  return sizeof(T) == 4 ? 16 : 8;
}

// index of the ordered role pair (r1, r2) in PAIRS order
__host__ __device__ __forceinline__ int pair_id(int r1, int r2) {
  return 2 * r1 + (r2 < r1 ? r2 : r2 - 1);
}

// shared-memory bytes of the GEMM staging
__host__ __device__ inline long long gemm_bytes(int mode, int itemsize) {
  if (mode == kF32) {
    const int bk = itemsize == 4 ? 16 : 8;
    return (long long)bk * ((kBM + kPadA) + kBN) * itemsize;
  }
  return 2LL * (kBM + kBN) * kSK * 2;   // hi and lo, bf16
}

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

// dynamic shared memory: padded W, then the GEMM staging, reused for the
// six t2 blocks of the w2 dots
__host__ __device__ inline long long smem_bytes(int o, int itemsize,
                                                int mode) {
  const long long g = gemm_bytes(mode, itemsize);
  const long long t = 6LL * o * o * itemsize;
  return align16(triples::w_elems(o) * itemsize) + (g > t ? g : t);
}

template <typename T>
struct Args {
  const unsigned long long* ptrs;  // (K, 9): addresses of the 3 t2 slices
                                   // (T, F, o*o) [z, f, (j,k)] = t2[k,j,z,f]
                                   // and the 6 ov blocks (T, T, o, F)
                                   // [x, y, i, f] = (ix|fy), PAIRS6 order
  const T* vooo;     // (K,3,T,o*o,o)   [x, (i,j), m] = (ix|jm)
  const T* t2p;      // (K,6,T,T,o,o)   [(r1,r2),x,y,m,n] = t2[n,m,x,y]
  const T* oovv;     // (K,6,T,T,o,o)   [(r1,r2),x,y,i,j] = (ix|jy)
  const T* t1;       // (K,3,T,o)       [r,z,k] = t1[k,z]
  const T* fvo;      // (K,3,T,o)       [r,z,k] = fvo[z,k]
  const T* eijk;     // (o,o,o)
  const T* eabc;     // (K,T,T,T)
  const T* wgt;      // (K,T,T,T) degeneracy weights (0 on padded cells)
  const T* act;      // (K,T,T,T) active-virtual products, or null
  const T* actocc;   // (o,o,o) active-occupied products, or null
  int act_mode;      // 0 none, 1 exclude_active, 2 only_active
  int nt;            // tile edge T
  int o;             // occupied count
  int F;             // contraction length (padded virtuals)
  double* out;       // (K,T,T,T) partial energies
};

// 4 consecutive values from shared memory (16-byte aligned)
__device__ __forceinline__ void lds4(const float* p, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void lds4(const double* p, double* r) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  r[0] = v0.x; r[1] = v0.y; r[2] = v1.x; r[3] = v1.y;
}

// ---------------------------------------------------------------------------
// W1, mode f32: C (2o x o^2) = [A1; A2] (2o x F) . B (F x o^2) on the CUDA
// cores, added into W: rows r < o with perm q1, rows r >= o with perm q2.
// Thread tile 8 x 4: rows {4rg..4rg+3, 32+4rg..}, columns 16w+4cg..+3, so
// each 4-wide shared load of a warp covers one contiguous span.
// ---------------------------------------------------------------------------
template <typename T>
__device__ void w1_pair_ffma(const T* A1, const T* A2, const T* B, T* Wsm,
                             unsigned char* scratch, int o, int F, int q1,
                             int q2) {
  constexpr int BK = ffma_bk<T>();
  constexpr int SA = kBM + kPadA;
  constexpr int NA = kBM * BK / kThreads;   // staged A values per thread
  constexpr int NB = kBN * BK / kThreads;   // staged B values per thread
  T* sA = reinterpret_cast<T*>(scratch);    // [BK][SA]  (k-major)
  T* sB = sA + BK * SA;                     // [BK][kBN]
  const int M = 2 * o, N = o * o;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane & 7, cg = lane >> 3;

  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += kBN) {
      T acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
      T pa[NA], pb[NB];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int u = 0; u < NA; ++u) {
          const int e = tid + u * kThreads, kk = e % BK, r = e / BK;
          const int gr = m0 + r, f = k0 + kk;
          const T* row = gr < o ? A1 + (long long)gr * F
                                : A2 + (long long)(gr - o) * F;
          pa[u] = (gr < M && f < F) ? __ldg(row + f) : T(0);
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int e = tid + u * kThreads, c = e % kBN, kk = e / kBN;
          const int gc = n0 + c, f = k0 + kk;
          pb[u] = (gc < N && f < F) ? __ldg(B + (long long)f * N + gc) : T(0);
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < F; k0 += BK) {
        __syncthreads();            // the previous chunk is consumed
#pragma unroll
        for (int u = 0; u < NA; ++u) {
          const int e = tid + u * kThreads;
          sA[(e % BK) * SA + e / BK] = pa[u];
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int e = tid + u * kThreads;
          sB[(e / kBN) * kBN + e % kBN] = pb[u];
        }
        __syncthreads();
        if (k0 + BK < F) fetch(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          T a[8], b[4];
          lds4(sA + kk * SA + rg * 4, a);
          lds4(sA + kk * SA + 32 + rg * 4, a + 4);
          lds4(sB + kk * kBN + warp * 16 + cg * 4, b);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
        }
      }
#pragma unroll 1
      for (int ph = 0; ph < 2; ++ph) {
        int p0, p1, p2;
        perm_of(ph ? q2 : q1, p0, p1, p2);
        const int si = slot_stride(p0, o), sj = slot_stride(p1, o),
                  sk = slot_stride(p2, o);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ip = m0 + (i >> 2) * 32 + rg * 4 + (i & 3) - ph * o;
          if (ip < 0 || ip >= o) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gc = n0 + warp * 16 + cg * 4 + j;
            if (gc >= N) continue;
            const int jp = gc / o, kp = gc - jp * o;
            Wsm[ip * si + jp * sj + kp * sk] += acc[i][j];
          }
        }
        __syncthreads();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// W1, modes split and bf16: the same product on the tensor cores
// (mma_bf16.cuh).  Staged as bf16 pairs in 32-bit words: A as [row][k], B
// transposed as [column][k]; the 20-word row stride makes the fragment
// loads of a warp hit 32 different banks.  Warp w owns rows
// 32(w/8)..+31 and columns 32(w%8)..+31: 2 x 4 tiles of 16 x 8.
// ---------------------------------------------------------------------------
using mma::mma_bf16;
using mma::split2;

template <bool kSplitMode>
__device__ void w1_pair_mma(const float* A1, const float* A2, const float* B,
                            float* Wsm, unsigned char* scratch, int o, int F,
                            int q1, int q2) {
  constexpr int BK = kMmaBK;
  constexpr int KP = BK / 2;                 // bf16 pairs per staged row
  constexpr int SW = kSK / 2;                // row stride in words
  constexpr int NPA = kBM * KP / kThreads;   // staged A pairs per thread
  constexpr int NPB = kBN * KP / kThreads;   // staged B pairs per thread
  uint32_t* sAh = reinterpret_cast<uint32_t*>(scratch);   // [kBM][SW]
  uint32_t* sAl = sAh + kBM * SW;
  uint32_t* sBh = sAl + kBM * SW;                          // [kBN][SW]
  uint32_t* sBl = sBh + kBN * SW;
  const int M = 2 * o, N = o * o;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 3) * 32, wc = (warp & 7) * 32;

  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += kBN) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      float pa[NPA][2], pb[NPB][2];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int u = 0; u < NPA; ++u) {
          const int e = tid + u * kThreads, kp = e % KP, r = e / KP;
          const int gr = m0 + r, f = k0 + 2 * kp;
          const float* row = gr < o ? A1 + (long long)gr * F
                                    : A2 + (long long)(gr - o) * F;
          pa[u][0] = (gr < M && f < F) ? __ldg(row + f) : 0.f;
          pa[u][1] = (gr < M && f + 1 < F) ? __ldg(row + f + 1) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < NPB; ++u) {
          const int e = tid + u * kThreads, c = e % kBN, kp = e / kBN;
          const int gc = n0 + c, f = k0 + 2 * kp;
          pb[u][0] = (gc < N && f < F) ? __ldg(B + (long long)f * N + gc)
                                       : 0.f;
          pb[u][1] = (gc < N && f + 1 < F)
                         ? __ldg(B + (long long)(f + 1) * N + gc) : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < F; k0 += BK) {
        __syncthreads();            // the previous chunk is consumed
#pragma unroll
        for (int u = 0; u < NPA; ++u) {
          const int e = tid + u * kThreads, kp = e % KP, r = e / KP;
          uint32_t hi, lo;
          split2(pa[u][0], pa[u][1], hi, lo);
          sAh[r * SW + kp] = hi;
          if (kSplitMode) sAl[r * SW + kp] = lo;
        }
#pragma unroll
        for (int u = 0; u < NPB; ++u) {
          const int e = tid + u * kThreads, c = e % kBN, kp = e / kBN;
          uint32_t hi, lo;
          split2(pb[u][0], pb[u][1], hi, lo);
          sBh[c * SW + kp] = hi;
          if (kSplitMode) sBl[c * SW + kp] = lo;
        }
        __syncthreads();
        if (k0 + BK < F) fetch(k0 + BK);
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int n = wc + nt * 8 + g;
            bh[nt][0] = sBh[n * SW + ks * 8 + t];
            bh[nt][1] = sBh[n * SW + ks * 8 + t + 4];
            if (kSplitMode) {
              bl[nt][0] = sBl[n * SW + ks * 8 + t];
              bl[nt][1] = sBl[n * SW + ks * 8 + t + 4];
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int m = wr + mt * 16 + g;
            uint32_t ah[4], al[4];
            ah[0] = sAh[m * SW + ks * 8 + t];
            ah[1] = sAh[(m + 8) * SW + ks * 8 + t];
            ah[2] = sAh[m * SW + ks * 8 + t + 4];
            ah[3] = sAh[(m + 8) * SW + ks * 8 + t + 4];
            if (kSplitMode) {
              al[0] = sAl[m * SW + ks * 8 + t];
              al[1] = sAl[(m + 8) * SW + ks * 8 + t];
              al[2] = sAl[m * SW + ks * 8 + t + 4];
              al[3] = sAl[(m + 8) * SW + ks * 8 + t + 4];
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_bf16(acc[mt][nt], ah, bh[nt]);
              if (kSplitMode) {
                mma_bf16(acc[mt][nt], ah, bl[nt]);
                mma_bf16(acc[mt][nt], al, bh[nt]);
              }
            }
          }
        }
      }
      // accumulator (mt, nt, e): row wr + 16mt + g + 8(e>>1), column
      // wc + 8nt + 2t + (e&1)
#pragma unroll 1
      for (int ph = 0; ph < 2; ++ph) {
        int p0, p1, p2;
        perm_of(ph ? q2 : q1, p0, p1, p2);
        const int si = slot_stride(p0, o), sj = slot_stride(p1, o),
                  sk = slot_stride(p2, o);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ip = m0 + wr + mt * 16 + g + 8 * (e >> 1) - ph * o;
              const int gc = n0 + wc + nt * 8 + 2 * t + (e & 1);
              if (ip < 0 || ip >= o || gc >= N) continue;
              const int jp = gc / o, kp = gc - jp * o;
              Wsm[ip * si + jp * sj + kp * sk] += acc[mt][nt][e];
            }
        __syncthreads();
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
resident_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = a.nt, o = a.o, oo = o * o, F = a.F;
  T* Wsm = reinterpret_cast<T*>(smem_raw);
  unsigned char* scratch = smem_raw + align16(triples::w_elems(o) * sizeof(T));

  const int cell = blockIdx.x;
  const int C = cell % nt;
  const int B = (cell / nt) % nt;
  const int A = (cell / (nt * nt)) % nt;
  const long long k = cell / (nt * nt * nt);
  double* out = a.out + cell;
  const T wgt = a.wgt[cell];
  if (wgt == T(0)) {         // uniform over the block: no barrier skipped
    if (threadIdx.x == 0) *out = 0.0;
    return;
  }
  const T eabc = a.eabc[cell];
  const T af = a.act_mode ? a.act[cell] : T(0);
  const int v[3] = {A, B, C};

  // per-perm inputs of this cell, shared by the block
  __shared__ CellPtrs<T> cp;
  __shared__ const T* ovp[6];
  __shared__ const T* t2z[3];
  if (threadIdx.x < 6) {
    const int q = threadIdx.x;
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const long long x = v[p0], y = v[p1], z = v[p2], Tl = nt;
    const unsigned long long* pk = a.ptrs + k * 9;
    ovp[q] = reinterpret_cast<const T*>(pk[3 + q]) + (x * Tl + y) * o * F;
    cp.vooo[q] = a.vooo + ((k * 3 + p0) * Tl + x) * oo * o;
    cp.t2zy[q] = a.t2p + (((k * 6 + pair_id(p2, p1)) * Tl + z) * Tl + y) * oo;
    cp.oovv[q] = a.oovv + (((k * 6 + pair_id(p0, p1)) * Tl + x) * Tl + y) * oo;
    cp.t2yx[q] = a.t2p + (((k * 6 + pair_id(p1, p0)) * Tl + y) * Tl + x) * oo;
    cp.t1z[q] = a.t1 + ((k * 3 + p2) * Tl + z) * o;
    cp.fvoz[q] = a.fvo + ((k * 3 + p2) * Tl + z) * o;
    if (q < 3)
      t2z[q] = reinterpret_cast<const T*>(pk[q]) + (long long)v[q] * F * oo;
  }
  for (long long e = threadIdx.x; e < triples::w_elems(o); e += blockDim.x)
    Wsm[e] = T(0);
  __syncthreads();

  // W = sum_p P_p w1_p: perms (x,y,z) and (y,x,z) share the t2 slice z
#pragma unroll 1
  for (int z = 0; z < 3; ++z) {
    const int x = z == 0 ? 1 : 0, y = z == 2 ? 1 : 2;
    const int q1 = perm_id(x, y, z), q2 = perm_id(y, x, z);
    if constexpr (kMode == kF32)
      w1_pair_ffma<T>(ovp[q1], ovp[q2], t2z[z], Wsm, scratch, o, F, q1, q2);
    else
      w1_pair_mma<kMode == kSplit>(ovp[q1], ovp[q2], t2z[z], Wsm, scratch,
                                   o, F, q1, q2);
  }
  // (the last scatter pass ended with a barrier: the staging is free)
  T* t2s = reinterpret_cast<T*>(scratch);
  triples::stage_t2zy(cp, t2s, o);
  __syncthreads();
  triples::subtract_w2(cp, t2s, Wsm, o);

  const int S1 = triples::w_s1(o), S0 = triples::w_s0(o);
  auto wval = [&](const int* oc) -> T {
    return Wsm[oc[0] * S0 + oc[1] * S1 + oc[2]];
  };
  const double acc = triples::orbit_energy(cp, a.eijk, a.actocc, a.act_mode,
                                           eabc, af, o, threadIdx.x,
                                           blockDim.x, wval);
  const double t = triples::block_sum(acc);
  if (threadIdx.x == 0) *out = t * (double)wgt;
}

template <typename T, int kMode>
int launch(const Args<T>& a, int K, void* stream) {
  const size_t smem = (size_t)smem_bytes(a.o, sizeof(T), kMode);
  auto kern = resident_kernel<T, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned ncell = (unsigned)(K * a.nt * a.nt * a.nt);
  kern<<<ncell, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(int nt, int o, int F, const void* ptrs, const void* vooo,
                  const void* t2p, const void* oovv, const void* t1,
                  const void* fvo, const void* eijk, const void* eabc,
                  const void* wgt, const void* act, const void* actocc,
                  int act_mode, void* out) {
  Args<T> a;
  a.ptrs = static_cast<const unsigned long long*>(ptrs);
  a.vooo = static_cast<const T*>(vooo);
  a.t2p = static_cast<const T*>(t2p);
  a.oovv = static_cast<const T*>(oovv);
  a.t1 = static_cast<const T*>(t1);
  a.fvo = static_cast<const T*>(fvo);
  a.eijk = static_cast<const T*>(eijk);
  a.eabc = static_cast<const T*>(eabc);
  a.wgt = static_cast<const T*>(wgt);
  a.act = static_cast<const T*>(act);
  a.actocc = static_cast<const T*>(actocc);
  a.act_mode = act_mode;
  a.nt = nt;
  a.o = o;
  a.F = F;
  a.out = static_cast<double*>(out);
  return a;
}

}  // namespace

extern "C" {

int triples_resident_threads() { return kThreads; }

// dynamic shared-memory bytes for nocc = o, an item size of 4 or 8 and a
// mode (0 f32, 1 split, 2 bf16); the caller checks it against the limit
long long triples_resident_smem_bytes(int o, int itemsize, int mode) {
  return smem_bytes(o, itemsize, mode);
}

int triples_resident_f32(int K, int nt, int o, int F, int mode,
                         const void* ptrs, const void* vooo, const void* t2p,
                         const void* oovv, const void* t1, const void* fvo,
                         const void* eijk, const void* eabc, const void* wgt,
                         const void* act, const void* actocc, int act_mode,
                         void* out, void* stream) {
  const Args<float> a = make_args<float>(nt, o, F, ptrs, vooo, t2p, oovv, t1,
                                         fvo, eijk, eabc, wgt, act, actocc,
                                         act_mode, out);
  if (mode == kF32) return launch<float, kF32>(a, K, stream);
  if (mode == kSplit) return launch<float, kSplit>(a, K, stream);
  if (mode == kBf16) return launch<float, kBf16>(a, K, stream);
  return (int)cudaErrorInvalidValue;
}

// fp64 runs mode f32 only (DFMA)
int triples_resident_f64(int K, int nt, int o, int F, int mode,
                         const void* ptrs, const void* vooo, const void* t2p,
                         const void* oovv, const void* t1, const void* fvo,
                         const void* eijk, const void* eabc, const void* wgt,
                         const void* act, const void* actocc, int act_mode,
                         void* out, void* stream) {
  if (mode != kF32) return (int)cudaErrorInvalidValue;
  const Args<double> a = make_args<double>(nt, o, F, ptrs, vooo, t2p, oovv,
                                           t1, fvo, eijk, eabc, wgt, act,
                                           actocc, act_mode, out);
  return launch<double, kF32>(a, K, stream);
}

}  // extern "C"
