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
// cores with wgmma (wgmma_bf16.cuh): split sums hi.hi + hi.lo + lo.hi of
// bf16 (hi, lo) operand pairs, the function of the JAX package's bf16x3
// mode, bf16 takes hi.hi.  The operands arrive split (once per (T) call
// for t2, once per tile for the ov blocks) and tiled in the order of the
// kernel's stages, so the loop only copies and multiplies.  What feeds it
// is the copy rate: a cell streams its three t2 slices (hi + lo, 5.5 MB at
// the bench shape, 2.8 GB per tile); per-thread cp.async moved about 9
// bytes a clock per SM, bulk copies on the TMA engine several times that.
//
// Design: one block of 512 threads per (tile, a, b, c) cell; cells of
// weight zero return at once.  The cell's W (o^3 values, padded) stays in
// shared memory.  The two perms that share a t2 slice, (x,y,z) and
// (y,x,z), run as one GEMM: the two (o x F) ov rows stacked over one
// (F x o^2) slice of t2, read through pointers straight from the
// persistent arrays.  k-chunks pass through a ring of two stages (one
// where W leaves no room for two), filled by bulk copies that one thread
// issues and an mbarrier counts, the next chunk in flight while the
// current one is multiplied.  The product is formed in passes of 64 rows:
//   f32   8 x 8 (fp32) or 8 x 4 (fp64) outputs a thread, 64 x 512 or
//         64 x 256 columns a pass; the rows of B copied in bulk, A
//         transposed through registers;
//   split/bf16  four warpgroups, each a 64 x 128 fp32 accumulator
//         (wgmma m64n128k16, A = ov rows K-major, B = t2 MN-major), 512
//         columns a pass; a stage holds a k-chunk of A and B (16 deep with
//         hi and lo, 32 with hi alone: 36 KB either way).
// Each pass adds its product into W through the perm's index map, rows
// of the first perm and of the second in two passes so that no element
// is written twice at once.  The w2 dots, V, Z and the energy are the
// device code shared with triples_combine.cu (triples_epilogue.cuh): the
// w2 GEMMs on the fp64 tensor cores (mma.sync m16n8k16 with fp32 operands
// widened, m16n8k8 in fp64), their vooo fragments read from L2 (staged by
// the threads where o is not a multiple of 4 vectors) and the t2 block
// staged in the freed ring, which then holds the V-term inputs.  Each
// block writes one partial energy; the host wrapper sums them in fp64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "triples_epilogue.cuh"
#include "wgmma_bf16.cuh"

namespace {

using triples::CellPtrs;
using triples::perm_id;
using triples::perm_of;
using triples::slot_stride;

constexpr int kThreads = triples::kEpiThreads;   // 512
constexpr int kBM = 64;       // GEMM rows per pass (two stacked ov blocks)
constexpr int kPadA = 4;      // row padding of the staged A (FFMA form)
constexpr int kWgN = 128;     // GEMM columns of one warpgroup (MMA form)
constexpr int kMmaBN = 4 * kWgN;     // GEMM columns per pass (MMA form)
constexpr int kStageBytes = 36864;   // one ring stage (MMA form)
constexpr int kMaxStages = 2;        // ring stages, where W leaves room
using triples::kSmemDynMax;

enum Mode { kF32 = 0, kSplit = 1, kBf16 = 2 };

// FFMA form: k depth of a staged chunk, output columns a thread, and the
// bytes of one ring stage ([BK][64 + kPadA] of A, [BK][64 CW] of B)
template <typename T>
__host__ __device__ constexpr int ffma_bk() {
  return sizeof(T) == 4 ? 16 : 8;
}
template <typename T>
__host__ __device__ constexpr int ffma_cw() {
  return sizeof(T) == 4 ? 8 : 4;
}
template <typename T>
__host__ __device__ constexpr int ffma_stage() {
  return ffma_bk<T>() * (kBM + kPadA + 64 * ffma_cw<T>()) * sizeof(T);
}

// MMA form: the stage of one k-chunk, [A hi][A lo][B hi][B lo] (lo parts
// in mode split only).  A (64 rows x KC) and each warpgroup's 128 columns
// of B (KC x 128) are tiles of core matrices (wgmma_bf16.cuh), adjacent
// along k at 128 bytes (LBO), along m or n at SBO.  The operands arrive in
// this order in device memory (the wrapper's tiled layout), so a stage is
// filled by one bulk copy per ov block and half, and one per half of B.
template <bool kSplitMode>
struct MmaTile {
  static constexpr int KC = kSplitMode ? 16 : 32;   // k depth of a stage
  static constexpr int H = kSplitMode ? 2 : 1;      // halves: hi (, lo)
  static constexpr int SBO = KC / 8 * 128;
  static constexpr int A_HALF = kBM * KC * 2;       // bytes
  static constexpr int B_WG = kWgN * KC * 2;
  static constexpr int B_HALF = 4 * B_WG;
  static_assert(H * (A_HALF + B_HALF) == kStageBytes, "stage size");
};

// index of the ordered role pair (r1, r2) in PAIRS order
__host__ __device__ __forceinline__ int pair_id(int r1, int r2) {
  return 2 * r1 + (r2 < r1 ? r2 : r2 - 1);
}

using triples::w_bytes;

__host__ __device__ inline int stage_bytes(int mode, int itemsize) {
  if (mode != kF32) return kStageBytes;
  return itemsize == 4 ? ffma_stage<float>() : ffma_stage<double>();
}

// ring stages of the GEMM staging that fit beside W (0: none)
__host__ __device__ inline int ring_stages(int o, int itemsize, int mode) {
  const long long s = (kSmemDynMax - w_bytes(o, itemsize))
                      / stage_bytes(mode, itemsize);
  return s < 0 ? 0 : (s > kMaxStages ? kMaxStages : (int)s);
}

// dynamic shared memory: padded W, then the ring of the GEMM staging,
// reused by the epilogue (w2 staging, V-term staging), which takes at
// least 6 o^2 values: the floor that has set the modes' nocc limits
__host__ __device__ inline long long smem_bytes(int o, int itemsize,
                                                int mode) {
  const int s = ring_stages(o, itemsize, mode);
  const long long g =
      (long long)(s > 0 ? s : 1) * stage_bytes(mode, itemsize);
  const long long t = 6LL * o * o * itemsize;
  return w_bytes(o, itemsize) + (g > t ? g : t);
}

template <typename T>
struct Args {
  const unsigned long long* ptrs;  // (K, 18): addresses of the W1 operands,
                                   // the hi (or only) parts of the 3 t2
                                   // slices [z, f, (j,k)] = t2[k,j,z,f] and
                                   // of the 6 ov blocks [x, y, i, f] =
                                   // (ix|fy), PAIRS6 order, then their lo
                                   // parts; dense (T, F, o*o) and
                                   // (T, T, o, F) in mode f32, tiled in
                                   // modes split and bf16 (MmaTile)
  const T* vooo;     // (K,3,T,o*o,o)   [x, (i,j), m] = (ix|jm)
  const T* t2p;      // (K,6,T,T,o,o)   [(r1,r2),x,y,m,n] = t2[n,m,x,y]
  const T* oovv;     // (K,6,T,T,o,o)   [(r1,r2),x,y,i,j] = (ix|jy)
  const T* t1;       // (K,3,T,o)       [r,z,k] = t1[k,z]
  const T* fvo;      // (K,3,T,o)       [r,z,k] = fvo[z,k]
  const T* eijk;     // (o,o,o)
  const int* orbits; // (norb,) occupied orbits r0 | r1 << 8 | r2 << 16
  const T* eabc;     // (K,T,T,T)
  const T* wgt;      // (K,T,T,T) degeneracy weights (0 on padded cells)
  const T* act;      // (K,T,T,T) active-virtual products, or null
  const T* actocc;   // (o,o,o) active-occupied products, or null
  int act_mode;      // 0 none, 1 exclude_active, 2 only_active
  int nt;            // tile edge T
  int o;             // occupied count
  int F;             // contraction length (zero-padded virtuals)
  int nstage;        // ring stages
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
// Thread tile 8 x CW: rows {4rg..4rg+3, 32+4rg..}, columns
// CW*4*warp + 16*jj + 4cg + 0..3 (jj < CW/4), so each 4-wide shared load of
// a warp covers one contiguous span.  k-chunks of BK go through a ring of
// stages: the rows of B (contiguous in device memory) by bulk copies that
// one thread issues, where they are 16-byte aligned, else by every thread;
// A transposed through registers, fetched a chunk ahead.  Rows of B beyond
// F are not copied: A is zero there and the ring starts zeroed.
// ---------------------------------------------------------------------------
template <typename T>
__device__ void w1_pair_ffma(const T* A1, const T* A2, const T* B, T* Wsm,
                             unsigned char* ring, uint64_t* full,
                             int nstage, int& it, int o, int F, int q1,
                             int q2) {
  constexpr int BK = ffma_bk<T>();
  constexpr int CW = ffma_cw<T>();
  constexpr int BN = 64 * CW;               // 16 warps x 4 lanes x CW
  constexpr int SA = kBM + kPadA;
  constexpr int NA = kBM * BK / kThreads;   // staged A values per thread
  constexpr int STAGE = ffma_stage<T>();
  const int M = 2 * o, N = o * o;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane & 7, cg = lane >> 3;
  const bool bulk = ((long long)N * sizeof(T)) % 16 == 0
                    && (reinterpret_cast<unsigned long long>(B) & 15) == 0;
  const int nk = (F + BK - 1) / BK;
  auto sA = [&](int s) { return reinterpret_cast<T*>(ring + s * STAGE); };
  auto sB = [&](int s) { return sA(s) + BK * SA; };

  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      T acc[8][CW];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = T(0);
      T pa[NA];
      auto fetch_a = [&](int k0) {
#pragma unroll
        for (int u = 0; u < NA; ++u) {
          const int e = tid + u * kThreads, kk = e % BK, r = e / BK;
          const int gr = m0 + r, f = k0 + kk;
          const T* row = gr < o ? A1 + (long long)gr * F
                                : A2 + (long long)(gr - o) * F;
          pa[u] = (gr < M && f < F) ? __ldg(row + f) : T(0);
        }
      };
      // chunk at k0 into stage s: A from the registers, B copied
      auto stage = [&](int s, int k0) {
#pragma unroll
        for (int u = 0; u < NA; ++u) {
          const int e = tid + u * kThreads;
          sA(s)[(e % BK) * SA + e / BK] = pa[u];
        }
        T* b = sB(s);
        if (bulk) {
          if (tid == 0) {
            const int rows = min(BK, F - k0);
            const uint32_t rb = (uint32_t)(min(BN, N - n0) * sizeof(T));
            wgmma::mbar_expect_tx(&full[s], rows * rb);
            for (int kk = 0; kk < rows; ++kk)
              wgmma::bulk_copy(b + kk * BN, B + (long long)(k0 + kk) * N + n0,
                               rb, &full[s]);
          }
        } else {
          for (int e = tid; e < BK * BN; e += kThreads) {
            const int f = k0 + e / BN, gc = n0 + e % BN;
            b[e] = (f < F && gc < N) ? __ldg(B + (long long)f * N + gc)
                                     : T(0);
          }
        }
      };
      fetch_a(0);
      if (nstage > 1) {
        stage(it & 1, 0);
        if (nk > 1) fetch_a(BK);
      }
#pragma unroll 1
      for (int c = 0; c < nk; ++c, ++it) {
        const int s = nstage > 1 ? it & 1 : 0;
        if (nstage > 1) {
          if (bulk) wgmma::mbar_wait(&full[s], (it >> 1) & 1);
          __syncthreads();    // chunk c is visible, chunk c - 1 consumed
          if (c + 1 < nk) {
            stage(s ^ 1, (c + 1) * BK);
            if (c + 2 < nk) fetch_a((c + 2) * BK);
          }
        } else {
          __syncthreads();    // the previous chunk is consumed
          stage(0, c * BK);
          if (c + 1 < nk) fetch_a((c + 1) * BK);
          if (bulk) wgmma::mbar_wait(&full[0], it & 1);
          __syncthreads();
        }
        const T* a_s = sA(s);
        const T* b_s = sB(s);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          T a[8], b[CW];
          lds4(a_s + kk * SA + rg * 4, a);
          lds4(a_s + kk * SA + 32 + rg * 4, a + 4);
#pragma unroll
          for (int jj = 0; jj < CW / 4; ++jj)
            lds4(b_s + kk * BN + warp * 4 * CW + jj * 16 + cg * 4, b + 4 * jj);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < CW; ++j) acc[i][j] += a[i] * b[j];
        }
      }
#pragma unroll 1
      for (int ph = 0; ph < 2; ++ph) {
        int p0, p1, p2;
        perm_of(ph ? q2 : q1, p0, p1, p2);
        const int si = slot_stride(p0, o), sj = slot_stride(p1, o),
                  sk = slot_stride(p2, o);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int gc = n0 + warp * 4 * CW + (j >> 2) * 16 + cg * 4 + (j & 3);
          if (gc >= N) continue;
          const int jp = gc / o, kp = gc - jp * o;
          const int coff = jp * sj + kp * sk;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int ip = m0 + (i >> 2) * 32 + rg * 4 + (i & 3) - ph * o;
            if (ip >= 0 && ip < o) Wsm[ip * si + coff] += acc[i][j];
          }
        }
        __syncthreads();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// W1, modes split and bf16: the same product on the tensor cores.
// Operands in the tiled layout of the wrapper, OP = o rounded up to 8 rows,
// NP = o^2 rounded up to 8 columns, F a multiple of the k-chunk KC:
//   ov block  [c][mg][kg][r][kk] = ov[8 mg + r][KC c + 8 kg + kk]
//             (F/KC, OP/8, KC/8, 8, 8)
//   t2 slice  [c][ng][kg][kr][nn] = t2[KC c + 8 kg + kr][8 ng + nn]
//             (F/KC, NP/8, KC/8, 8, 8)
// so the k-chunk c of a block, or of 512 columns of a slice, is one
// contiguous run that lands in the stage as its tile of core matrices.
// Rows of a pass: both ov blocks (perm q1 in rows 0.., perm q2 from OP)
// where 2 OP <= 64, else one block a pass.  Rows and columns of the stage
// beyond the product hold stale values; they reach only rows and columns
// of the product that are never added into W.
// ---------------------------------------------------------------------------
struct Bf16Tiles {
  const unsigned char* a1[2];   // tiled ov block of perm q1, hi and lo
  const unsigned char* a2[2];   // of perm q2
  const unsigned char* b[2];    // tiled t2 slice
};

// one thread: the copies of chunk c (columns n0..) into stage st; pass 0
// takes both ov blocks, pass 1 the block of q1, pass 2 that of q2
template <bool kSplitMode>
__device__ __forceinline__ void issue_chunk(unsigned char* st, uint64_t* bar,
                                            const Bf16Tiles& op, int c,
                                            int n0, int op8, int np8,
                                            int pass) {
  using Tl = MmaTile<kSplitMode>;
  constexpr int KG = Tl::KC / 8;
  const uint32_t ablk = op8 * KG * 128;
  const uint32_t bbytes = min(64, np8 - n0 / 8) * KG * 128;
  const long long aoff = (long long)c * ablk;
  const long long boff = ((long long)c * np8 + n0 / 8) * KG * 128;
  wgmma::mbar_expect_tx(bar, Tl::H * ((pass == 0 ? 2 : 1) * ablk + bbytes));
#pragma unroll
  for (int h = 0; h < Tl::H; ++h) {
    unsigned char* sa = st + h * Tl::A_HALF;
    if (pass != 2) wgmma::bulk_copy(sa, op.a1[h] + aoff, ablk, bar);
    if (pass != 1)
      wgmma::bulk_copy(sa + (pass == 0 ? ablk : 0), op.a2[h] + aoff, ablk,
                       bar);
    wgmma::bulk_copy(st + Tl::H * Tl::A_HALF + h * Tl::B_HALF,
                     op.b[h] + boff, bbytes, bar);
  }
}

// this warpgroup's 64 x 128 product of the staged chunk, added to acc
template <bool kSplitMode>
__device__ __forceinline__ void mma_chunk(const unsigned char* st,
                                          float (&acc)[64], int wg) {
  using Tl = MmaTile<kSplitMode>;
  const uint32_t a0 = wgmma::smem_u32(st);
  const uint32_t b0 = a0 + Tl::H * Tl::A_HALF + wg * Tl::B_WG;
#pragma unroll
  for (int s = 0; s < Tl::KC / 16; ++s) {     // k16 steps: 2 core matrices
    const uint64_t ah = wgmma::desc(a0 + 256 * s, 128, Tl::SBO);
    const uint64_t bh = wgmma::desc(b0 + 256 * s, 128, Tl::SBO);
    wgmma::mma_m64n128k16(acc, ah, bh);
    if (kSplitMode) {
      const uint64_t al = wgmma::desc(a0 + Tl::A_HALF + 256 * s, 128,
                                      Tl::SBO);
      const uint64_t bl = wgmma::desc(b0 + Tl::B_HALF + 256 * s, 128,
                                      Tl::SBO);
      wgmma::mma_m64n128k16(acc, ah, bl);
      wgmma::mma_m64n128k16(acc, al, bh);
    }
  }
}

template <bool kSplitMode>
__device__ void w1_pair_wgmma(const Bf16Tiles& op, float* Wsm,
                              unsigned char* ring, uint64_t* full,
                              int nstage, int& it, int o, int F, int q1,
                              int q2) {
  using Tl = MmaTile<kSplitMode>;
  const int N = o * o, op8 = (o + 7) / 8, np8 = (N + 7) / 8;
  const int nk = F / Tl::KC, tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int npass = 16 * op8 <= kBM ? 1 : 2;

  for (int mp = 0; mp < npass; ++mp) {
    const int pass = npass == 1 ? 0 : 1 + mp;
    for (int n0 = 0; n0 < N; n0 += kMmaBN) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      const bool active = n0 + wg * kWgN < N;   // uniform per warpgroup
      if (nstage > 1 && tid == 0)
        issue_chunk<kSplitMode>(ring + (it & 1) * kStageBytes,
                                &full[it & 1], op, 0, n0, op8, np8, pass);
#pragma unroll 1
      for (int c = 0; c < nk; ++c, ++it) {
        const int s = nstage > 1 ? it & 1 : 0;
        if (nstage > 1) {
          // chunk c landed; after the barrier every warpgroup has
          // finished chunk c - 1, whose stage is refilled
          wgmma::mbar_wait(&full[s], (it >> 1) & 1);
          __syncthreads();
          if (tid == 0 && c + 1 < nk)
            issue_chunk<kSplitMode>(ring + (s ^ 1) * kStageBytes,
                                    &full[s ^ 1], op, c + 1, n0, op8, np8,
                                    pass);
        } else {
          __syncthreads();            // the previous chunk is consumed
          if (tid == 0)
            issue_chunk<kSplitMode>(ring, &full[0], op, c, n0, op8, np8,
                                    pass);
          wgmma::mbar_wait(&full[0], it & 1);
        }
        if (active) {
          wgmma::fence_operands(acc);
          wgmma::fence();
          mma_chunk<kSplitMode>(ring + s * kStageBytes, acc, wg);
          wgmma::commit();
          wgmma::wait<0>();
          wgmma::fence_operands(acc);
        }
      }
      // acc[4 jb + 2 h + e]: row 16 w + g + 8 h, column
      // n0 + 128 wg + 8 jb + 2 qd + e of the pass
      const int c0 = n0 + wg * kWgN + 2 * qd;
#pragma unroll 1
      for (int ph = 0; ph < (pass == 0 ? 2 : 1); ++ph) {
        const int q = pass == 0 ? (ph ? q2 : q1) : (pass == 1 ? q1 : q2);
        int p0, p1, p2;
        perm_of(q, p0, p1, p2);
        const int si = slot_stride(p0, o), sj = slot_stride(p1, o),
                  sk = slot_stride(p2, o);
        const int ip0 = 16 * w + g - (pass == 0 ? ph * 8 * op8 : 0);
        const int ip1 = ip0 + 8;
        const bool ok0 = ip0 >= 0 && ip0 < o, ok1 = ip1 >= 0 && ip1 < o;
        int jp = c0 / o, kp = c0 - jp * o;     // column c0 + 8 jb as (j', k')
#pragma unroll
        for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int ke = kp + e, je = jp;
            if (ke >= o) {
              ke -= o;
              ++je;
            }
            if (active && c0 + 8 * jb + e < N) {
              const int coff = je * sj + ke * sk;
              if (ok0) Wsm[ip0 * si + coff] += acc[4 * jb + e];
              if (ok1) Wsm[ip1 * si + coff] += acc[4 * jb + 2 + e];
            }
          }
          kp += 8;
          while (kp >= o) {
            kp -= o;
            ++jp;
          }
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
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nt = a.nt, o = a.o, oo = o * o, F = a.F;
  T* Wsm = reinterpret_cast<T*>(smem_raw);
  unsigned char* scratch = smem_raw + w_bytes(o, sizeof(T));

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

  // per-perm inputs of this cell, shared by the block; w1p[h] holds the
  // hi (h = 0) or lo (h = 1, mode split) parts of the cell's 3 t2 slices
  // and 6 ov blocks
  __shared__ CellPtrs<T> cp;
  __shared__ const unsigned char* w1p[2][9];
  __shared__ uint64_t full[kMaxStages];   // ring stages' copy barriers
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) wgmma::mbar_init(&full[s], 1);
    wgmma::mbar_init_fence();
  }
  if (threadIdx.x < 6) {
    const int q = threadIdx.x;
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const long long x = v[p0], y = v[p1], z = v[p2], Tl = nt;
    // bytes of one ov block and one t2 slice (tiled: rows and columns
    // rounded up to 8)
    const long long ovb = kMode == kF32 ? (long long)o * F * sizeof(T)
                                        : 16LL * ((o + 7) / 8) * F;
    const long long t2b = kMode == kF32 ? (long long)oo * F * sizeof(T)
                                        : 16LL * ((oo + 7) / 8) * F;
    const unsigned long long* pk = a.ptrs + k * 18;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      using Bytes = const unsigned char*;
      const auto ov = reinterpret_cast<Bytes>(pk[9 * h + 3 + q]);
      const auto t2 = reinterpret_cast<Bytes>(pk[9 * h + q % 3]);
      w1p[h][3 + q] = ov ? ov + (x * Tl + y) * ovb : nullptr;
      if (q < 3) w1p[h][q] = t2 ? t2 + v[q] * t2b : nullptr;
    }
    cp.vooo[q] = a.vooo + ((k * 3 + p0) * Tl + x) * oo * o;
    cp.t2zy[q] = a.t2p + (((k * 6 + pair_id(p2, p1)) * Tl + z) * Tl + y) * oo;
    cp.oovv[q] = a.oovv + (((k * 6 + pair_id(p0, p1)) * Tl + x) * Tl + y) * oo;
    cp.t2yx[q] = a.t2p + (((k * 6 + pair_id(p1, p0)) * Tl + y) * Tl + x) * oo;
    cp.t1z[q] = a.t1 + ((k * 3 + p2) * Tl + z) * o;
    cp.fvoz[q] = a.fvo + ((k * 3 + p2) * Tl + z) * o;
  }
  // W and the ring start zeroed (the FFMA form multiplies the rows of a
  // stage beyond F by zeros of A)
  const long long nz = (w_bytes(o, sizeof(T))
                        + (long long)a.nstage * stage_bytes(kMode, sizeof(T)))
                       / 16;
  for (long long e = threadIdx.x; e < nz; e += blockDim.x)
    reinterpret_cast<float4*>(smem_raw)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  wgmma::fence_proxy_async();
  __syncthreads();
  int it = 0;       // ring rounds so far: stage it % nstage, its phase

  // W = sum_p P_p w1_p: perms (x,y,z) and (y,x,z) share the t2 slice z
#pragma unroll 1
  for (int z = 0; z < 3; ++z) {
    const int x = z == 0 ? 1 : 0, y = z == 2 ? 1 : 2;
    const int q1 = perm_id(x, y, z), q2 = perm_id(y, x, z);
    if constexpr (kMode == kF32) {
      w1_pair_ffma<T>(reinterpret_cast<const T*>(w1p[0][3 + q1]),
                      reinterpret_cast<const T*>(w1p[0][3 + q2]),
                      reinterpret_cast<const T*>(w1p[0][z]), Wsm, scratch,
                      full, a.nstage, it, o, F, q1, q2);
    } else {
      Bf16Tiles op;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        op.a1[h] = w1p[h][3 + q1];
        op.a2[h] = w1p[h][3 + q2];
        op.b[h] = w1p[h][z];
      }
      w1_pair_wgmma<kMode == kSplit>(op, Wsm, scratch, full, a.nstage, it,
                                     o, F, q1, q2);
    }
  }
  // the epilogue (triples_epilogue.cuh) in the staging area, free since
  // the last scatter pass ended with a barrier
  const long long sbytes = smem_bytes(o, sizeof(T), kMode)
                           - w_bytes(o, sizeof(T));
  triples::subtract_w2(cp, Wsm, scratch, sbytes, o);

  const int S1 = triples::w_s1(o), S0 = triples::w_s0(o);
  auto wval = [&](const int* oc) -> T {
    return Wsm[oc[0] * S0 + oc[1] * S1 + oc[2]];
  };
  const int norb = o * (o + 1) * (o + 2) / 6;
  T* vs = reinterpret_cast<T*>(scratch);
  double acc;
  if (triples::vstage_elems(o) * (long long)sizeof(T) <= sbytes) {
    triples::stage_vterms(cp, vs, o);
    __syncthreads();
    acc = triples::orbit_energy<T, true>(cp, vs, a.orbits, norb, a.eijk,
                                         a.actocc, a.act_mode, eabc, af, o,
                                         threadIdx.x, blockDim.x, wval);
  } else {
    acc = triples::orbit_energy<T, false>(cp, vs, a.orbits, norb, a.eijk,
                                          a.actocc, a.act_mode, eabc, af, o,
                                          threadIdx.x, blockDim.x, wval);
  }
  const double t = triples::block_sum(acc);
  if (threadIdx.x == 0) *out = t * (double)wgt;
}

template <typename T, int kMode>
int launch(Args<T> a, int K, void* stream) {
  const size_t smem = (size_t)smem_bytes(a.o, sizeof(T), kMode);
  a.nstage = ring_stages(a.o, sizeof(T), kMode);
  if (smem > (size_t)kSmemDynMax || a.nstage < 1)
    return (int)cudaErrorInvalidValue;
  if (kMode != kF32 && a.F % MmaTile<kMode == kSplit>::KC)
    return (int)cudaErrorInvalidValue;
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
                  const void* fvo, const void* eijk, const void* orbits,
                  const void* eabc,
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
  a.orbits = static_cast<const int*>(orbits);
  a.eabc = static_cast<const T*>(eabc);
  a.wgt = static_cast<const T*>(wgt);
  a.act = static_cast<const T*>(act);
  a.actocc = static_cast<const T*>(actocc);
  a.act_mode = act_mode;
  a.nt = nt;
  a.o = o;
  a.F = F;
  a.nstage = 0;
  a.out = static_cast<double*>(out);
  return a;
}

}  // namespace

extern "C" {

int triples_resident_threads() { return kThreads; }

// dynamic shared-memory bytes a block may use
long long triples_resident_smem_max() { return kSmemDynMax; }

// dynamic shared-memory bytes for nocc = o, an item size of 4 or 8 and a
// mode (0 f32, 1 split, 2 bf16); the caller checks it against
// triples_resident_smem_max()
long long triples_resident_smem_bytes(int o, int itemsize, int mode) {
  return smem_bytes(o, itemsize, mode);
}

// ring stages of the GEMM staging at nocc = o, an item size and a mode
// (0: W leaves no room)
int triples_resident_stages(int o, int itemsize, int mode) {
  return ring_stages(o, itemsize, mode);
}

// k depth of one staged chunk in mode split or bf16 (the tiled operands'
// chunk; F must be a multiple of it)
int triples_resident_k_chunk(int mode) {
  return mode == kSplit ? MmaTile<true>::KC : MmaTile<false>::KC;
}

// ptrs: (K, 18) addresses of the W1 operands (Args::ptrs), float32 in mode
// f32, tiled bf16 in modes split (hi and lo) and bf16 (hi); orbits: the
// (o (o+1) (o+2) / 6,) int32 occupied-orbit table
int triples_resident_f32(int K, int nt, int o, int F, int mode,
                         const void* ptrs, const void* vooo, const void* t2p,
                         const void* oovv, const void* t1, const void* fvo,
                         const void* eijk, const void* orbits,
                         const void* eabc, const void* wgt,
                         const void* act, const void* actocc, int act_mode,
                         void* out, void* stream) {
  const Args<float> a = make_args<float>(nt, o, F, ptrs, vooo, t2p, oovv, t1,
                                         fvo, eijk, orbits, eabc, wgt, act,
                                         actocc, act_mode, out);
  if (mode == kF32) return launch<float, kF32>(a, K, stream);
  if (mode == kSplit) return launch<float, kSplit>(a, K, stream);
  if (mode == kBf16) return launch<float, kBf16>(a, K, stream);
  return (int)cudaErrorInvalidValue;
}

// fp64 runs mode f32 only (DFMA)
int triples_resident_f64(int K, int nt, int o, int F, int mode,
                         const void* ptrs, const void* vooo, const void* t2p,
                         const void* oovv, const void* t1, const void* fvo,
                         const void* eijk, const void* orbits,
                         const void* eabc, const void* wgt,
                         const void* act, const void* actocc, int act_mode,
                         void* out, void* stream) {
  if (mode != kF32) return (int)cudaErrorInvalidValue;
  const Args<double> a = make_args<double>(nt, o, F, ptrs, vooo, t2p, oovv,
                                           t1, fvo, eijk, orbits, eabc, wgt,
                                           act, actocc, act_mode, out);
  return launch<double, kF32>(a, K, stream);
}

}  // extern "C"
