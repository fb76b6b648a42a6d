// CCSD(T) per-tile permutation epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel pyscf_mpcc_tpu/ops/triples_combine.py:
// _combine_kernel (the Pallas body of tile_energy_fused and
// tile_energy_fused_chunk).  For every cell (a, b, c) of a virtual tile
// triple, with occupied indices (i, j, k):
//
//   W = sum_p P_p (w1_p - w2_p),    w2_p = sum_m (i'x|j'm) t2[k',m,z,y]
//   V = W + sum_p P_p 1/2 ((i'x|j'y) t1[k',z] + t2[j',i',y,x] fvo[z,k'])
//   Z = 4V + V_jki + V_kij - 2V_kji - 2V_ikj - 2V_jik
//   e = sum W Z / (e_ijk - e_abc) * weight(a,b,c) [* active-space mask]
//
// where p runs over the six joint (abc)/(ijk) permutations and w1_p comes
// from the six W_PLAN dot outputs (a storage layout, read here with index
// arithmetic).
//
// What bounds it on this card: reading the six w1 streams, 6 T^3 o^3
// values per tile (403 MB in fp32 at the bench shape o=32, T=8), and the
// in-kernel w2 dots, 6 o^4 multiply-adds per cell (3.2e9 per tile).  The
// design keeps W and V out of device memory: one block per (tile, a, b, c)
// cell builds the cell's W (o^3 values) in shared memory.  The w1 streams
// are read in canonical order, and every W_PLAN layout has canonical k as
// its minor dimension, so a warp reads consecutive addresses.  Each w2 dot
// is a small GEMM, (o^2 x o) vooo rows times a staged o x o t2 block, in
// which the lanes of a warp share one vooo row (one broadcast load per
// multiply-add) and scatter into W at permuted, bank-padded positions.
// The energy then needs V only at the six permutations of (i,j,k), and
// e_ijk and the occupied mask are symmetric under them, so one thread owns
// one occupied orbit {sigma(i,j,k)}, i >= j >= k, and adds the V term to
// its six W values in registers.  Each block writes one partial energy: no
// atomics, so the sum is deterministic; the host wrapper adds the partials
// in fp64.  The w2 dots and the orbit phase are shared with the resident
// kernel (triples_epilogue.cuh).
//
// When the cell's W does not fit in shared memory (fp64 beyond o = 28,
// fp32 beyond o = 36) the same kernel runs unstaged: each orbit thread
// computes its six W values itself, reading w1 and vooo directly, and the
// orbits of a cell may be split over several blocks.

#include <cuda_runtime.h>

#include "triples_epilogue.cuh"

namespace {

using triples::CellPtrs;
using triples::perm_of;

constexpr int kThreads = 512;

template <typename T>
struct Args {
  const T* w[6];     // W_PLAN streams: ov_first (K,T,T,o,T,o,o),
                     //                 t2_first (K,T,T,T,o,o,o)
  const T* vooo;     // (K,3,T,o*o,o)   [x, (i,j), m] = (ix|jm)
  const T* t2p;      // (K,3,3,T,T,o,o) [r1,r2,x,y,m,n] = t2[n,m,x,y]
  const T* oovv;     // (K,3,3,T,T,o,o) [r1,r2,x,y,i,j] = (ix|jy)
  const T* t1;       // (K,3,T,o)       [r,z,k] = t1[k,z]
  const T* fvo;      // (K,3,T,o)       [r,z,k] = fvo[z,k]
  const T* eijk;     // (o,o,o)
  const int* gabc;   // (K,3,T) global virtual indices
  const T* evt;      // (K,3,T) virtual orbital energies
  const T* actv;     // (K,3,T) active-virtual flags, or null
  const T* actocc;   // (o,o,o) active-occupied products, or null
  int act_mode;      // 0 none, 1 exclude_active, 2 only_active
  int nt;            // tile edge T
  int o;             // occupied count
  int nsplit;        // blocks per cell (1 when staged)
  double* out;       // (K,T,T,T,nsplit) partial energies
};

// shared-memory elements of the staged kernel: padded W, six t2 blocks
__host__ __device__ __forceinline__ long long staged_elems(int o) {
  return triples::w_elems(o) + 6LL * o * o;
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t2s = reinterpret_cast<T*>(smem_raw);   // 6 blocks of o*o

  const int nt = a.nt, o = a.o, oo = o * o;
  const int cell = blockIdx.x;
  const int split = blockIdx.y;
  const int C = cell % nt;
  const int B = (cell / nt) % nt;
  const int A = (cell / (nt * nt)) % nt;
  const long long k = cell / (nt * nt * nt);
  double* out = a.out + (long long)cell * a.nsplit + split;

  // degeneracy weight on GLOBAL virtual indices (padded virtuals carry
  // their own global index; their 1e6 energies keep denominators finite)
  const int* g = a.gabc + k * 3 * nt;
  const int ga = g[A], gb = g[nt + B], gc = g[2 * nt + C];
  const double wgt = (ga > gb && gb > gc) ? 1.0
                     : (ga == gb && gb == gc) ? 1.0 / 6.0
                     : (ga >= gb && gb >= gc) ? 0.5 : 0.0;
  if (wgt == 0.0) {          // uniform over the block: no barrier skipped
    if (threadIdx.x == 0) *out = 0.0;
    return;
  }
  const T* ev = a.evt + k * 3 * nt;
  const T eabc = ev[A] + ev[nt + B] + ev[2 * nt + C];
  T af = T(0);
  if (a.act_mode) {
    const T* av = a.actv + k * 3 * nt;
    af = av[A] * av[nt + B] * av[2 * nt + C];
  }
  const int v[3] = {A, B, C};

  // per-perm inputs of this cell, shared by the block
  __shared__ long long wbase[6];
  __shared__ CellPtrs<T> cp;
  if (threadIdx.x < 6) {
    const int q = threadIdx.x;
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const long long x = v[p0], y = v[p1], z = v[p2], Tl = nt;
    wbase[q] = (q < 4)
        ? (((k * Tl + x) * Tl + y) * o) * Tl * oo + z * oo  // + i*T*oo + P
        : (((k * Tl + z) * Tl + x) * Tl + y) * oo * o;      // + P*o + i
    cp.vooo[q] = a.vooo + ((k * 3 + p0) * Tl + x) * oo * o;
    cp.t2zy[q] = a.t2p + ((((k * 3 + p2) * 3 + p1) * Tl + z) * Tl + y) * oo;
    cp.oovv[q] = a.oovv + ((((k * 3 + p0) * 3 + p1) * Tl + x) * Tl + y) * oo;
    cp.t2yx[q] = a.t2p + ((((k * 3 + p1) * 3 + p0) * Tl + y) * Tl + x) * oo;
    cp.t1z[q] = a.t1 + ((k * 3 + p2) * Tl + z) * o;
    cp.fvoz[q] = a.fvo + ((k * 3 + p2) * Tl + z) * o;
  }
  __syncthreads();
  // stage t2p[p2, p1, z, y, :, :] (= t2[n, m, z, y]) for the w2 dots
  triples::stage_t2zy(cp, t2s, o);
  __syncthreads();

  const int S1 = triples::w_s1(o), S0 = triples::w_s0(o);
  T* Wsm = t2s + 6 * oo;
  auto widx = [&](int q, int i1, int P1, int P2) -> long long {
    return (q < 4) ? wbase[q] + (long long)i1 * nt * oo + P1 * o + P2
                   : wbase[q] + (long long)(P1 * o + P2) * o + i1;
  };
  if constexpr (kStaged) {
    // W = sum_p w1_p, canonical order (lanes along k: coalesced reads)
    for (int e = threadIdx.x; e < o * oo; e += blockDim.x) {
      const int oc[3] = {e / oo, (e / o) % o, e % o};
      T w = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        int p0, p1, p2;
        perm_of(q, p0, p1, p2);
        const int i1 = oc[p0], j1 = oc[p1], k1 = oc[p2];
        // W_PLAN: even perms pair (j,k), odd perms (k,j)
        w += __ldg(a.w[q] + widx(q, i1, (q & 1) ? k1 : j1,
                                 (q & 1) ? j1 : k1));
      }
      Wsm[oc[0] * S0 + oc[1] * S1 + oc[2]] = w;
    }
    __syncthreads();
    // W -= sum_p P_p w2_p (small GEMMs on the staged t2 blocks)
    triples::subtract_w2(cp, t2s, Wsm, o);
  }

  // the unstaged form computes each W value where it is needed: its six
  // w1 reads and six w2 dots (each a row of vooo against a staged column)
  auto wval = [&](const int* oc) -> T {
    if constexpr (kStaged) {
      return Wsm[oc[0] * S0 + oc[1] * S1 + oc[2]];
    } else {
      T W = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        int p0, p1, p2;
        perm_of(q, p0, p1, p2);
        const int i1 = oc[p0], j1 = oc[p1], k1 = oc[p2];
        W += __ldg(a.w[q] + widx(q, i1, (q & 1) ? k1 : j1,
                                 (q & 1) ? j1 : k1));
        const T* vr = cp.vooo[q] + (i1 * o + j1) * o;
        const T* tc = t2s + q * oo + k1;
        T w2 = T(0);
        for (int m = 0; m < o; ++m) w2 += __ldg(vr + m) * tc[m * o];
        W -= w2;
      }
      return W;
    }
  };
  const double acc = triples::orbit_energy(
      cp, a.eijk, a.actocc, a.act_mode, eabc, af, o,
      split * blockDim.x + threadIdx.x, a.nsplit * blockDim.x, wval);
  const double t = triples::block_sum(acc);
  if (threadIdx.x == 0) *out = t * wgt;
}

template <typename T>
int launch(int K, int nt, int o, int nsplit, int staged,
           const void* const* w,
           const void* vooo, const void* t2p, const void* oovv,
           const void* t1, const void* fvo, const void* eijk,
           const void* gabc, const void* evt, const void* actv,
           const void* actocc, int act_mode, void* out, void* stream) {
  Args<T> a;
  for (int q = 0; q < 6; ++q) a.w[q] = static_cast<const T*>(w[q]);
  a.vooo = static_cast<const T*>(vooo);
  a.t2p = static_cast<const T*>(t2p);
  a.oovv = static_cast<const T*>(oovv);
  a.t1 = static_cast<const T*>(t1);
  a.fvo = static_cast<const T*>(fvo);
  a.eijk = static_cast<const T*>(eijk);
  a.gabc = static_cast<const int*>(gabc);
  a.evt = static_cast<const T*>(evt);
  a.actv = static_cast<const T*>(actv);
  a.actocc = static_cast<const T*>(actocc);
  a.act_mode = act_mode;
  a.nt = nt;
  a.o = o;
  a.nsplit = nsplit;
  a.out = static_cast<double*>(out);
  // staged: W in shared memory, one block per cell; the caller checks
  // that it fits (triples_combine_staged_bytes)
  if (staged) a.nsplit = 1;
  const size_t smem = sizeof(T) * (staged ? (size_t)staged_elems(o)
                                          : 6 * (size_t)o * o);
  auto kern = staged ? combine_kernel<T, true> : combine_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)(K * nt * nt * nt), (unsigned)a.nsplit);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int triples_combine_threads() { return kThreads; }

// shared-memory bytes the staged kernel needs for nocc = o
long long triples_combine_staged_bytes(int o, int itemsize) {
  return staged_elems(o) * itemsize;
}

int triples_combine_f32(int K, int nt, int o, int nsplit, int staged,
                        const void* const* w, const void* vooo,
                        const void* t2p, const void* oovv, const void* t1,
                        const void* fvo, const void* eijk, const void* gabc,
                        const void* evt, const void* actv,
                        const void* actocc, int act_mode, void* out,
                        void* stream) {
  return launch<float>(K, nt, o, nsplit, staged, w, vooo, t2p, oovv, t1,
                       fvo, eijk, gabc, evt, actv, actocc, act_mode, out,
                       stream);
}

int triples_combine_f64(int K, int nt, int o, int nsplit, int staged,
                        const void* const* w, const void* vooo,
                        const void* t2p, const void* oovv, const void* t1,
                        const void* fvo, const void* eijk, const void* gabc,
                        const void* evt, const void* actv,
                        const void* actocc, int act_mode, void* out,
                        void* stream) {
  return launch<double>(K, nt, o, nsplit, staged, w, vooo, t2p, oovv, t1,
                        fvo, eijk, gabc, evt, actv, actocc, act_mode, out,
                        stream);
}

}  // extern "C"
