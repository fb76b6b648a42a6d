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
// in fp64.
//
// When the cell's W does not fit in shared memory (fp64 beyond o = 28,
// fp32 beyond o = 36) the same kernel runs unstaged: each orbit thread
// computes its six W values itself, reading w1 and vooo directly, and the
// orbits of a cell may be split over several blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 8;    // w2 rows per thread in the staged kernel

// 16-byte vector of T, for the vooo row loads
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

// perm q in PERMS order (0,1,2) (0,2,1) (1,0,2) (1,2,0) (2,0,1) (2,1,0)
__host__ __device__ __forceinline__ void perm_of(int q, int& p0, int& p1,
                                                 int& p2) {
  p0 = q >> 1;
  const int lo = (p0 == 0) ? 1 : 0;
  const int hi = (p0 == 2) ? 1 : 2;
  p1 = (q & 1) ? hi : lo;
  p2 = (q & 1) ? lo : hi;
}

// index in PERMS order of the permutation (a, b, c)
__device__ __forceinline__ int perm_id(int a, int b, int c) {
  return 2 * a + (b > c ? 1 : 0);
}

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
  return (long long)o * (o * (o + 1) + 1) + 6LL * o * o;
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t2s = reinterpret_cast<T*>(smem_raw);   // 6 blocks of o*o
  __shared__ double red[kThreads / 32];

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

  // per-perm offsets of this cell, shared by the block
  __shared__ long long wbase[6], vbase[6], obase[6], tbase[6], zbase[6];
  if (threadIdx.x < 6) {
    const int q = threadIdx.x;
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const long long x = v[p0], y = v[p1], z = v[p2], Tl = nt;
    wbase[q] = (q < 4)
        ? (((k * Tl + x) * Tl + y) * o) * Tl * oo + z * oo  // + i*T*oo + P
        : (((k * Tl + z) * Tl + x) * Tl + y) * oo * o;      // + P*o + i
    vbase[q] = ((k * 3 + p0) * Tl + x) * oo * o;
    obase[q] = ((((k * 3 + p0) * 3 + p1) * Tl + x) * Tl + y) * oo;
    tbase[q] = ((((k * 3 + p1) * 3 + p0) * Tl + y) * Tl + x) * oo;
    zbase[q] = ((k * 3 + p2) * Tl + z) * o;
  }
  // stage t2p[p2, p1, z, y, :, :] (= t2[n, m, z, y]) for the w2 dots
  for (int e = threadIdx.x; e < 6 * oo; e += blockDim.x) {
    const int q = e / oo;
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const long long src = ((((k * 3 + p2) * 3 + p1) * nt + v[p2]) * nt
                           + v[p1]) * oo;
    t2s[e] = a.t2p[src + e % oo];
  }
  __syncthreads();

  // padded W strides: (o+1) and o(o+1)+1 are odd, so a warp writing along
  // any one canonical axis hits 32 different banks
  const int S1 = o + 1, S0 = o * S1 + 1;
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
    // W -= sum_p P_p w2_p, one perm per pass (each pass writes every
    // element once, at permuted positions, so passes are separated by a
    // barrier)
#pragma unroll 1
    for (int q = 0; q < 6; ++q) {
      int p0, p1, p2;
      perm_of(q, p0, p1, p2);
      const int sx[3] = {S0, S1, 1};
      const int si = p0 == 0 ? sx[0] : p0 == 1 ? sx[1] : sx[2];
      const int sj = p1 == 0 ? sx[0] : p1 == 1 ? sx[1] : sx[2];
      const int sk = p2 == 0 ? sx[0] : p2 == 1 ? sx[1] : sx[2];
      // thread (grp, k1) computes kRows consecutive rows (i1 j1) of
      // column k1: the lanes of a warp share the rows, so each vooo load
      // is a broadcast, and 16-byte loads bring several m at once
      const T* vq = a.vooo + vbase[q];
      const T* tq = t2s + q * oo;
      const bool vec = o % Vec<T>::n == 0
          && (reinterpret_cast<unsigned long long>(a.vooo) & 15) == 0;
      const int ngrp = blockDim.x / o;
      const int grp = threadIdx.x / o, k1 = threadIdx.x - grp * o;
      for (int row0 = grp * kRows; grp < ngrp && row0 < oo;
           row0 += ngrp * kRows) {
        T acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = T(0);
        if (vec && row0 + kRows <= oo) {
          using V = typename Vec<T>::type;
          for (int m0 = 0; m0 < o; m0 += Vec<T>::n) {
            T tv[Vec<T>::n];
#pragma unroll
            for (int c = 0; c < Vec<T>::n; ++c) tv[c] = tq[(m0 + c) * o + k1];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              T vv[Vec<T>::n];
              *reinterpret_cast<V*>(vv) = __ldg(
                  reinterpret_cast<const V*>(vq + (row0 + r) * o + m0));
#pragma unroll
              for (int c = 0; c < Vec<T>::n; ++c) acc[r] += vv[c] * tv[c];
            }
          }
        } else {
          for (int m = 0; m < o; ++m) {
            const T tv = tq[m * o + k1];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              if (row0 + r < oo) acc[r] += __ldg(vq + (row0 + r) * o + m) * tv;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = row0 + r;
          if (row < oo) {
            const int i1 = row / o, j1 = row - i1 * o;
            Wsm[i1 * si + j1 * sj + k1 * sk] -= acc[r];
          }
        }
      }
      __syncthreads();
    }
  }

  double acc = 0.0;
  const int norb = o * (o + 1) * (o + 2) / 6;
  for (int orb = split * blockDim.x + threadIdx.x; orb < norb;
       orb += a.nsplit * blockDim.x) {
    // decode the orbit representative r0 >= r1 >= r2
    int r0 = 0, before = 0;
    while (before + (r0 + 1) * (r0 + 2) / 2 <= orb) {
      before += (r0 + 1) * (r0 + 2) / 2;
      ++r0;
    }
    int rem = orb - before, r1 = 0;
    while (rem >= r1 + 1) {
      rem -= r1 + 1;
      ++r1;
    }
    const int r[3] = {r0, r1, rem};

    T Wv[6], Vv[6];
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      int s0, s1, s2;
      perm_of(s, s0, s1, s2);
      const int oc[3] = {r[s0], r[s1], r[s2]};   // canonical (i, j, k)
      T W = kStaged ? Wsm[oc[0] * S0 + oc[1] * S1 + oc[2]] : T(0);
      T vt = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        int p0, p1, p2;
        perm_of(q, p0, p1, p2);
        const int i1 = oc[p0], j1 = oc[p1], k1 = oc[p2];
        if constexpr (!kStaged) {
          W += __ldg(a.w[q] + widx(q, i1, (q & 1) ? k1 : j1,
                                   (q & 1) ? j1 : k1));
          const T* vr = a.vooo + vbase[q] + (i1 * o + j1) * o;
          const T* tc = t2s + q * oo + k1;
          T w2 = T(0);
          for (int m = 0; m < o; ++m) w2 += __ldg(vr + m) * tc[m * o];
          W -= w2;
        }
        const int ij = i1 * o + j1;
        vt += T(0.5) * (__ldg(a.oovv + obase[q] + ij)
                            * __ldg(a.t1 + zbase[q] + k1)
                        + __ldg(a.t2p + tbase[q] + ij)
                            * __ldg(a.fvo + zbase[q] + k1));
      }
      Wv[s] = W;
      Vv[s] = W + vt;
    }

#pragma unroll
    for (int s = 0; s < 6; ++s) {
      int s0, s1, s2;
      perm_of(s, s0, s1, s2);
      const int e0 = r[s0], e1 = r[s1], e2 = r[s2];
      bool dup = false;
#pragma unroll
      for (int u = 0; u < s; ++u) {
        int u0, u1, u2;
        perm_of(u, u0, u1, u2);
        dup |= (r[u0] == e0 && r[u1] == e1 && r[u2] == e2);
      }
      if (dup) continue;
      const int q[3] = {s0, s1, s2};
      // V at (e1,e2,e0), (e2,e0,e1), (e2,e1,e0), (e0,e2,e1), (e1,e0,e2)
      const T Z = T(4) * Vv[s]
          + Vv[perm_id(q[1], q[2], q[0])] + Vv[perm_id(q[2], q[0], q[1])]
          - T(2) * (Vv[perm_id(q[2], q[1], q[0])]
                    + Vv[perm_id(q[0], q[2], q[1])]
                    + Vv[perm_id(q[1], q[0], q[2])]);
      const int eidx = (e0 * o + e1) * o + e2;
      T zd = Z / (__ldg(a.eijk + eidx) - eabc);
      if (a.act_mode) {
        const T act6 = af * __ldg(a.actocc + eidx);
        zd *= (a.act_mode == 1) ? T(1) - act6 : act6;
      }
      acc += (double)(Wv[s] * zd);
    }
  }

  // deterministic block reduction
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
    *out = t * wgt;
  }
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
