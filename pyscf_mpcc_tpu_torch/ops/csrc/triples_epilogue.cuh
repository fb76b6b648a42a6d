// Device code shared by the two CCSD(T) tile kernels (triples_combine.cu,
// triples_resident.cu): the w2 dots that one (a, b, c) cell subtracts from
// its W, and the occupied-orbit V / Z / energy phase.
//
// One block owns one cell.  Its W (o^3 values, canonical (i, j, k) order)
// lives in shared memory with padded strides, so that a warp writing along
// any one canonical axis hits 32 different banks.  The inputs of the cell's
// six joint (abc)/(ijk) permutations q (PERMS order) are given as pointers;
// for perm q the tile roles are x = p0, y = p1, z = p2 and the source
// occupied indices (i', j', k') land at canonical slots (p0, p1, p2).

#pragma once

#include <cuda_runtime.h>

namespace triples {

constexpr int kRows = 8;    // w2 rows per thread

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
__host__ __device__ __forceinline__ int perm_id(int a, int b, int c) {
  return 2 * a + (b > c ? 1 : 0);
}

// padded W: element (i, j, k) at i * w_s0(o) + j * w_s1(o) + k
__host__ __device__ __forceinline__ int w_s1(int o) { return o + 1; }
__host__ __device__ __forceinline__ int w_s0(int o) { return o * (o + 1) + 1; }
__host__ __device__ __forceinline__ long long w_elems(int o) {
  return (long long)o * w_s0(o);
}

// canonical W stride of the source occupied index that lands at slot s
__device__ __forceinline__ int slot_stride(int s, int o) {
  return s == 0 ? w_s0(o) : s == 1 ? w_s1(o) : 1;
}

// the epilogue inputs of one cell, per perm q
template <typename T>
struct CellPtrs {
  const T* vooo[6];  // (o*o, o) rows [(i', j'), m] = (i' x | j' m)
  const T* t2zy[6];  // (o, o) [m, k'] = t2[k', m, z, y]
  const T* oovv[6];  // (o, o) [i', j'] = (i' x | j' y)
  const T* t2yx[6];  // (o, o) [i', j'] = t2[j', i', y, x]
  const T* t1z[6];   // (o,) t1[k', z]
  const T* fvoz[6];  // (o,) fvo[z, k']
};

// copy the six t2zy blocks of the w2 dots into shared memory (6 * o * o)
template <typename T>
__device__ void stage_t2zy(const CellPtrs<T>& c, T* t2s, int o) {
  const int oo = o * o;
  for (int e = threadIdx.x; e < 6 * oo; e += blockDim.x)
    t2s[e] = c.t2zy[e / oo][e % oo];
}

// W -= sum_q P_q w2_q with w2_q[i',j',k'] = sum_m vooo[(i',j'), m] t2zy[m, k'],
// one perm per pass (each pass writes every element once, at permuted
// positions, so passes are separated by a barrier).  t2s holds the staged
// blocks (stage_t2zy, followed by a barrier).
template <typename T>
__device__ void subtract_w2(const CellPtrs<T>& c, const T* t2s, T* Wsm,
                            int o) {
  const int oo = o * o;
#pragma unroll 1
  for (int q = 0; q < 6; ++q) {
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const int si = slot_stride(p0, o), sj = slot_stride(p1, o),
              sk = slot_stride(p2, o);
    // thread (grp, k1) computes kRows consecutive rows (i1 j1) of column
    // k1: the lanes of a warp share the rows, so each vooo load is a
    // broadcast, and 16-byte loads bring several m at once
    const T* vq = c.vooo[q];
    const T* tq = t2s + q * oo;
    const bool vec = o % Vec<T>::n == 0
        && (reinterpret_cast<unsigned long long>(vq) & 15) == 0;
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
          for (int u = 0; u < Vec<T>::n; ++u) tv[u] = tq[(m0 + u) * o + k1];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            T vv[Vec<T>::n];
            *reinterpret_cast<V*>(vv) = __ldg(
                reinterpret_cast<const V*>(vq + (row0 + r) * o + m0));
#pragma unroll
            for (int u = 0; u < Vec<T>::n; ++u) acc[r] += vv[u] * tv[u];
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

// Sum over this thread's occupied orbits {sigma(i,j,k)}, i >= j >= k
// (orbits orb0, orb0 + ostride, ...), of W * Z / (e_ijk - e_abc) [* mask].
// The energy needs V only at the six permutations of (i, j, k), and e_ijk
// and the occupied mask are symmetric under them, so one thread adds the
// V term to the orbit's six W values in registers.  wval(oc) returns W at
// canonical (oc[0], oc[1], oc[2]).
template <typename T, typename WFn>
__device__ double orbit_energy(const CellPtrs<T>& c, const T* eijk,
                               const T* actocc, int act_mode, T eabc, T af,
                               int o, int orb0, int ostride, WFn wval) {
  double acc = 0.0;
  const int norb = o * (o + 1) * (o + 2) / 6;
  for (int orb = orb0; orb < norb; orb += ostride) {
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
      const T W = wval(oc);
      T vt = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        int p0, p1, p2;
        perm_of(q, p0, p1, p2);
        const int ij = oc[p0] * o + oc[p1], k1 = oc[p2];
        vt += T(0.5) * (__ldg(c.oovv[q] + ij) * __ldg(c.t1z[q] + k1)
                        + __ldg(c.t2yx[q] + ij) * __ldg(c.fvoz[q] + k1));
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
      T zd = Z / (__ldg(eijk + eidx) - eabc);
      if (act_mode) {
        const T act6 = af * __ldg(actocc + eidx);
        zd *= (act_mode == 1) ? T(1) - act6 : act6;
      }
      acc += (double)(Wv[s] * zd);
    }
  }
  return acc;
}

// deterministic block sum; the result is valid in thread 0
__device__ __forceinline__ double block_sum(double acc) {
  __shared__ double red[32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

}  // namespace triples
