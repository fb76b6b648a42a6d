// Device code shared by the two CCSD(T) tile kernels (triples_combine.cu,
// triples_resident.cu): the w2 dots that one (a, b, c) cell subtracts from
// its W, and the occupied-orbit V / Z / energy phase.
//
// One block of kEpiThreads threads owns one cell.  Its W (o^3 values,
// canonical (i, j, k) order) lives in shared memory with padded strides, so
// that a warp writing along any one canonical axis hits 32 different
// banks.  Beside W the kernel hands the epilogue a scratch area of shared
// memory (at least 6 o^2 values), free once W is built.  The inputs of the
// cell's six joint (abc)/(ijk) permutations q (PERMS order) are given as
// pointers; for perm q the tile roles are x = p0, y = p1, z = p2 and the
// source occupied indices (i', j', k') land at canonical slots (p0, p1, p2).
//
// w2 (subtract_w2): per perm a GEMM C (o^2 x o) = vooo_q (o^2 x o) .
// t2zy_q (o x o) with K = o, on the fp64 tensor cores (mma.sync m16n8k16
// with fp32 operands widened, m16n8k8 in fp64; never less accurate than
// fp32), each warp a 16 x 32 tile of C in 4 fragments.  The o x o block of
// t2 is staged by the threads in the scratch.  The fragments read vooo
// rows with 16-byte loads straight from device memory (L2) where o is a
// multiple of 4 vectors; otherwise the threads stage chunks of vooo rows
// in the scratch, zero-padded.  The tile is subtracted from W at the
// perm's permuted positions.  (On the card, bench tile, this beat an FFMA
// register tile of 4 x 4 a thread and vooo chunks staged by bulk copies:
// PERF.md, section 6.)
//
// Orbit phase (orbit_energy): the energy needs V only at the six
// permutations of (i, j, k), and e_ijk and the occupied mask are symmetric
// under them, so one thread owns one occupied orbit {sigma(i,j,k)},
// i >= j >= k, read from a table built on the host, and adds the V term to
// its six W values in registers.  The V-term inputs (the oovv and t2yx
// blocks, t1 and fvo rows of the six perms) are staged in the scratch when
// they fit (stage_vterms), else read from device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace triples {

constexpr int kEpiThreads = 512;   // threads of a block of either kernel
// dynamic shared memory a block of either kernel may use: the opt-in cap
// of 232,448 bytes less 1 KB for the static shared memory
constexpr long long kSmemDynMax = 232448 - 1024;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// 16-byte vector of T
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
__host__ __device__ __forceinline__ long long align128(long long b) {
  return (b + 127) & ~127LL;
}
// bytes of the cell's padded W, where the scratch begins
__host__ __device__ __forceinline__ long long w_bytes(int o, int itemsize) {
  return align128(w_elems(o) * itemsize);
}

// canonical W stride of the source occupied index that lands at slot s
__host__ __device__ __forceinline__ int slot_stride(int s, int o) {
  return s == 0 ? w_s0(o) : s == 1 ? w_s1(o) : 1;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
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

// ---------------------------------------------------------------------------
// w2 dots
// ---------------------------------------------------------------------------

// The w2 GEMM's use of a scratch of sbytes.  First the t2 block, doubles
// at row stride bn + 4 / VN (bn: o rounded up to 8), so that the
// fragments' 4 k rows fall in distinct banks, and kd rows (o rounded up to
// 4 vectors of T; lane t of a fragment takes k = k0 + VN t + s at step s
// of a block of 4 VN), zero beyond o.  Then, where the fragments do not
// read vooo from device memory, a buffer of rb vooo rows at row stride kd.
// A warp owns 16 rows and 32 columns of C; ncb warps side by side cover
// the o columns, kEpiThreads / 32 / ncb of them the rows of a pass.
struct W2Plan {
  int kd, bn, ncb, rb;
  long long b_bytes, a_bytes;     // t2 block; vooo buffer
};

__host__ __device__ inline W2Plan w2_plan(int o, int itemsize,
                                          long long sbytes) {
  W2Plan p;
  const int vn = 16 / itemsize;
  p.kd = round_up(o, 4 * vn);
  p.bn = round_up(o, 8);
  p.b_bytes = ((long long)p.kd * (p.bn + 4 / vn) * 8 + 15) / 16 * 16;
  p.ncb = (o + 31) / 32;
  const long long row = (long long)p.kd * itemsize;
  // rows of one pass of all warps, no more than vooo has (rounded to 64,
  // the row block of four warps), fewer where the scratch is short
  int full = kEpiThreads / 32 / p.ncb * 16;
  full = full < round_up(o * o, 64) ? full : round_up(o * o, 64);
  const long long r = (sbytes - p.b_bytes) / row / 64 * 64;
  p.rb = r < full ? (int)r : full;
  p.a_bytes = p.rb * row;
  return p;
}

// the scratch bytes that stage the w2 GEMM with a full vooo buffer
__host__ __device__ inline long long w2_bytes_wanted(int o, int itemsize) {
  const W2Plan p = w2_plan(o, itemsize, 1LL << 40);
  return p.b_bytes + p.a_bytes;
}

// d += a . b on the fp64 tensor cores: A 16 x 8 (row), B 8 x 8 (col);
// lane 4 g + t holds A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] in a0-a3,
// B[t][g], B[t+4][g] in b0-b1 and D[g][2 t + e], D[g+8][2 t + e] in d
__device__ __forceinline__ void dmma_16808(double (&d)[4], double a0,
                                           double a1, double a2, double a3,
                                           double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// the same with K = 16: lane 4 g + t holds A[g + 8 h][t + 4 u] in a[2 u +
// h] and B[t + 4 u][g] in b[u]
__device__ __forceinline__ void dmma_16816(double (&d)[4],
                                           const double (&a)[8],
                                           const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// W -= sum_q P_q w2_q with w2_q[i',j',k'] = sum_m vooo[(i',j'), m]
// t2zy[m, k'].  Chunks of vooo rows run in sequence over the six perms;
// each writes its W elements once, and chunks are separated by a barrier.
// Where kd is o and vooo 16-byte aligned, the fragments read vooo straight
// from device memory (L2: a tile's 24 vooo slices are shared by its
// cells), one chunk a perm; else the threads stage each chunk in the
// scratch, zero beyond o.  scratch: sbytes of shared memory (16-byte
// aligned) that no thread still reads; a barrier precedes the call.
template <typename T>
__device__ void subtract_w2(const CellPtrs<T>& c, T* Wsm,
                            unsigned char* scratch, long long sbytes,
                            int o) {
  constexpr int VN = Vec<T>::n;
  using V = typename Vec<T>::type;
  W2Plan pl = w2_plan(o, sizeof(T), sbytes);
  const int tid = threadIdx.x, oo = o * o;
  const int lane = tid & 31, warp = tid >> 5;
  double* Bd = reinterpret_cast<double*>(scratch);
  T* Abuf = reinterpret_cast<T*>(scratch + pl.b_bytes);
  const int bsd = pl.bn + 4 / VN;
  bool direct = pl.kd == o;
#pragma unroll
  for (int q = 0; q < 6; ++q) direct = direct && aligned16(c.vooo[q]);
  if (direct) pl.rb = oo;                  // one chunk a perm
  const int nch = (oo + pl.rb - 1) / pl.rb, total = 6 * nch;
  const int as = direct ? o : pl.kd;       // row stride of A

  // warp (rw, cb): rows rw * 16 .. + 15 (+ 16 nrw a pass) of a chunk,
  // columns 32 cb .. + 31, as two row tiles of 8 and up to four column
  // tiles of 8
  const int cb = warp % pl.ncb, rw = warp / pl.ncb;
  const int nrw = (int)(blockDim.x >> 5) / pl.ncb;
  const int g = lane >> 2, t = lane & 3;
  const int nct = min(4, (o - 32 * cb + 7) / 8);
#pragma unroll 1
  for (int n = 0; n < total; ++n) {
    const int q = n / nch, r0 = (n - q * nch) * pl.rb;
    const int rows = min(pl.rb, oo - r0);
    const T* A = direct ? c.vooo[q] : Abuf;
    if (r0 == 0) {       // the perm's t2 block, zero beyond o
      const T* tz = c.t2zy[q];
      for (int e = tid; e < pl.kd * bsd; e += blockDim.x) {
        const int m = e / bsd, kk = e - m * bsd;
        Bd[e] = (m < o && kk < o) ? (double)tz[m * o + kk] : 0.0;
      }
    }
    if (!direct) {       // the chunk by the threads, zero beyond o
      const T* v = c.vooo[q] + (long long)r0 * o;
      for (int e = tid; e < rows * pl.kd; e += blockDim.x) {
        const int r = e / pl.kd, m = e - r * pl.kd;
        Abuf[e] = m < o ? v[r * o + m] : T(0);
      }
    }
    __syncthreads();
    int p0, p1, p2;
    perm_of(q, p0, p1, p2);
    const int si = slot_stride(p0, o), sj = slot_stride(p1, o),
              sk = slot_stride(p2, o);
    // warp (rw, cb) holds rows 8 g + mi (mi = 0, 1; the MMA rows g and
    // g + 8) from base rb0 = 64 (rw / 4) + 2 (rw % 4) (+ 16 nrw a pass):
    // with W's strides all 1 mod 32, its 32 lanes then subtract into
    // distinct banks at o = 32.  Lane t takes k = k0 + VN t + u for the
    // MMA's k slot t + 4 u, so one MMA takes a k block from one 16-byte
    // vector of each of its two rows.  The A vectors of the next k block
    // (or of the next row block) load while this one runs.
    const int rbase = 64 * (rw >> 2) + 2 * (rw & 3);
    V n0, n1;
    if (rbase < rows) {
      const T* ap = A + (rbase + 8 * g) * as + VN * t;
      n0 = *reinterpret_cast<const V*>(ap);
      n1 = *reinterpret_cast<const V*>(ap + as);
    }
    const double* bp = Bd + VN * t * bsd + 32 * cb + g;
    for (int rb0 = rbase; rb0 < rows; rb0 += nrw * 16) {
      double acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
      const T* ap = A + (rb0 + 8 * g) * as + VN * t;
#pragma unroll 1
      for (int k0 = 0; k0 < pl.kd; k0 += 4 * VN) {
        T a[2][VN];
        *reinterpret_cast<V*>(a[0]) = n0;
        *reinterpret_cast<V*>(a[1]) = n1;
        const bool more = k0 + 4 * VN < pl.kd;
        if (more || rb0 + nrw * 16 < rows) {
          const T* pn = more ? ap + k0 + 4 * VN : ap + nrw * 16 * as;
          n0 = *reinterpret_cast<const V*>(pn);
          n1 = *reinterpret_cast<const V*>(pn + as);
        }
        const double* br = bp + k0 * bsd;
        if constexpr (VN == 4) {        // one k16 MMA a column tile
          double af[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            af[2 * u] = (double)a[0][u];
            af[2 * u + 1] = (double)a[1][u];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nct) {
              const double bf[4] = {br[8 * j], br[bsd + 8 * j],
                                    br[2 * bsd + 8 * j],
                                    br[3 * bsd + 8 * j]};
              dmma_16816(acc[j], af, bf);
            }
          }
        } else {                        // one k8 MMA a column tile
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nct)
              dmma_16808(acc[j], (double)a[0][0], (double)a[1][0],
                         (double)a[0][1], (double)a[1][1], br[8 * j],
                         br[bsd + 8 * j]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = rb0 + 8 * g + mi;
        if (r >= rows) continue;
        const int row = r0 + r, i1 = row / o, j1 = row - i1 * o;
        T* w = Wsm + i1 * si + j1 * sj;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 32 * cb + 8 * j + 2 * t + e;
            if (j < nct && col < o) w[col * sk] -= (T)acc[j][2 * mi + e];
          }
      }
    }
    __syncthreads();     // chunk n consumed, its W elements written
  }
}

// ---------------------------------------------------------------------------
// orbit phase
// ---------------------------------------------------------------------------

// values of the staged V-term inputs: oovv_q and t2yx_q (12 blocks of o
// rows at stride o + 1, so that a warp gathering along either index of
// the block hits distinct banks), then t1z_q and fvoz_q (12 x o)
__host__ __device__ __forceinline__ long long vstage_elems(int o) {
  return 12LL * o * (o + 1) + 12LL * o;
}

template <typename T>
__device__ void stage_vterms(const CellPtrs<T>& c, T* s, int o) {
  const int oo = o * o, blk = o * (o + 1);
  for (int e = threadIdx.x; e < 12 * oo; e += blockDim.x) {
    const int q = e / oo, r = e - q * oo, i = r / o, j = r - i * o;
    s[q * blk + i * (o + 1) + j] = q < 6 ? c.oovv[q][r] : c.t2yx[q - 6][r];
  }
  for (int e = threadIdx.x; e < 12 * o; e += blockDim.x) {
    const int q = e / o, r = e - q * o;
    s[12 * blk + e] = q < 6 ? c.t1z[q][r] : c.fvoz[q - 6][r];
  }
}

// Sum over this thread's occupied orbits (table entries orb0, orb0 +
// ostride, ...: r0 | r1 << 8 | r2 << 16 with r0 >= r1 >= r2) of
// W * Z / (e_ijk - e_abc) [* mask].  wval(oc) returns W at canonical
// (oc[0], oc[1], oc[2]).  kVStaged: the V-term inputs are in shared memory
// at vs (stage_vterms), else read through c.
template <typename T, bool kVStaged, typename WFn>
__device__ double orbit_energy(const CellPtrs<T>& c, const T* vs,
                               const int* orbits, int norb, const T* eijk,
                               const T* actocc, int act_mode, T eabc, T af,
                               int o, int orb0, int ostride, WFn wval) {
  const int blk = o * (o + 1), rv = 12 * blk;
  double acc = 0.0;
  for (int orb = orb0; orb < norb; orb += ostride) {
    const int code = __ldg(orbits + orb);
    const int r[3] = {code & 255, (code >> 8) & 255, code >> 16};
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
        const int k1 = oc[p2];
        if constexpr (kVStaged) {
          const int ij = oc[p0] * (o + 1) + oc[p1];
          vt += T(0.5) * (vs[q * blk + ij] * vs[rv + q * o + k1]
                          + vs[(6 + q) * blk + ij]
                            * vs[rv + (6 + q) * o + k1]);
        } else {
          const int ij = oc[p0] * o + oc[p1];
          vt += T(0.5) * (__ldg(c.oovv[q] + ij) * __ldg(c.t1z[q] + k1)
                          + __ldg(c.t2yx[q] + ij) * __ldg(c.fvoz[q] + k1));
        }
      }
      Wv[s] = W;
      Vv[s] = W + vt;
    }
    // e_ijk and the mask are symmetric: one load each for the orbit
    const int eidx = (r[0] * o + r[1]) * o + r[2];
    const T den = __ldg(eijk + eidx) - eabc;
    T scale = T(1);
    if (act_mode) {
      const T act6 = af * __ldg(actocc + eidx);
      scale = (act_mode == 1) ? T(1) - act6 : act6;
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
      acc += (double)(Wv[s] * (Z / den * scale));
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
