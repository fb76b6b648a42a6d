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
// values per tile (403 MB in fp32 at the bench shape o=32, T=8, 0.12 ms at
// 3.35 TB/s), then the in-kernel w2 dots, 6 o^4 multiply-adds per cell
// (3.2e9 per tile, 0.10 ms at the 67 TFLOP/s of FFMA or of DMMA).  The design keeps W and V out of
// device memory: one block per (tile, a, b, c) cell builds the cell's W
// (o^3 values) in shared memory, and the cell's share of every w1 stream
// is contiguous: o planes of o^2 values of an ov_first stream (one per
// source i'), one o^3 block of a t2_first stream, and the canonical k
// index is minor in every W_PLAN layout.  So each thread sums the six
// streams for 4 consecutive k (fp32; 2 in fp64) with one 16-byte load
// each, a warp's loads covering contiguous runs, and stores W once: no
// barrier inside, many loads in flight.  (On the card this read the
// streams about twice as fast as a ring of stages filled by bulk copies on
// the TMA engine: PERF.md, section 6.)
// The w2 dots (GEMMs on the fp64 tensor cores) and the orbit phase (one
// thread per occupied orbit from a host-built table, its V-term inputs
// staged in shared memory where they fit) are the device code of
// triples_epilogue.cuh, shared with the resident kernel.  Each block
// writes one partial energy: no atomics, so the sum is deterministic; the
// host wrapper adds the partials in fp64.
//
// Forms by nocc (the scratch beside W has at least 6 o^2 values; see
// triples_combine_v_staged):
//   staged, V-term inputs in shared memory   fp32 up to o = 34, fp64 26
//   staged, V-term inputs from device memory fp32 35-36, fp64 27-28
//   unstaged    beyond: W does not fit in shared memory; each orbit thread
//       computes its six W values itself, reading w1 and vooo directly
//       against the six t2 blocks in shared memory, and the orbits of a
//       cell may be split over several blocks.
// Where o is not a multiple of the 16-byte vector, the W build loads one
// value at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "triples_epilogue.cuh"

namespace {

using triples::CellPtrs;
using triples::kSmemDynMax;
using triples::perm_of;

constexpr int kThreads = triples::kEpiThreads;

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
  const int* orbits; // (norb,) occupied orbits r0 | r1 << 8 | r2 << 16
  const int* gabc;   // (K,3,T) global virtual indices
  const T* evt;      // (K,3,T) virtual orbital energies
  const T* actv;     // (K,3,T) active-virtual flags, or null
  const T* actocc;   // (o,o,o) active-occupied products, or null
  int act_mode;      // 0 none, 1 exclude_active, 2 only_active
  int nt;            // tile edge T
  int o;             // occupied count
  int nsplit;        // blocks per cell (1 when staged)
  long long scratch; // shared-memory bytes beside W (staged form)
  double* out;       // (K,T,T,T,nsplit) partial energies
  long long* prof;   // (K,T,T,T,kProfSlots) phase clocks (profile form)
};

// scratch beside W in the staged form: at least 6 o^2 values and the
// smallest w2 staging; as much as the w2 buffer and the V-term staging
// want where W leaves room
__host__ __device__ inline long long scratch_bytes(int o, int itemsize) {
  const long long chunk = (long long)o * o * itemsize;
  const triples::W2Plan small = triples::w2_plan(o, itemsize, 0);
  const long long w2min = small.b_bytes + 64LL * small.kd * itemsize;
  const long long floor = 6 * chunk > w2min ? 6 * chunk : w2min;
  long long want = triples::w2_bytes_wanted(o, itemsize);
  const long long v = triples::vstage_elems(o) * itemsize;
  want = want > v ? want : v;
  const long long cap = kSmemDynMax - triples::w_bytes(o, itemsize);
  want = want < cap ? want : cap;
  return ((want > floor ? want : floor) + 15) / 16 * 16;
}

// dynamic shared memory of the staged form (over kSmemDynMax: unstaged)
__host__ __device__ inline long long staged_bytes(int o, int itemsize) {
  return triples::w_bytes(o, itemsize) + scratch_bytes(o, itemsize);
}

// Profile form: thread 0 writes the SM clocks of each phase of its cell to
// prof[cell][phase] (a barrier first, so the phase has ended in every
// warp), and the cell's total to the last slot.
enum Phase { kSetup, kWBuild, kW2, kVStage, kOrbit, kSum, kProfSlots = 7 };

template <bool kProf>
struct Stamp {
  long long* p;
  long long t0, t;
  __device__ explicit Stamp(long long* prof) : p(prof), t0(0), t(0) {
    if (kProf) t0 = t = clock64();
  }
  __device__ void operator()(int phase) {
    if (!kProf) return;
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      p[phase] = now - t;
      p[kProfSlots - 1] = now - t0;
      t = now;
    }
  }
};

// W = sum_q P_q w1_q from the six streams, each thread its NV consecutive
// canonical k of (i, j) at a time: the k index is minor in every stream,
// so each of the six loads is one NV-vector, and a warp's loads cover
// contiguous runs; no barrier inside.  Element (i, j, k) of stream q is at
// wbase[q] + k plus i T o^2 + j o (q = 0, 1), j T o^2 + i o (q = 2, 3),
// (i o + j) o (q = 4, 5).
template <typename T, int NV>
__device__ void build_w_direct(const T* const* src, const long long* wbase,
                               T* Wsm, int o, int nt) {
  using V = typename triples::Vec<T>::type;
  const int oo = o * o, ng = o / NV;
  const int S0 = triples::w_s0(o), S1 = triples::w_s1(o);
  const long long too = (long long)nt * oo;
  const T* base[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) base[q] = src[q] + wbase[q];
  for (int e = threadIdx.x; e < oo * ng; e += blockDim.x) {
    const int ij = e / ng, k = (e - ij * ng) * NV;
    const int i = ij / o, j = ij - i * o;
    const long long off[3] = {i * too + j * o + k, j * too + i * o + k,
                              (long long)ij * o + k};
    T x[6][NV];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const T* p = base[q] + off[q >> 1];
      if constexpr (NV == 1)
        x[q][0] = __ldg(p);
      else
        *reinterpret_cast<V*>(x[q]) = __ldg(reinterpret_cast<const V*>(p));
    }
    T* w = Wsm + i * S0 + j * S1 + k;
#pragma unroll
    for (int u = 0; u < NV; ++u)
      w[u] = ((x[0][u] + x[1][u]) + (x[2][u] + x[3][u]))
             + (x[4][u] + x[5][u]);
  }
}

template <typename T, bool kStaged, bool kProf>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int nt = a.nt, o = a.o, oo = o * o;
  const int cell = blockIdx.x;
  const int split = blockIdx.y;
  const int C = cell % nt;
  const int B = (cell / nt) % nt;
  const int A = (cell / (nt * nt)) % nt;
  const long long k = cell / (nt * nt * nt);
  double* out = a.out + (long long)cell * a.nsplit + split;
  Stamp<kProf> stamp(kProf ? a.prof + (long long)cell * kProfSlots
                           : nullptr);

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
  const int norb = o * (o + 1) * (o + 2) / 6;

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
  stamp(kSetup);

  double acc;
  if constexpr (kStaged) {
    T* Wsm = reinterpret_cast<T*>(smem_raw);
    unsigned char* scratch = smem_raw + triples::w_bytes(o, sizeof(T));
    constexpr int VN = triples::Vec<T>::n;
    bool vec = o % VN == 0;
#pragma unroll
    for (int q = 0; q < 6; ++q) vec = vec && triples::aligned16(a.w[q]);
    if (vec)
      build_w_direct<T, VN>(a.w, wbase, Wsm, o, nt);
    else
      build_w_direct<T, 1>(a.w, wbase, Wsm, o, nt);
    __syncthreads();
    stamp(kWBuild);
    // W -= sum_p P_p w2_p (GEMMs on the fp64 tensor cores)
    triples::subtract_w2(cp, Wsm, scratch, a.scratch, o);
    stamp(kW2);
    const int S1 = triples::w_s1(o), S0 = triples::w_s0(o);
    auto wval = [&](const int* oc) -> T {
      return Wsm[oc[0] * S0 + oc[1] * S1 + oc[2]];
    };
    T* vs = reinterpret_cast<T*>(scratch);
    if (triples::vstage_elems(o) * (long long)sizeof(T) <= a.scratch) {
      triples::stage_vterms(cp, vs, o);
      __syncthreads();
      stamp(kVStage);
      acc = triples::orbit_energy<T, true>(
          cp, vs, a.orbits, norb, a.eijk, a.actocc, a.act_mode, eabc, af, o,
          threadIdx.x, blockDim.x, wval);
    } else {
      acc = triples::orbit_energy<T, false>(
          cp, vs, a.orbits, norb, a.eijk, a.actocc, a.act_mode, eabc, af, o,
          threadIdx.x, blockDim.x, wval);
    }
  } else {
    // stage t2p[p2, p1, z, y, :, :] (= t2[n, m, z, y]) for the w2 dots
    T* t2s = reinterpret_cast<T*>(smem_raw);   // 6 blocks of o*o
    for (int e = threadIdx.x; e < 6 * oo; e += blockDim.x)
      t2s[e] = cp.t2zy[e / oo][e % oo];
    __syncthreads();
    // each W value where it is needed: its six w1 reads and six w2 dots
    // (each a row of vooo against a staged column)
    auto wval = [&](const int* oc) -> T {
      T W = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        int p0, p1, p2;
        perm_of(q, p0, p1, p2);
        const int i1 = oc[p0], j1 = oc[p1], k1 = oc[p2];
        // W_PLAN: even perms pair (j,k), odd perms (k,j)
        const int P1 = (q & 1) ? k1 : j1, P2 = (q & 1) ? j1 : k1;
        W += __ldg(a.w[q] + wbase[q]
                   + ((q < 4) ? (long long)i1 * nt * oo + P1 * o + P2
                              : (long long)(P1 * o + P2) * o + i1));
        const T* vr = cp.vooo[q] + (i1 * o + j1) * o;
        const T* tc = t2s + q * oo + k1;
        T w2 = T(0);
        for (int m = 0; m < o; ++m) w2 += __ldg(vr + m) * tc[m * o];
        W -= w2;
      }
      return W;
    };
    acc = triples::orbit_energy<T, false>(
        cp, nullptr, a.orbits, norb, a.eijk, a.actocc, a.act_mode, eabc, af,
        o, split * blockDim.x + threadIdx.x, a.nsplit * blockDim.x, wval);
  }
  stamp(kOrbit);
  const double t = triples::block_sum(acc);
  if (threadIdx.x == 0) *out = t * wgt;
  stamp(kSum);
}

template <typename T>
int launch(int K, int nt, int o, int nsplit, int staged,
           const void* const* w, const void* vooo, const void* t2p,
           const void* oovv, const void* t1, const void* fvo,
           const void* eijk, const void* orbits, const void* gabc,
           const void* evt, const void* actv, const void* actocc,
           int act_mode, void* out, void* prof, void* stream) {
  Args<T> a;
  for (int q = 0; q < 6; ++q) a.w[q] = static_cast<const T*>(w[q]);
  a.vooo = static_cast<const T*>(vooo);
  a.t2p = static_cast<const T*>(t2p);
  a.oovv = static_cast<const T*>(oovv);
  a.t1 = static_cast<const T*>(t1);
  a.fvo = static_cast<const T*>(fvo);
  a.eijk = static_cast<const T*>(eijk);
  a.orbits = static_cast<const int*>(orbits);
  a.gabc = static_cast<const int*>(gabc);
  a.evt = static_cast<const T*>(evt);
  a.actv = static_cast<const T*>(actv);
  a.actocc = static_cast<const T*>(actocc);
  a.act_mode = act_mode;
  a.nt = nt;
  a.o = o;
  a.nsplit = staged ? 1 : nsplit;
  a.scratch = staged ? scratch_bytes(o, sizeof(T)) : 0;
  a.out = static_cast<double*>(out);
  a.prof = static_cast<long long*>(prof);
  // staged: W in shared memory, one block per cell; the caller checks
  // that it fits (triples_combine_staged_bytes)
  const long long smem = staged ? staged_bytes(o, sizeof(T))
                                : 6LL * o * o * sizeof(T);
  // the profile form stamps the phases of one block a cell: staged only
  if (smem > kSmemDynMax || (prof && !staged))
    return (int)cudaErrorInvalidValue;
  auto kern = prof ? combine_kernel<T, true, true>
                   : (staged ? combine_kernel<T, true, false>
                             : combine_kernel<T, false, false>);
  // always: the static shared memory (wbase, cp) counts against the
  // 48 KB default too, so the unstaged form's 6 o^2 fp64 values at o = 32,
  // exactly 48 KB, fail to launch without the attribute
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(K * nt * nt * nt), (unsigned)a.nsplit);
  kern<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int triples_combine_threads() { return kThreads; }

// dynamic shared-memory bytes of the staged form for nocc = o (over
// triples_combine_smem_max(): the unstaged form runs)
long long triples_combine_staged_bytes(int o, int itemsize) {
  return staged_bytes(o, itemsize);
}
long long triples_combine_smem_max() { return kSmemDynMax; }

// whether the staged form reads the V-term inputs from shared memory
int triples_combine_v_staged(int o, int itemsize) {
  return triples::vstage_elems(o) * itemsize <= scratch_bytes(o, itemsize);
}

// orbits: the (o (o+1) (o+2) / 6,) int32 occupied-orbit table
#define COMBINE_ARGS                                                        \
  int K, int nt, int o, int nsplit, int staged, const void* const* w,      \
      const void* vooo, const void* t2p, const void* oovv, const void* t1, \
      const void* fvo, const void* eijk, const void* orbits,               \
      const void* gabc, const void* evt, const void* actv,                 \
      const void* actocc, int act_mode, void* out
#define COMBINE_PASS                                                        \
  K, nt, o, nsplit, staged, w, vooo, t2p, oovv, t1, fvo, eijk, orbits,     \
      gabc, evt, actv, actocc, act_mode, out

int triples_combine_f32(COMBINE_ARGS, void* stream) {
  return launch<float>(COMBINE_PASS, nullptr, stream);
}
int triples_combine_f64(COMBINE_ARGS, void* stream) {
  return launch<double>(COMBINE_PASS, nullptr, stream);
}

// the profile form, a measurement aid that no engine calls: prof is
// (K,T,T,T,7) int64 zeros that receive each cell's SM clocks per phase
// (enum Phase) and in all (last slot); staged form only, where one block
// owns a cell
int triples_combine_profile_f32(COMBINE_ARGS, void* prof, void* stream) {
  return launch<float>(COMBINE_PASS, prof, stream);
}
int triples_combine_profile_f64(COMBINE_ARGS, void* prof, void* stream) {
  return launch<double>(COMBINE_PASS, prof, stream);
}

#undef COMBINE_ARGS
#undef COMBINE_PASS

}  // extern "C"
