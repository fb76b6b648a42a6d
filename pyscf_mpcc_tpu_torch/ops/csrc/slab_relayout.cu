// Slab relayout of the resident (T) design, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/slab_loop_probe.py (kern :23, called at
// :39), which checked that Mosaic could run the relayout of a W block
//
//   out[a, b, j, i, k] = w[a, i, b, j o + k],   w (T, o, T, o^2),
//   out (T, T, o, o, o),
//
// as a rolled loop over j.  Here it is the relayout itself.  Bound: bytes,
// each value read once and written once (16.8 MB at o = 32, T = 8: 5.0 us
// at 3.35 TB/s).  Design: a row gather.  Output row (a, b, j, i) of o
// values is the contiguous input run w[a, i, b, j o : (j + 1) o], so the
// relayout moves T^2 o^2 rows with no shared memory and no barrier: o / 4
// consecutive lanes move one row with a 16-byte load and a 16-byte store,
// a thread keeps kPieces such pieces in flight (all loads, then all
// stores), and block x moves the consecutive 16-byte pieces x kThreads
// kPieces .. of the output, so its stores are contiguous.  At o = 32,
// T = 8: 512 blocks of 256 threads, about four an SM.
//
// The C entry returns cudaGetLastError() after its launch; the wrapper in
// pyscf_mpcc_tpu_torch/tools/slab_loop_probe.py raises unless it is 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPieces = 4;          // 16-byte pieces in flight a thread

// piece e of the output: row e / (o/4) = ((a nt + b) o + j) o + i, piece
// e % (o/4) of it, read from row ((a o + i) nt + b) o + j of w viewed as
// rows of o values
__device__ __forceinline__ unsigned src_piece(unsigned e, unsigned nt,
                                              unsigned o) {
  const unsigned q4 = o / 4;
  const unsigned row = e / q4, q = e - row * q4;
  const unsigned i = row % o, r = row / o;
  const unsigned j = r % o, ab = r / o;
  const unsigned b = ab % nt, a = ab / nt;
  return (((a * o + i) * nt + b) * o + j) * q4 + q;
}

__global__ void __launch_bounds__(kThreads)
slab_kernel(const float4* __restrict__ w, float4* __restrict__ out,
            unsigned nt, unsigned o, unsigned n4) {
  const unsigned e0 = blockIdx.x * (kThreads * kPieces) + threadIdx.x;
  float4 v[kPieces];
#pragma unroll
  for (int u = 0; u < kPieces; ++u) {
    const unsigned e = e0 + u * kThreads;
    if (e < n4) v[u] = __ldg(w + src_piece(e, nt, o));
  }
#pragma unroll
  for (int u = 0; u < kPieces; ++u) {
    const unsigned e = e0 + u * kThreads;
    if (e < n4) out[e] = v[u];
  }
}

}  // namespace

extern "C" {

// threads of a block and 16-byte pieces a thread moves (the block covers
// their product of consecutive output pieces)
int slab_relayout_block(int* threads, int* pieces) {
  *threads = kThreads;
  *pieces = kPieces;
  return 0;
}

// w (nt, o, nt, o*o) and out (nt, nt, o, o, o), fp32, 16-byte aligned, o a
// multiple of 4 and nt^2 o^3 / 4 below 2^31
int slab_relayout(const void* w, void* out, int nt, int o, void* stream) {
  if (nt <= 0 || o <= 0 || o % 4) return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)nt * nt * o * o * o / 4;
  if (n4 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kPieces;
  const unsigned nblock = (unsigned)((n4 + per_block - 1) / per_block);
  slab_kernel<<<nblock, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<float4*>(out),
      (unsigned)nt, (unsigned)o, (unsigned)n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
