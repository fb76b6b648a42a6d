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
// at 3.35 TB/s).  Design: one block per (a, b) pair stages the o rows
// w[a, i, b, :] (o^3 fp32, 128 KB at o = 32) in dynamic shared memory with
// coalesced 16-byte loads, then writes out[a, b] (contiguous) with
// coalesced 16-byte stores along k, reading shared memory at row i; a
// quarter-warp reads 32 consecutive words, so no bank conflicts.  At
// T = 8 that is 64 blocks, fewer than the card's 132 SMs.
//
// The C entry returns cudaGetLastError() after its launch; the wrapper in
// pyscf_mpcc_tpu_torch/tools/slab_loop_probe.py raises unless it is 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
slab_kernel(const float* __restrict__ w, float* __restrict__ out, int nt,
            int o) {
  extern __shared__ float4 s4[];
  const int a = blockIdx.x / nt, b = blockIdx.x % nt;
  const int oo = o * o, n4 = o * oo / 4, row4 = oo / 4;
  for (int e = threadIdx.x; e < n4; e += blockDim.x) {
    const int i = e / row4, c = e - i * row4;
    const float4* src = reinterpret_cast<const float4*>(
        w + ((long long)(a * o + i) * nt + b) * oo);
    s4[e] = __ldg(src + c);
  }
  __syncthreads();
  float4* dst =
      reinterpret_cast<float4*>(out + (long long)blockIdx.x * o * oo);
  for (int e = threadIdx.x; e < n4; e += blockDim.x) {
    const int f = 4 * e;
    const int j = f / oo, i = (f / o) % o, k = f % o;
    dst[e] = s4[(i * oo + j * o + k) / 4];
  }
}

}  // namespace

extern "C" {

// w (nt, o, nt, o*o) and out (nt, nt, o, o, o), fp32, o a multiple of 4;
// o^3 fp32 of dynamic shared memory a block
int slab_relayout(const void* w, void* out, int nt, int o, void* stream) {
  const int smem = o * o * o * 4;
  cudaError_t err = cudaFuncSetAttribute(
      slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<<<nt * nt, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), nt, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
