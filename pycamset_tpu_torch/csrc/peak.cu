// FP32 FMA peak probe for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of benchmarks/peak.py (vpu_peak): every
// element x of the input starts four independent chains c_k = 0.5 x + 0.1 k,
// and each iteration runs four dependent FMAs on each chain with the
// constants of the TPU kernel, which keep the values near a fixed point (no
// overflow, no denormals); the output is c_0 + c_1 + c_2 + c_3. 16 FMAs =
// 32 FLOP per element per iteration.
//
// What bounds it on an H100: operations, by design. At the probe's size
// (4,194,304 elements x 1024 iterations = 137 GFLOP) it reads and writes
// 33.5 MB, 10 us at 3.35 TB/s, against 2.05 ms at the published
// 67 TFLOP/s. One thread per element; its four chains give each thread
// four independent FMAs in flight, and the element count fills every SM
// with many waves of full-occupancy blocks, so the FMA pipes, not the FMA
// latency, set the rate. Plain FP32 FMAs (fmaf) on the CUDA cores.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) fma_chain_kernel(
    const float *__restrict__ a, float *__restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i];
  float c0 = x * 0.5f, c1 = fmaf(x, 0.5f, 0.1f), c2 = fmaf(x, 0.5f, 0.2f),
        c3 = fmaf(x, 0.5f, 0.3f);
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#define PCT_CHAIN(v)                  \
  v = fmaf(v, 0.999999f, 0.0001f);    \
  v = fmaf(v, 1.000001f, -0.0001f);   \
  v = fmaf(v, 0.999998f, 0.0001f);    \
  v = fmaf(v, 1.000002f, -0.0001f);
    PCT_CHAIN(c0) PCT_CHAIN(c1) PCT_CHAIN(c2) PCT_CHAIN(c3)
#undef PCT_CHAIN
  }
  out[i] = c0 + c1 + c2 + c3;
}

}  // namespace

extern "C" {

// a (n,) -> out (n,) after `iters` iterations of the four chains.
int pct_fma_chain(const float *a, float *out, int n, int iters,
                  void *stream) {
  if (n > 0) {
    fma_chain_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        a, out, n, iters);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
