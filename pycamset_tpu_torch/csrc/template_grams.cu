// Template-chain gram kernels for Hopper (sm_90a), float32, plain C interface.
//
// Replaces two Pallas TPU kernels of pycamset_tpu/optim/pallas_grams.py:
//
//   Kernel A  gram_kernel<false>   <- template_gram_pallas (_gram_kernel_body)
//       per (camera, image) block: the extended gram [J | r]^T [J | r]
//       (22 x 22) of the K key residuals, the corner holding the (robust)
//       cost.
//   Kernel B  gram_kernel<true> + cam_reduce_kernel
//                                  <- make_pallas_template_grams_fused
//                                     (_fused_template_body)
//       the same per-key rows, but only the per-block pose pieces (wci,
//       gii, gi, cost corner) are written per block; the camera pieces
//       (hcc, gc) are summed over each camera's images.
//
// Both share the projection core of the JAX package's _projection_columns
// (projection_core.cuh; standard model, intr_w 9): Xw = Rp Xt + tp,
// Xc = Re Xw + te, Brown 5-coefficient distortion, closed-form 2 x 21
// Jacobian, IRLS weights of the four losses under component or observation
// semantics.
//
// What bounds them on an H100: not device memory. Per block they read
// 2K + K floats of measurements and mask and write 484 (A) or 133 (B)
// floats, a few MB per call at the bench shapes; the work is the 253
// upper-triangle dot products of length 2K per block, ~194 kFLOP per block
// at K = 384, and the shared-memory reads that feed them (two operands per
// FMA). The design keeps everything of one block on one SM: one thread
// per key computes its two weighted rows into a shared-memory tile of 128
// keys (23.5 KB, so several blocks stay resident per SM), then each thread
// accumulates two of the 253 gram entries over the tile in registers, in a
// fixed order. Kernel B walks a chunk of one camera's images inside the
// block (the TPU carried hcc/gc across its sequential grid instead; Hopper
// blocks run in no order), so hcc/gc stay in registers across the chunk,
// and a second pass adds the chunks of a camera in a fixed order: no float
// atomics, so every run gives the same bits. Kernel B needs no padding of
// the image axis. The TPU's structural-zero bookkeeping (_zmul/_zpair) and
// its tile-16 padding are not carried over.
//
// Each launcher runs on the given stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

#include "projection_core.cuh"

namespace {

using namespace pct_core;

constexpr int TK = 128;            // keys per tile = threads per block
constexpr int N_CAM = 135;         // hcc upper triangle (120) + gc (15)

// Kernel A (FUSED = false): one thread block per (camera, image) block,
// writes the symmetric (22, 22) extended gram to out_gram.
// Kernel B (FUSED = true): grid (chunks, cameras); a thread block walks
// `chunk` consecutive images of one camera, writes the per-block pose
// pieces and leaves the chunk's hcc/gc partial sums in cam_part.
template <bool FUSED>
__global__ void __launch_bounds__(TK)
gram_kernel(const float *__restrict__ packed, const float *__restrict__ tpl,
            const float *__restrict__ uv, const float *__restrict__ mask,
            int n_ims, int n_keys, int loss, int component,
            float c2, int chunk, float *__restrict__ out_gram,
            float *__restrict__ wci, float *__restrict__ gii,
            float *__restrict__ gi, float *__restrict__ corner,
            float *__restrict__ cam_part) {
  __shared__ float prm[PPB];
  __shared__ float rows[2 * TK * ROW];
  const int t = threadIdx.x;

  // the two gram entries this thread accumulates: (oi, oj) is the output
  // position, (ci, cj) the tile columns read (the corner reads the cost
  // column); an entry past 253 reads column 0 and is never written
  int oi[2], oj[2], ci[2], cj[2];
  bool valid[2];
  #pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int e = t + q * TK;
    valid[q] = e < N_ENTRIES;
    if (valid[q]) {
      entry_ij(e, oi[q], oj[q]);
    } else {
      oi[q] = oj[q] = 0;
    }
    const bool is_corner = oi[q] == W - 1 && oj[q] == W - 1;
    ci[q] = is_corner ? ROW - 1 : oi[q];
    cj[q] = is_corner ? ROW - 1 : oj[q];
  }

  int blk0, n_blk, cam = 0, n_chunks = 1;
  if (FUSED) {
    cam = blockIdx.y;
    n_chunks = gridDim.x;
    const int im0 = blockIdx.x * chunk;
    blk0 = cam * n_ims + im0;
    n_blk = min(chunk, n_ims - im0);
  } else {
    blk0 = blockIdx.x;
    n_blk = 1;
  }

  float acc0 = 0.f, acc1 = 0.f;
  for (int bi = 0; bi < n_blk; ++bi) {
    const int blk = blk0 + bi;
    __syncthreads();
    if (t < PPB) prm[t] = packed[(size_t)blk * PPB + t];
    __syncthreads();
    for (int k0 = 0; k0 < n_keys; k0 += TK) {
      const int k = k0 + t;
      float *ru_row = rows + (2 * t) * ROW;
      float *rv_row = ru_row + ROW;
      if (k < n_keys) {
        const size_t s = (size_t)blk * n_keys + k;
        const float2 m_uv = reinterpret_cast<const float2 *>(uv)[s];
        key_rows(prm, tpl[3 * k], tpl[3 * k + 1], tpl[3 * k + 2], m_uv.x,
                 m_uv.y, mask[s], loss, component, c2, ru_row, rv_row);
      } else {
        for (int c = 0; c < ROW; ++c) {
          ru_row[c] = 0.f;
          rv_row[c] = 0.f;
        }
      }
      __syncthreads();
      const int n_rows = 2 * min(TK, n_keys - k0);
      const int i0 = ci[0], j0 = cj[0], i1 = ci[1], j1 = cj[1];
      for (int r = 0; r < n_rows; ++r) {
        const float *row = rows + r * ROW;
        acc0 = fmaf(row[i0], row[j0], acc0);
        acc1 = fmaf(row[i1], row[j1], acc1);
      }
      __syncthreads();
    }

    float acc[2] = {acc0, acc1};
    #pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!valid[q]) continue;
      const int i = oi[q], j = oj[q];
      if (!FUSED) {
        out_gram[((size_t)blk * W + i) * W + j] = acc[q];
        out_gram[((size_t)blk * W + j) * W + i] = acc[q];
        acc[q] = 0.f;
      } else if (j >= A) {  // per-block pose pieces; hcc and gc keep summing
        if (i < A && j < W - 1) {
          wci[((size_t)blk * A + i) * 6 + (j - A)] = acc[q];
          acc[q] = 0.f;
        } else if (i >= A && j < W - 1) {
          gii[((size_t)blk * 6 + (i - A)) * 6 + (j - A)] = acc[q];
          gii[((size_t)blk * 6 + (j - A)) * 6 + (i - A)] = acc[q];
          acc[q] = 0.f;
        } else if (i >= A && i < W - 1) {
          gi[(size_t)blk * 6 + (i - A)] = acc[q];
          acc[q] = 0.f;
        } else if (i == W - 1) {
          corner[blk] = acc[q];
          acc[q] = 0.f;
        }
      }
    }
    acc0 = acc[0];
    acc1 = acc[1];
  }

  if (FUSED) {
    float acc[2] = {acc0, acc1};
    #pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = oi[q], j = oj[q];
      if (!valid[q] || i >= A) continue;
      int slot;
      if (j < A) {
        slot = i * A - i * (i - 1) / 2 + (j - i);  // upper triangle of 15
      } else if (j == W - 1) {
        slot = 120 + i;
      } else {
        continue;  // wci: written per block above
      }
      cam_part[((size_t)cam * n_chunks + blockIdx.x) * N_CAM + slot] = acc[q];
    }
  }
}

// Kernel B, second pass: add each camera's chunk partials in chunk order.
__global__ void cam_reduce_kernel(const float *__restrict__ cam_part,
                                  int n_chunks, float *__restrict__ hcc,
                                  float *__restrict__ gc) {
  const int cam = blockIdx.x, s = threadIdx.x;
  if (s >= N_CAM) return;
  float acc = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch)
    acc += cam_part[((size_t)cam * n_chunks + ch) * N_CAM + s];
  if (s >= 120) {
    gc[cam * A + (s - 120)] = acc;
    return;
  }
  int i = 0, e = s;
  while (e >= A - i) {
    e -= A - i;
    ++i;
  }
  const int j = i + e;
  hcc[(cam * A + i) * A + j] = acc;
  hcc[(cam * A + j) * A + i] = acc;
}

}  // namespace

extern "C" {

// Kernel A. packed (B, 96), tpl (K, 3), uv (B, K, 2), mask (B, K) ->
// out (B, 22, 22).
int pct_template_gram(const float *packed, const float *tpl, const float *uv,
                      const float *mask, float *out, int n_blocks, int n_keys,
                      int loss, int component, float f_scale, void *stream) {
  if (n_blocks > 0) {
    gram_kernel<false><<<n_blocks, TK, 0, (cudaStream_t)stream>>>(
        packed, tpl, uv, mask, 1, n_keys, loss, component,
        f_scale * f_scale, 1, out, nullptr, nullptr, nullptr, nullptr,
        nullptr);
  }
  return (int)cudaGetLastError();
}

// Kernel B. Same inputs over B = n_cams * n_ims camera-major blocks ->
// hcc (C, 15, 15), gc (C, 15), wci (B, 15, 6), gii (B, 6, 6), gi (B, 6),
// corner (B,); cam_part is (C, ceil(n_ims / chunk), 135) scratch.
int pct_template_gram_fused(const float *packed, const float *tpl,
                            const float *uv, const float *mask, int n_cams,
                            int n_ims, int n_keys, int loss, int component,
                            float f_scale, int chunk, float *hcc, float *gc,
                            float *wci, float *gii, float *gi, float *corner,
                            float *cam_part, void *stream) {
  if (n_cams > 0 && n_ims > 0) {
    const int n_chunks = (n_ims + chunk - 1) / chunk;
    const dim3 grid(n_chunks, n_cams);
    gram_kernel<true><<<grid, TK, 0, (cudaStream_t)stream>>>(
        packed, tpl, uv, mask, n_ims, n_keys, loss,
        component, f_scale * f_scale, chunk, nullptr, wci, gii, gi, corner,
        cam_part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cam_reduce_kernel<<<n_cams, 160, 0, (cudaStream_t)stream>>>(
        cam_part, n_chunks, hcc, gc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
