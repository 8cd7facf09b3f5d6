// Self-calibration gram kernels for Hopper (sm_90a), float32, plain C
// interface. The chain is Projection + Extrinsic3D + RigidTform3d +
// FreePoint: the K target points X are unknowns beside the cameras and the
// poses, Xc = Re (Rp X + tp) + te.
//
// Replaces two Pallas TPU kernels of pycamset_tpu/optim/pallas_grams.py:
//
//   Kernel C  selfcal_kernel<true> + selfcal_reduce_kernel<true>
//                 <- make_pallas_selfcal_grams_fused (_fused_selfcal_body)
//       per camera: hcc, gc and the point couplings wck = Jc^T Jk (K x 45),
//       summed over the camera's images; per block: wik = Ji^T Jk (18 x K),
//       wci, gii, gi and the cost corner; per key: hkk = Jk^T Jk and
//       gk = Jk^T r over all blocks. The pose columns are masked by imask
//       in-kernel; the camera columns are not masked here (the wrapper masks
//       the reduced pieces, as the JAX wrapper does).
//   Kernel D  selfcal_kernel<false> + selfcal_reduce_kernel<false>
//                 <- make_pallas_selfcal_grams (_selfcal_kernel_body)
//       per block: the extended 22 x 22 gram [Jc | Ji | r]^T [Jc | Ji | r]
//       with every camera column masked by cmask and every pose column by
//       imask in-kernel, the corner holding the (robust) cost; per (block,
//       key): wck_b (45) and wik_b (18); per key: hkk and gk over all blocks.
//
// Both use the projection core of the template kernels
// (projection_core.cuh), with the free point in place of the template point
// and its columns Jk = d(u, v)/dXc (Re Rp), masked per key by kmask.
//
// Design. Grid (key tiles, chunks, groups), 128 threads: one thread per key
// of the tile. A thread block walks `chunk` consecutive blocks of one group
// (Kernel C: one camera's images; Kernel D: all blocks form one group). For
// each block, each thread computes its key's two weighted, masked rows into
// a shared-memory tile and the Jk columns in registers. From its own rows
// it forms the per-key products (wik, wck, hkk, gk), which need no other
// thread; then each thread accumulates two of the 253 gram entries over the
// tile's rows, in a fixed order. What sums over the chunk stays in
// registers: Kernel C's wck (45 per thread) and hcc/gc entries, both
// kernels' hkk/gk (9 per thread). The per-block gram entries of a key tile,
// and the per-chunk sums, go to scratch; a second kernel adds them over key
// tiles, chunks and cameras in a fixed order. No float atomics, so every run
// gives the same bits; any n_ims and any K, no padding. The TPU's
// structural-zero bookkeeping (_zmul/_zpair), its tile-8/16 image padding
// and its sequential-grid accumulators are not carried over.
//
// What bounds them on an H100: device memory, nearly. Kernel C at 16 x 100
// writes wik (B x 18 x K floats, 44 MB) and reads uv and mask (7.4 MB); its
// arithmetic, about 1.3 kFLOP per slot, takes a similar time at the card's
// FP32 rate. Kernel D at 64 x 12 writes wck_b and wik_b (74 MB). The
// per-key outputs are written as (block, entry, key) rows, consecutive
// threads on consecutive keys, so every store is coalesced.
//
// Each launcher runs on the given stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

#include "projection_core.cuh"

namespace {

using namespace pct_core;

constexpr int TK = 128;        // keys per tile = threads per block
constexpr int NCK = A * 3;     // wck entries per key (15 x 3)
constexpr int NIK = 6 * 3;     // wik entries per key (6 x 3)
constexpr int NHK = 9;         // hkk upper triangle (6) + gk (3) per key
constexpr int RT = 256;        // threads per block of the second pass

// Gram entry (i, j) that Kernel C sums over a camera's images: hcc or gc.
__device__ __forceinline__ bool cam_entry(int i, int j) {
  return i < A && (j < A || j == W - 1);
}

// First pass. blk_part (tiles, B, 253): per-block gram entries of one key
// tile. Kernel C only: cam_part (C, chunks, tiles, 253) holds the chunk's
// hcc/gc entries and wck_out the chunk's wck sums (C, chunks, 45, K); for
// Kernel D, wck_out is wck_b (B, 45, K). wik_out (B, 18, K). hk_part
// (groups * chunks, 9, K): the chunk's hkk/gk sums.
template <bool FUSED>
__global__ void __launch_bounds__(TK)
selfcal_kernel(const float *__restrict__ packed,
               const float *__restrict__ keyp, const float *__restrict__ uv,
               const float *__restrict__ mask,
               const float *__restrict__ cmask,
               const float *__restrict__ imask,
               const float *__restrict__ kmask, int group, int n_keys,
               int loss, int component, float c2, int chunk,
               float *__restrict__ blk_part, float *__restrict__ cam_part,
               float *__restrict__ wck_out, float *__restrict__ wik_out,
               float *__restrict__ hk_part) {
  __shared__ float prm[PPB];
  __shared__ float colm[W - 1];   // the block's 21 column masks
  __shared__ float rows[2 * TK * ROW];
  const int t = threadIdx.x;
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int ch = blockIdx.y, n_chunks = gridDim.y;
  const int grp = blockIdx.z;
  const int n_blocks = gridDim.z * group;
  const int first = ch * chunk;
  const int blk0 = grp * group + first;
  const int n_blk = min(chunk, group - first);
  const int k = tile * TK + t;
  const bool has_key = k < n_keys;
  const size_t part = (size_t)grp * n_chunks + ch;

  // the two gram entries this thread accumulates: e is the entry, (ci, cj)
  // the tile columns read (the corner reads the cost column)
  int e_of[2], ci[2], cj[2];
  bool to_blk[2], to_cam[2];
  #pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int e = t + q * TK;
    int i = 0, j = 0;
    const bool valid = e < N_ENTRIES;
    if (valid) entry_ij(e, i, j);
    e_of[q] = e;
    to_cam[q] = FUSED && valid && cam_entry(i, j);
    to_blk[q] = valid && !to_cam[q];
    const bool is_corner = i == W - 1 && j == W - 1;
    ci[q] = is_corner ? ROW - 1 : i;
    cj[q] = is_corner ? ROW - 1 : j;
  }

  float pt[3] = {0.f, 0.f, 0.f}, km[3] = {0.f, 0.f, 0.f};
  if (has_key) {
    for (int a = 0; a < 3; ++a) {
      pt[a] = keyp[3 * k + a];
      km[a] = kmask[3 * k + a];
    }
  }

  float acc0 = 0.f, acc1 = 0.f;
  float wck_acc[FUSED ? NCK : 1];
  float hk_acc[NHK];
  #pragma unroll
  for (int e = 0; e < (FUSED ? NCK : 1); ++e) wck_acc[e] = 0.f;
  #pragma unroll
  for (int s = 0; s < NHK; ++s) hk_acc[s] = 0.f;

  for (int bi = 0; bi < n_blk; ++bi) {
    const int blk = blk0 + bi;
    __syncthreads();
    if (t < PPB) {
      prm[t] = packed[(size_t)blk * PPB + t];
    } else if (t < PPB + W - 1) {
      const int c = t - PPB;
      if (c >= A) {
        colm[c] = imask[(size_t)blk * 6 + (c - A)];
      } else {
        colm[c] = FUSED ? 1.f : cmask[(size_t)blk * A + c];
      }
    }
    __syncthreads();

    if (has_key) {
      float *ru = rows + (2 * t) * ROW;
      float *rv = ru + ROW;
      const size_t s = (size_t)blk * n_keys + k;
      const float2 m_uv = reinterpret_cast<const float2 *>(uv)[s];
      float jku[3], jkv[3];
      key_rows<true>(prm, pt[0], pt[1], pt[2], m_uv.x, m_uv.y, mask[s], loss,
                     component, c2, ru, rv, km, jku, jkv);
      #pragma unroll
      for (int c = 0; c < W - 1; ++c) {
        ru[c] *= colm[c];
        rv[c] *= colm[c];
      }
      // per-key products, from this thread's own rows
      #pragma unroll
      for (int i = 0; i < 6; ++i) {
        #pragma unroll
        for (int j = 0; j < 3; ++j)
          wik_out[((size_t)blk * NIK + 3 * i + j) * n_keys + k] =
              ru[A + i] * jku[j] + rv[A + i] * jkv[j];
      }
      #pragma unroll
      for (int i = 0; i < A; ++i) {
        #pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float w = ru[i] * jku[j] + rv[i] * jkv[j];
          if constexpr (FUSED) {
            wck_acc[3 * i + j] += w;
          } else {
            wck_out[((size_t)blk * NCK + 3 * i + j) * n_keys + k] = w;
          }
        }
      }
      hk_acc[0] += jku[0] * jku[0] + jkv[0] * jkv[0];
      hk_acc[1] += jku[0] * jku[1] + jkv[0] * jkv[1];
      hk_acc[2] += jku[0] * jku[2] + jkv[0] * jkv[2];
      hk_acc[3] += jku[1] * jku[1] + jkv[1] * jkv[1];
      hk_acc[4] += jku[1] * jku[2] + jkv[1] * jkv[2];
      hk_acc[5] += jku[2] * jku[2] + jkv[2] * jkv[2];
      #pragma unroll
      for (int p = 0; p < 3; ++p)
        hk_acc[6 + p] += jku[p] * ru[W - 1] + jkv[p] * rv[W - 1];
    }
    __syncthreads();

    const int n_rows = 2 * min(TK, n_keys - tile * TK);
    const int i0 = ci[0], j0 = cj[0], i1 = ci[1], j1 = cj[1];
    for (int r = 0; r < n_rows; ++r) {
      const float *row = rows + r * ROW;
      acc0 = fmaf(row[i0], row[j0], acc0);
      acc1 = fmaf(row[i1], row[j1], acc1);
    }
    // this tile's per-block entries; Kernel C's hcc/gc entries keep summing
    if (to_blk[0]) {
      blk_part[((size_t)tile * n_blocks + blk) * N_ENTRIES + e_of[0]] = acc0;
      acc0 = 0.f;
    }
    if (to_blk[1]) {
      blk_part[((size_t)tile * n_blocks + blk) * N_ENTRIES + e_of[1]] = acc1;
      acc1 = 0.f;
    }
  }

  if constexpr (FUSED) {
    const size_t base = (part * n_tiles + tile) * N_ENTRIES;
    if (to_cam[0]) cam_part[base + e_of[0]] = acc0;
    if (to_cam[1]) cam_part[base + e_of[1]] = acc1;
    if (has_key) {
      #pragma unroll
      for (int e = 0; e < NCK; ++e)
        wck_out[(part * NCK + e) * n_keys + k] = wck_acc[e];
    }
  }
  if (has_key) {
    #pragma unroll
    for (int s = 0; s < NHK; ++s)
      hk_part[(part * NHK + s) * n_keys + k] = hk_acc[s];
  }
}

// Second pass: add the first pass's partials in a fixed order. One launch;
// a thread block's role follows from its index: first the B blocks (their
// gram entries over key tiles), then, for Kernel C, the C cameras (hcc, gc
// over chunks and key tiles) and the wck entries (over chunks), last the
// hkk/gk entries (over every chunk of every group).
template <bool FUSED>
__global__ void __launch_bounds__(RT)
selfcal_reduce_kernel(const float *__restrict__ blk_part,
                      const float *__restrict__ cam_part,
                      const float *__restrict__ wck_part,
                      const float *__restrict__ hk_part, int n_blocks,
                      int n_cams, int n_tiles, int n_chunks, int n_keys,
                      float *__restrict__ gram, float *__restrict__ hcc,
                      float *__restrict__ gc, float *__restrict__ wck,
                      float *__restrict__ wci, float *__restrict__ gii,
                      float *__restrict__ gi, float *__restrict__ corner,
                      float *__restrict__ hkk, float *__restrict__ gk) {
  const int t = threadIdx.x;
  long long b = blockIdx.x;
  if (b < n_blocks) {
    if (t >= N_ENTRIES) return;
    int i, j;
    entry_ij(t, i, j);
    if (FUSED && cam_entry(i, j)) return;
    float acc = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile)
      acc += blk_part[((size_t)tile * n_blocks + b) * N_ENTRIES + t];
    if constexpr (!FUSED) {
      gram[((size_t)b * W + i) * W + j] = acc;
      gram[((size_t)b * W + j) * W + i] = acc;
    } else if (i < A) {
      wci[((size_t)b * A + i) * 6 + (j - A)] = acc;
    } else if (j < W - 1) {
      gii[((size_t)b * 6 + (i - A)) * 6 + (j - A)] = acc;
      gii[((size_t)b * 6 + (j - A)) * 6 + (i - A)] = acc;
    } else if (i < W - 1) {
      gi[(size_t)b * 6 + (i - A)] = acc;
    } else {
      corner[b] = acc;
    }
    return;
  }
  b -= n_blocks;
  if constexpr (FUSED) {
    if (b < n_cams) {
      if (t >= N_ENTRIES) return;
      int i, j;
      entry_ij(t, i, j);
      if (!cam_entry(i, j)) return;
      float acc = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch)
        for (int tile = 0; tile < n_tiles; ++tile)
          acc += cam_part[(((size_t)b * n_chunks + ch) * n_tiles + tile) *
                              N_ENTRIES + t];
      if (j < A) {
        hcc[(b * A + i) * A + j] = acc;
        hcc[(b * A + j) * A + i] = acc;
      } else {
        gc[b * A + i] = acc;
      }
      return;
    }
    b -= n_cams;
    const size_t per_cam = (size_t)NCK * n_keys;
    const long long n_wck = ((long long)n_cams * per_cam + RT - 1) / RT;
    if (b < n_wck) {
      const size_t idx = (size_t)b * RT + t;
      if (idx >= n_cams * per_cam) return;
      const size_t c = idx / per_cam, rest = idx % per_cam;
      float acc = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch)
        acc += wck_part[(c * n_chunks + ch) * per_cam + rest];
      wck[idx] = acc;
      return;
    }
    b -= n_wck;
  }
  const long long idx = b * RT + t;
  if (idx >= (long long)NHK * n_keys) return;
  const int s = (int)(idx / n_keys), k = (int)(idx % n_keys);
  const int n_parts = (FUSED ? n_cams : 1) * n_chunks;
  float acc = 0.f;
  for (int g = 0; g < n_parts; ++g)
    acc += hk_part[((size_t)g * NHK + s) * n_keys + k];
  if (s >= 6) {
    gk[k * 3 + (s - 6)] = acc;
    return;
  }
  // s = 0..5 -> (p, q) = (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
  const int p = s < 3 ? 0 : (s < 5 ? 1 : 2);
  const int q = s < 3 ? s : (s < 5 ? s - 2 : 2);
  hkk[((size_t)k * 3 + p) * 3 + q] = acc;
  hkk[((size_t)k * 3 + q) * 3 + p] = acc;
}

}  // namespace

extern "C" {

// Kernel D. packed (B, 96), keyp (K, 3), uv (B, K, 2), mask (B, K),
// cmask (B, 15), imask (B, 6), kmask (K, 3) -> gram (B, 22, 22),
// wck (B, 45, K), wik (B, 18, K), hkk (K, 3, 3), gk (K, 3). Scratch:
// blk_part (ceil(K / 128), B, 253), hk_part (ceil(B / chunk), 9, K).
int pct_selfcal_gram(const float *packed, const float *keyp, const float *uv,
                     const float *mask, const float *cmask,
                     const float *imask, const float *kmask, int n_blocks,
                     int n_keys, int loss, int component, float f_scale,
                     int chunk, float *gram, float *wck, float *wik,
                     float *hkk, float *gk, float *blk_part, float *hk_part,
                     void *stream) {
  if (n_blocks > 0 && n_keys > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int n_tiles = (n_keys + TK - 1) / TK;
    const int n_chunks = (n_blocks + chunk - 1) / chunk;
    selfcal_kernel<false><<<dim3(n_tiles, n_chunks, 1), TK, 0, st>>>(
        packed, keyp, uv, mask, cmask, imask, kmask, n_blocks, n_keys, loss,
        component, f_scale * f_scale, chunk, blk_part, nullptr, wck, wik,
        hk_part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_red = n_blocks + (NHK * n_keys + RT - 1) / RT;
    selfcal_reduce_kernel<false><<<n_red, RT, 0, st>>>(
        blk_part, nullptr, nullptr, hk_part, n_blocks, 1, n_tiles, n_chunks,
        n_keys, gram, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, hkk, gk);
  }
  return (int)cudaGetLastError();
}

// Kernel C. Same inputs over B = n_cams * n_ims camera-major blocks (no
// cmask) -> hcc (C, 15, 15), gc (C, 15), wck (C, 45, K), wik (B, 18, K),
// wci (B, 15, 6), gii (B, 6, 6), gi (B, 6), corner (B,), hkk (K, 3, 3),
// gk (K, 3). Scratch: blk_part (ceil(K / 128), B, 253), cam_part
// (C, ceil(n_ims / chunk), ceil(K / 128), 253), wck_part
// (C, ceil(n_ims / chunk), 45, K), hk_part (C * ceil(n_ims / chunk), 9, K).
int pct_selfcal_gram_fused(const float *packed, const float *keyp,
                           const float *uv, const float *mask,
                           const float *imask, const float *kmask, int n_cams,
                           int n_ims, int n_keys, int loss, int component,
                           float f_scale, int chunk, float *hcc, float *gc,
                           float *wck, float *wik, float *wci, float *gii,
                           float *gi, float *corner, float *hkk, float *gk,
                           float *blk_part, float *cam_part, float *wck_part,
                           float *hk_part, void *stream) {
  if (n_cams > 0 && n_ims > 0 && n_keys > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int n_tiles = (n_keys + TK - 1) / TK;
    const int n_chunks = (n_ims + chunk - 1) / chunk;
    selfcal_kernel<true><<<dim3(n_tiles, n_chunks, n_cams), TK, 0, st>>>(
        packed, keyp, uv, mask, nullptr, imask, kmask, n_ims, n_keys, loss,
        component, f_scale * f_scale, chunk, blk_part, cam_part, wck_part,
        wik, hk_part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_blocks = n_cams * n_ims;
    const long long n_red =
        (long long)n_blocks + n_cams +
        ((long long)n_cams * NCK * n_keys + RT - 1) / RT +
        (NHK * n_keys + RT - 1) / RT;
    selfcal_reduce_kernel<true><<<(unsigned)n_red, RT, 0, st>>>(
        blk_part, cam_part, wck_part, hk_part, n_blocks, n_cams, n_tiles,
        n_chunks, n_keys, nullptr, hcc, gc, wck, wci, gii, gi, corner, hkk,
        gk);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
