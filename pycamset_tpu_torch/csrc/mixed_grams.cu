// Multi-target gram kernels for Hopper (sm_90a), float32, plain C
// interface. The chains put a per-GROUP SE(3) between the image pose and the
// point: Xc = Re (Rp (Rg Xp + tg) + tp) + te. The key axis carries cw
// columns in chain order [group rotation 3 | group translation 3 | point 3]:
// cw = 9 for the mixed chain (free points, GroupRigidTform3d + FreePoint),
// cw = 6 for the grouped template chain (GroupTemplatePoints, the point
// from the template). The group pose is expanded per key (one-hot), so a
// key's group columns are per-key columns here; the reduction to per-group
// blocks is the caller's.
//
// Replaces two Pallas TPU kernels of pycamset_tpu/optim/pallas_grams.py:
//
//   Kernel E  mixed_kernel<CW, true> + mixed_reduce_kernel<CW, true>
//                 <- make_pallas_mixed_grams_fused (_fused_mixed_body)
//       per camera: hcc, gc and the key couplings wcc = Jc^T Jk (15 cw x K),
//       summed over the camera's images; per block: wic = Ji^T Jk
//       (6 cw x K), wci, gii, gi and the cost corner; per key: hkk = Jk^T Jk
//       and gk = Jk^T r over all blocks.
//   Kernel F  mixed_kernel<CW, false> + mixed_reduce_kernel<CW, false>
//                 <- _mixed_grams_factory (_mixed_kernel_body)
//       per block: the extended 22 x 22 gram [Jc | Ji | r]^T [Jc | Ji | r]
//       (corner = the (robust) cost); per (block, key): wcc_b (15 cw) and
//       wic_b (6 cw); per key: hkk and gk over all blocks.
//
// Both mask every camera column by cmask, every pose column by imask and
// key column j by kmask[:, j] in the kernel, as the Pallas kernels do. The
// projection core is the one of Kernels A-D (projection_core.cuh), fed the
// per-key pre-transformed point Xg = Rg Xp + tg; it also hands back the
// weighted d(u, v)/dXc rows, and with g = (Re Rp)^T d(u, v)/dXc each key
// column is g . dir_j, dir_j being its direction in the group's output
// frame: dRg[j] Xp (rotation), e_j (translation), Rg e_j (point), each
// scaled by the key mask and staged once per key in shared memory.
//
// Design. Kernel C's (selfcal_grams.cu): grid (key tiles of 128, chunks of
// `chunk` blocks, groups x slices), one thread per key, the two weighted
// rows of each key in a shared tile, a fixed-order second pass over
// partials, no float atomics (the same bits on every run), any n_ims and K,
// no padding. What is new is register pressure: at cw = 9 one thread would
// hold 135 wcc, 45 hkk and 9 gk sums, past the 255 registers with the
// projection core live. So the c-axis is split over the grid's z dimension
// into its 3-wide column triples (3 slices at cw = 9, 2 at cw = 6). Each
// slice recomputes the projection core of its keys and keeps the 45 wcc
// sums of its triple, its share of the cw (cw + 1) / 2 + cw hkk/gk sums
// (18 or 14) and one of the 253 gram entries per thread (the entries are
// dealt out over the slices). The slice is a template argument, so every
// register array is indexed at compile time.
//
// What bounds them on an H100: device memory. Kernel E at 16 x 100 writes
// wic (B x 54 x K floats, 133 MB at K = 384); Kernel F at 64 x 12 writes
// wcc_b (159 MB) and wic_b (64 MB). The per-key outputs are written as
// (block, entry, key) rows, consecutive threads on consecutive keys, so
// every store is coalesced.
//
// Each launcher runs on the given stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

#include "projection_core.cuh"

namespace {

using namespace pct_core;

constexpr int TK = 128;        // keys per tile = threads per block
constexpr int RT = 256;        // threads per block of the second pass
// per-key group data (pack_key_group_data, the JAX layout), (KD_ROWS, K)
constexpr int KD_XG = 0, KD_RG = 3, KD_DRG = 12, KD_XP = 39;

template <int CW>
struct Mix {
  static constexpr int NT = CW / 3;                 // column triples
  static constexpr int NCC = A * CW;                // wcc entries per key
  static constexpr int NIC = 6 * CW;                // wic entries per key
  static constexpr int NTRI = CW * (CW + 1) / 2;    // hkk upper triangle
  static constexpr int NHK = NTRI + CW;             // + gk
  static constexpr int NH = (NHK + NT - 1) / NT;    // hk sums per slice
  static constexpr int NKS = 3 + 3 * CW;            // staged floats per key
};

// Gram entry (i, j) that Kernel E sums over a camera's images: hcc or gc.
__device__ __forceinline__ bool cam_entry(int i, int j) {
  return i < A && (j < A || j == W - 1);
}

// The first pass for column triple S. Shared memory comes from the kernel
// (a device function's own __shared__ arrays would be allocated once per
// instantiation). blk_part (tiles, B, 253): per-block gram entries of one
// key tile. Kernel E only: cam_part (C, chunks, tiles, 253) holds the
// chunk's hcc/gc entries and wcc_out the chunk's wcc sums (C, chunks,
// 15 cw, K); for Kernel F, wcc_out is wcc_b (B, 15 cw, K). wic_out
// (B, 6 cw, K). hk_part (groups * chunks, NHK, K): the chunk's hkk/gk sums.
template <int CW, bool FUSED, int S>
__device__ __forceinline__ void mixed_slice(
    float *prm, float *colm, float *rows, float *kds,
    const float *__restrict__ packed, const float *__restrict__ kd,
    const float *__restrict__ uv, const float *__restrict__ mask,
    const float *__restrict__ cmask, const float *__restrict__ imask,
    const float *__restrict__ kmask, int grp, int n_groups, int group,
    int n_keys, int loss, int component, float c2, int chunk,
    float *__restrict__ blk_part, float *__restrict__ cam_part,
    float *__restrict__ wcc_out, float *__restrict__ wic_out,
    float *__restrict__ hk_part) {
  using M = Mix<CW>;
  const int t = threadIdx.x;
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int ch = blockIdx.y, n_chunks = gridDim.y;
  const int n_blocks = n_groups * group;
  const int first = ch * chunk;
  const int blk0 = grp * group + first;
  const int n_blk = min(chunk, group - first);
  const int k = tile * TK + t;
  const bool has_key = k < n_keys;
  const size_t part = (size_t)grp * n_chunks + ch;

  // the gram entry this thread accumulates (entries dealt out over the
  // slices); (ci, cj) the tile columns it reads, the corner the cost column
  const int e = t * M::NT + S;
  int i0 = 0, j0 = 0;
  const bool valid = e < N_ENTRIES;
  if (valid) entry_ij(e, i0, j0);
  const bool to_cam = FUSED && valid && cam_entry(i0, j0);
  const bool to_blk = valid && !to_cam;
  const bool is_corner = i0 == W - 1 && j0 == W - 1;
  const int ci = is_corner ? ROW - 1 : i0, cj = is_corner ? ROW - 1 : j0;

  // stage the key's point Xg and its cw column directions (times kmask)
  float *ks = kds + t;   // this thread's column: ks[r * TK]
  if (has_key) {
    float xp[3], rg[9];
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      ks[a * TK] = kd[(size_t)(KD_XG + a) * n_keys + k];
      xp[a] = kd[(size_t)(KD_XP + a) * n_keys + k];
    }
    #pragma unroll
    for (int a = 0; a < 9; ++a) rg[a] = kd[(size_t)(KD_RG + a) * n_keys + k];
    #pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float km = kmask[(size_t)k * CW + j];
      #pragma unroll
      for (int a = 0; a < 3; ++a) {
        float d;
        if (j < 3) {  // rotation: dRg[j] Xp
          const size_t r0 = KD_DRG + 9 * j + 3 * a;
          d = kd[r0 * n_keys + k] * xp[0] + kd[(r0 + 1) * n_keys + k] * xp[1] +
              kd[(r0 + 2) * n_keys + k] * xp[2];
        } else if (j < 6) {  // translation: e_j
          d = (a == j - 3) ? 1.f : 0.f;
        } else {  // point: Rg e_j
          d = rg[3 * a + (j - 6)];
        }
        ks[(3 + 3 * j + a) * TK] = d * km;
      }
    }
  }

  float acc = 0.f;
  float wcc_acc[FUSED ? 3 * A : 1];
  float hk_acc[M::NH];
  #pragma unroll
  for (int q = 0; q < (FUSED ? 3 * A : 1); ++q) wcc_acc[q] = 0.f;
  #pragma unroll
  for (int h = 0; h < M::NH; ++h) hk_acc[h] = 0.f;

  for (int bi = 0; bi < n_blk; ++bi) {
    const int blk = blk0 + bi;
    __syncthreads();
    if (t < PPB) {
      prm[t] = packed[(size_t)blk * PPB + t];
    } else if (t < PPB + W - 1) {
      const int c = t - PPB;
      colm[c] = c < A ? cmask[(size_t)blk * A + c]
                      : imask[(size_t)blk * 6 + (c - A)];
    }
    __syncthreads();

    if (has_key) {
      float *ru = rows + (2 * t) * ROW;
      float *rv = ru + ROW;
      const size_t s = (size_t)blk * n_keys + k;
      const float2 m_uv = reinterpret_cast<const float2 *>(uv)[s];
      float dxu[3], dxv[3];
      key_rows<false, true>(prm, ks[0], ks[TK], ks[2 * TK], m_uv.x, m_uv.y,
                            mask[s], loss, component, c2, ru, rv, nullptr,
                            nullptr, nullptr, dxu, dxv);
      #pragma unroll
      for (int c = 0; c < W - 1; ++c) {
        ru[c] *= colm[c];
        rv[c] *= colm[c];
      }
      // g = (Re Rp)^T d(u, v)/dXc, then each key column is g . dir_j
      const float *rerp = prm + OFF_RERP;
      float gu[3], gv[3];
      #pragma unroll
      for (int b = 0; b < 3; ++b) {
        gu[b] = dxu[0] * rerp[b] + dxu[1] * rerp[3 + b] + dxu[2] * rerp[6 + b];
        gv[b] = dxv[0] * rerp[b] + dxv[1] * rerp[3 + b] + dxv[2] * rerp[6 + b];
      }
      float jcu[CW], jcv[CW];
      #pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float d0 = ks[(3 + 3 * j) * TK], d1 = ks[(4 + 3 * j) * TK],
                    d2 = ks[(5 + 3 * j) * TK];
        jcu[j] = gu[0] * d0 + gu[1] * d1 + gu[2] * d2;
        jcv[j] = gv[0] * d0 + gv[1] * d1 + gv[2] * d2;
      }
      // per-key products of this slice's column triple
      #pragma unroll
      for (int i = 0; i < 6; ++i) {
        #pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          const int col = 3 * S + jj;
          wic_out[((size_t)blk * M::NIC + i * CW + col) * n_keys + k] =
              ru[A + i] * jcu[col] + rv[A + i] * jcv[col];
        }
      }
      #pragma unroll
      for (int i = 0; i < A; ++i) {
        #pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          const int col = 3 * S + jj;
          const float w = ru[i] * jcu[col] + rv[i] * jcv[col];
          if constexpr (FUSED) {
            wcc_acc[3 * i + jj] += w;
          } else {
            wcc_out[((size_t)blk * M::NCC + i * CW + col) * n_keys + k] = w;
          }
        }
      }
      // this slice's share of the hkk upper triangle, then of gk
      int hh = 0;
      #pragma unroll
      for (int p = 0; p < CW; ++p) {
        #pragma unroll
        for (int q = p; q < CW; ++q, ++hh) {
          if (hh >= S * M::NH && hh < (S + 1) * M::NH)
            hk_acc[hh - S * M::NH] += jcu[p] * jcu[q] + jcv[p] * jcv[q];
        }
      }
      #pragma unroll
      for (int p = 0; p < CW; ++p, ++hh) {
        if (hh >= S * M::NH && hh < (S + 1) * M::NH)
          hk_acc[hh - S * M::NH] += jcu[p] * ru[W - 1] + jcv[p] * rv[W - 1];
      }
    }
    __syncthreads();

    const int n_rows = 2 * min(TK, n_keys - tile * TK);
    for (int r = 0; r < n_rows; ++r) {
      const float *row = rows + r * ROW;
      acc = fmaf(row[ci], row[cj], acc);
    }
    // this tile's per-block entry; Kernel E's hcc/gc entries keep summing
    if (to_blk) {
      blk_part[((size_t)tile * n_blocks + blk) * N_ENTRIES + e] = acc;
      acc = 0.f;
    }
  }

  if constexpr (FUSED) {
    if (to_cam) cam_part[(part * n_tiles + tile) * N_ENTRIES + e] = acc;
    if (has_key) {
      #pragma unroll
      for (int i = 0; i < A; ++i) {
        #pragma unroll
        for (int jj = 0; jj < 3; ++jj)
          wcc_out[(part * M::NCC + i * CW + 3 * S + jj) * n_keys + k] =
              wcc_acc[3 * i + jj];
      }
    }
  }
  if (has_key) {
    #pragma unroll
    for (int h = 0; h < M::NH; ++h) {
      const int hh = S * M::NH + h;
      if (hh < M::NHK) hk_part[(part * M::NHK + hh) * n_keys + k] = hk_acc[h];
    }
  }
}

template <int CW, bool FUSED>
__global__ void __launch_bounds__(TK)
mixed_kernel(const float *__restrict__ packed, const float *__restrict__ kd,
             const float *__restrict__ uv, const float *__restrict__ mask,
             const float *__restrict__ cmask,
             const float *__restrict__ imask,
             const float *__restrict__ kmask, int group, int n_keys,
             int loss, int component, float c2, int chunk,
             float *__restrict__ blk_part, float *__restrict__ cam_part,
             float *__restrict__ wcc_out, float *__restrict__ wic_out,
             float *__restrict__ hk_part) {
  using M = Mix<CW>;
  __shared__ float prm[PPB];
  __shared__ float colm[W - 1];   // the block's 21 column masks
  __shared__ float rows[2 * TK * ROW];
  __shared__ float kds[M::NKS * TK];
  const int n_groups = gridDim.z / M::NT;
  const int grp = blockIdx.z / M::NT, slice = blockIdx.z % M::NT;
#define PCT_MIXED_SLICE(S)                                                  \
  mixed_slice<CW, FUSED, S>(prm, colm, rows, kds, packed, kd, uv, mask,     \
                            cmask, imask, kmask, grp, n_groups, group,      \
                            n_keys, loss, component, c2, chunk, blk_part,   \
                            cam_part, wcc_out, wic_out, hk_part)
  if (slice == 0) {
    PCT_MIXED_SLICE(0);
  } else if (slice == 1) {
    PCT_MIXED_SLICE(1);
  } else if constexpr (M::NT > 2) {
    PCT_MIXED_SLICE(2);
  }
#undef PCT_MIXED_SLICE
}

// Second pass: add the first pass's partials in a fixed order. One launch;
// a thread block's role follows from its index: first the B blocks (their
// gram entries over key tiles), then, for Kernel E, the C cameras (hcc, gc
// over chunks and key tiles) and the wcc entries (over chunks), last the
// hkk/gk entries (over every chunk of every group).
template <int CW, bool FUSED>
__global__ void __launch_bounds__(RT)
mixed_reduce_kernel(const float *__restrict__ blk_part,
                    const float *__restrict__ cam_part,
                    const float *__restrict__ wcc_part,
                    const float *__restrict__ hk_part, int n_blocks,
                    int n_cams, int n_tiles, int n_chunks, int n_keys,
                    float *__restrict__ gram, float *__restrict__ hcc,
                    float *__restrict__ gc, float *__restrict__ wcc,
                    float *__restrict__ wci, float *__restrict__ gii,
                    float *__restrict__ gi, float *__restrict__ corner,
                    float *__restrict__ hkk, float *__restrict__ gk) {
  using M = Mix<CW>;
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
    const size_t per_cam = (size_t)M::NCC * n_keys;
    const long long n_wcc = ((long long)n_cams * per_cam + RT - 1) / RT;
    if (b < n_wcc) {
      const size_t idx = (size_t)b * RT + t;
      if (idx >= n_cams * per_cam) return;
      const size_t c = idx / per_cam, rest = idx % per_cam;
      float acc = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch)
        acc += wcc_part[(c * n_chunks + ch) * per_cam + rest];
      wcc[idx] = acc;
      return;
    }
    b -= n_wcc;
  }
  const long long idx = b * RT + t;
  if (idx >= (long long)M::NHK * n_keys) return;
  const int s = (int)(idx / n_keys), k = (int)(idx % n_keys);
  const int n_parts = (FUSED ? n_cams : 1) * n_chunks;
  float acc = 0.f;
  for (int g = 0; g < n_parts; ++g)
    acc += hk_part[((size_t)g * M::NHK + s) * n_keys + k];
  if (s >= M::NTRI) {
    gk[(size_t)k * CW + (s - M::NTRI)] = acc;
    return;
  }
  int p, q;   // s -> (p, q), p <= q, row-major over the upper triangle
  p = 0;
  q = s;
  while (q >= CW - p) {
    q -= CW - p;
    ++p;
  }
  q += p;
  hkk[((size_t)k * CW + p) * CW + q] = acc;
  hkk[((size_t)k * CW + q) * CW + p] = acc;
}

template <int CW>
int launch_mixed(const float *packed, const float *kd, const float *uv,
                 const float *mask, const float *cmask, const float *imask,
                 const float *kmask, int n_blocks, int n_keys, int loss,
                 int component, float f_scale, int chunk, float *gram,
                 float *wcc, float *wic, float *hkk, float *gk,
                 float *blk_part, float *hk_part, cudaStream_t st) {
  using M = Mix<CW>;
  const int n_tiles = (n_keys + TK - 1) / TK;
  const int n_chunks = (n_blocks + chunk - 1) / chunk;
  mixed_kernel<CW, false><<<dim3(n_tiles, n_chunks, M::NT), TK, 0, st>>>(
      packed, kd, uv, mask, cmask, imask, kmask, n_blocks, n_keys, loss,
      component, f_scale * f_scale, chunk, blk_part, nullptr, wcc, wic,
      hk_part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_red = n_blocks + (M::NHK * n_keys + RT - 1) / RT;
  mixed_reduce_kernel<CW, false><<<n_red, RT, 0, st>>>(
      blk_part, nullptr, nullptr, hk_part, n_blocks, 1, n_tiles, n_chunks,
      n_keys, gram, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, hkk, gk);
  return (int)cudaGetLastError();
}

template <int CW>
int launch_mixed_fused(const float *packed, const float *kd, const float *uv,
                       const float *mask, const float *cmask,
                       const float *imask, const float *kmask, int n_cams,
                       int n_ims, int n_keys, int loss, int component,
                       float f_scale, int chunk, float *hcc, float *gc,
                       float *wcc, float *wic, float *wci, float *gii,
                       float *gi, float *corner, float *hkk, float *gk,
                       float *blk_part, float *cam_part, float *wcc_part,
                       float *hk_part, cudaStream_t st) {
  using M = Mix<CW>;
  const int n_tiles = (n_keys + TK - 1) / TK;
  const int n_chunks = (n_ims + chunk - 1) / chunk;
  mixed_kernel<CW, true>
      <<<dim3(n_tiles, n_chunks, n_cams * M::NT), TK, 0, st>>>(
          packed, kd, uv, mask, cmask, imask, kmask, n_ims, n_keys, loss,
          component, f_scale * f_scale, chunk, blk_part, cam_part, wcc_part,
          wic, hk_part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = n_cams * n_ims;
  const long long n_red = (long long)n_blocks + n_cams +
                          ((long long)n_cams * M::NCC * n_keys + RT - 1) / RT +
                          (M::NHK * n_keys + RT - 1) / RT;
  mixed_reduce_kernel<CW, true><<<(unsigned)n_red, RT, 0, st>>>(
      blk_part, cam_part, wcc_part, hk_part, n_blocks, n_cams, n_tiles,
      n_chunks, n_keys, nullptr, hcc, gc, wcc, wci, gii, gi, corner, hkk, gk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel F. packed (B, 96), kd (48, K), uv (B, K, 2), mask (B, K),
// cmask (B, 15), imask (B, 6), kmask (K, cw), cw in {6, 9} -> gram
// (B, 22, 22), wcc (B, 15 cw, K), wic (B, 6 cw, K), hkk (K, cw, cw),
// gk (K, cw). Scratch: blk_part (ceil(K / 128), B, 253), hk_part
// (ceil(B / chunk), cw (cw + 1) / 2 + cw, K).
int pct_mixed_gram(const float *packed, const float *kd, const float *uv,
                   const float *mask, const float *cmask, const float *imask,
                   const float *kmask, int cw, int n_blocks, int n_keys,
                   int loss, int component, float f_scale, int chunk,
                   float *gram, float *wcc, float *wic, float *hkk, float *gk,
                   float *blk_part, float *hk_part, void *stream) {
  if (n_blocks <= 0 || n_keys <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (cw == 9)
    return launch_mixed<9>(packed, kd, uv, mask, cmask, imask, kmask,
                           n_blocks, n_keys, loss, component, f_scale, chunk,
                           gram, wcc, wic, hkk, gk, blk_part, hk_part, st);
  if (cw == 6)
    return launch_mixed<6>(packed, kd, uv, mask, cmask, imask, kmask,
                           n_blocks, n_keys, loss, component, f_scale, chunk,
                           gram, wcc, wic, hkk, gk, blk_part, hk_part, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel E. Same inputs over B = n_cams * n_ims camera-major blocks ->
// hcc (C, 15, 15), gc (C, 15), wcc (C, 15 cw, K), wic (B, 6 cw, K),
// wci (B, 15, 6), gii (B, 6, 6), gi (B, 6), corner (B,), hkk (K, cw, cw),
// gk (K, cw). Scratch: blk_part (ceil(K / 128), B, 253), cam_part
// (C, ceil(n_ims / chunk), ceil(K / 128), 253), wcc_part
// (C, ceil(n_ims / chunk), 15 cw, K), hk_part
// (C * ceil(n_ims / chunk), cw (cw + 1) / 2 + cw, K).
int pct_mixed_gram_fused(const float *packed, const float *kd,
                         const float *uv, const float *mask,
                         const float *cmask, const float *imask,
                         const float *kmask, int cw, int n_cams, int n_ims,
                         int n_keys, int loss, int component, float f_scale,
                         int chunk, float *hcc, float *gc, float *wcc,
                         float *wic, float *wci, float *gii, float *gi,
                         float *corner, float *hkk, float *gk,
                         float *blk_part, float *cam_part, float *wcc_part,
                         float *hk_part, void *stream) {
  if (n_cams <= 0 || n_ims <= 0 || n_keys <= 0)
    return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (cw == 9)
    return launch_mixed_fused<9>(packed, kd, uv, mask, cmask, imask, kmask,
                                 n_cams, n_ims, n_keys, loss, component,
                                 f_scale, chunk, hcc, gc, wcc, wic, wci, gii,
                                 gi, corner, hkk, gk, blk_part, cam_part,
                                 wcc_part, hk_part, st);
  if (cw == 6)
    return launch_mixed_fused<6>(packed, kd, uv, mask, cmask, imask, kmask,
                                 n_cams, n_ims, n_keys, loss, component,
                                 f_scale, chunk, hcc, gc, wcc, wic, wci, gii,
                                 gi, corner, hkk, gk, blk_part, cam_part,
                                 wcc_part, hk_part, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
