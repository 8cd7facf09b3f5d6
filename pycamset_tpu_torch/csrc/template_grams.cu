// Template-chain gram kernels for Hopper (sm_90a), float32, plain C interface.
//
// Replaces two Pallas TPU kernels of pycamset_tpu/optim/pallas_grams.py:
//
//   Kernel A  gram_kernel<INTR_W, false>
//                                  <- template_gram_pallas (_gram_kernel_body)
//       per (camera, image) block: the extended gram [J | r]^T [J | r]
//       (W x W, W = a + 7: 22 at the standard model) of the K key
//       residuals, the corner holding the (robust) cost.
//   Kernel B  gram_kernel<INTR_W, true> + cam_reduce_kernel<INTR_W>
//                                  <- make_pallas_template_grams_fused
//                                     (_fused_template_body)
//       the same per-key rows, but only the per-block pose pieces (wci,
//       gii, gi, cost corner) are written per block; the camera pieces
//       (hcc, gc) are summed over each camera's images.
//
// Both share the projection core of the JAX package's _projection_columns
// (projection_core.cuh): Xw = Rp Xt + tp, Xc = Re Xw + te, the camera
// model's distortion, closed-form 2 x (a + 6) Jacobian, IRLS weights of the
// four losses under component or observation semantics. They are built at
// the five intrinsic widths the JAX kernels serve: 9 standard (a = 15,
// entries pct_template_gram{,_fused}), 8 fisheye (a = 14), 12 rational
// (18), 16 thin-prism (22) and 18 tilted (24), through
// pct_template_gram{,_fused}_model. The tile geometry follows the width
// (gram_tiles.cuh: 10, 15 or 21 register tiles), the tilted model's 136
// packed parameters take two loads a thread, and the wider models run
// three blocks an SM (Occupancy) where the standard and fisheye ones run
// four.
//
// What bounds them on an H100: not device memory. Per block they read
// 2K + K floats of measurements and mask and write 484 (A) or 133 (B)
// floats, a few MB per call at the bench shapes. The work is the
// projection core once per key and the 253 upper-triangle dot products of
// length 2K per block (the standard model; 496 at the tilted one), ~194
// kFLOP per block at K = 384, in FP32 FMAs on the CUDA cores: instruction
// issue. Feeding the FMAs from shared memory one
// operand at a time (the first port: two loads per FMA) ran at an eighth of
// the FMA rate. With the design below, the products take about half of
// Kernel B's time at the bench's 64 x 400 shape and the projection core
// about a third, and their times add: four resident blocks already keep
// the SM's issue slots busy, so overlapping the two phases inside a block
// (two row tiles, one barrier a tile) made it slower, as did compacting
// the live keys before the core (PERF.md, section 6).
//
// The design: the register-tile gram loop of gram_tiles.cuh. One thread per
// key slot of a tile of NT keys computes the key's two weighted rows straight
// into shared memory; masked slots write no row, so the gram loop runs over
// real detections only (79% of the slots at template 64 x 400). About 70%
// of the tiles' products are needed (the diagonal tiles compute both
// triangles, the cost and zero columns ride along); splitting the tiles by
// shape across warps issued fewer FMAs but ran slower, the loads then
// broadcasting less. Small blocks (NT = 128) at no more than 128 registers
// let four blocks share an SM, so that one block's projection core, a long
// dependent chain, overlaps another's FMA loop. The TPU's structural-zero
// bookkeeping (_zmul/_zpair) is not carried over.
//
// Kernel B walks a chunk of one camera's images inside the block (the TPU
// carried hcc/gc across its sequential grid; Hopper blocks run in no
// order): the entry threads keep hcc/gc summing in registers across the
// chunk, and cam_reduce_kernel adds the chunks of a camera in chunk order.
// Kernel B needs no padding of the image axis.
//
// Each launcher runs on the given stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

#include "gram_tiles.cuh"
#include "projection_core.cuh"

namespace {

using pct_core::Model;
using namespace pct_tiles;

// Four blocks an SM (<= 128 registers) at the standard and narrower
// widths; the wider models' cores hold more live values beside the 36
// accumulators, so they are given more registers and fewer blocks.
template <int INTR_W>
struct Occupancy {
  static constexpr int MIN_BLOCKS = INTR_W <= 9 ? 4 : 3;
};

// hcc's upper triangle + gc: 135 at the standard model
template <int INTR_W>
struct CamEntries {
  static constexpr int A = Model<INTR_W>::A;
  static constexpr int N_HCC = A * (A + 1) / 2;
  static constexpr int N = N_HCC + A;
};

// Kernel A (FUSED = false): one thread block per (camera, image) block,
// writes the symmetric (W, W) extended gram to out_gram.
// Kernel B (FUSED = true): grid (chunks, cameras); a thread block walks
// `chunk` consecutive images of one camera, writes the per-block pose
// pieces and leaves the chunk's hcc/gc partial sums in cam_part.
template <int INTR_W, bool FUSED>
__global__ void __launch_bounds__(NT, Occupancy<INTR_W>::MIN_BLOCKS)
gram_kernel(const float *__restrict__ packed, const float *__restrict__ tpl,
            const float *__restrict__ uv, const float *__restrict__ mask,
            int n_ims, int n_keys, int loss, int component,
            float c2, int chunk, float *__restrict__ out_gram,
            float *__restrict__ wci, float *__restrict__ gii,
            float *__restrict__ gi, float *__restrict__ corner,
            float *__restrict__ cam_part) {
  using M = Model<INTR_W>;
  using T = Tiles<M>;
  constexpr int A = M::A, W = M::W, PPB = M::PPB, N_EPT = T::N_EPT;
  constexpr int N_CAM = CamEntries<INTR_W>::N;
  constexpr int N_HCC = CamEntries<INTR_W>::N_HCC;
  // the row tile (live u rows, then live v rows); at each image's end, the
  // lanes' partial tiles
  __shared__ __align__(16) float rows[T::ROWS_FLOATS];
  __shared__ __align__(16) float prm[PPB];
  __shared__ int live_count[NW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  const TileLane tl = tile_lane<T>(rows, warp, lane);
  const auto er = entry_role<T>(t);

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

  float acc[G * G];
  #pragma unroll
  for (int i = 0; i < G * G; ++i) acc[i] = 0.f;
  float cam_acc[N_EPT];
  #pragma unroll
  for (int k = 0; k < N_EPT; ++k) cam_acc[k] = 0.f;

  // the inputs of this thread's slot of the next tile, loaded a tile ahead,
  // and its parameters of the next image (N_PPT a thread: two at the
  // tilted model's 136)
  int blk = blk0, k = t;
  float m = 0.f, p_next[T::N_PPT];
  float2 m_uv = make_float2(0.f, 0.f);
  float3 pt = make_float3(0.f, 0.f, 0.f);
  auto fetch = [&](int b, int kk) {
    m = 0.f;
    if (kk < n_keys) {
      const size_t s = (size_t)b * n_keys + kk;
      m = mask[s];
      m_uv = reinterpret_cast<const float2 *>(uv)[s];
      pt = make_float3(tpl[3 * kk], tpl[3 * kk + 1], tpl[3 * kk + 2]);
    }
  };
  if (n_keys > 0) fetch(blk, k);
  #pragma unroll
  for (int i = 0; i < T::N_PPT; ++i) {
    p_next[i] = 0.f;
    if (t + i * NT < PPB) p_next[i] = packed[(size_t)blk * PPB + t + i * NT];
  }

  for (int bi = 0; bi < n_blk; ++bi, ++blk) {
    // the previous image's last reader of prm passed two barriers since
    #pragma unroll
    for (int i = 0; i < T::N_PPT; ++i) {
      const int c = t + i * NT;
      if (c < PPB) {
        prm[c] = p_next[i];
        if (bi + 1 < n_blk) p_next[i] = packed[(size_t)(blk + 1) * PPB + c];
      }
    }
    for (int k0 = 0; k0 < n_keys; k0 += NT) {
      const float km = m;
      const float2 kuv = m_uv;
      const float3 kpt = pt;
      k = k0 + NT < n_keys ? k + NT : t;
      if (k0 + NT < n_keys) {
        fetch(blk, k);
      } else if (bi + 1 < n_blk) {
        fetch(blk + 1, k);
      }
      const unsigned live = __ballot_sync(0xffffffffu, km != 0.f);
      if (lane == 0) live_count[warp] = __popc(live);
      __syncthreads();  // counts and prm are in; the last tile is read
      int pos, n_live;
      live_slot(live_count, warp, lane, live, pos, n_live);
      if (km != 0.f) {  // masked slots give no row at all
        // the key's u row at tile row pos, its v row at n_live + pos
        float *ru_row = rows + pos * T::RS;
        float *rv_row = rows + (n_live + pos) * T::RS;
        pct_core::key_rows_m<M>(prm, kpt.x, kpt.y, kpt.z, kuv.x, kuv.y, km,
                                loss, component, c2, ru_row, rv_row);
        #pragma unroll
        for (int c = M::ROW; c < T::RC; ++c) {
          ru_row[c] = 0.f;
          rv_row[c] = 0.f;
        }
      }
      __syncthreads();  // the live rows are in
      if (tl.on) tile_rows<T>(acc, tl, 2 * n_live);
    }

    __syncthreads();  // every lane is done with the rows
    if (tl.on) tile_store(acc, tl);
    __syncthreads();  // the partials are in
    #pragma unroll
    for (int kq = 0; kq < N_EPT; ++kq) {
      if (!er.valid[kq]) continue;
      const float sum = entry_sum<T>(rows, er.src[kq]);
      const int i = er.oi[kq], j = er.oj[kq];
      if (!FUSED) {
        out_gram[((size_t)blk * W + i) * W + j] = sum;
        out_gram[((size_t)blk * W + j) * W + i] = sum;
      } else if (i < A && (j < A || j == W - 1)) {
        cam_acc[kq] += sum;  // hcc and gc keep summing over the chunk
      } else if (i < A && j < W - 1) {
        wci[((size_t)blk * A + i) * 6 + (j - A)] = sum;
      } else if (i < W - 1 && j < W - 1) {
        gii[((size_t)blk * 6 + (i - A)) * 6 + (j - A)] = sum;
        gii[((size_t)blk * 6 + (j - A)) * 6 + (i - A)] = sum;
      } else if (i < W - 1) {
        gi[(size_t)blk * 6 + (i - A)] = sum;
      } else {
        corner[blk] = sum;
      }
    }
    // the next image's rows and counts are written only after its first
    // barrier, which every entry thread reaches after its reads above
  }

  if (FUSED) {
    #pragma unroll
    for (int kq = 0; kq < N_EPT; ++kq) {
      const int i = er.oi[kq], j = er.oj[kq];
      if (!er.valid[kq] || i >= A) continue;
      int slot;
      if (j < A) {
        slot = i * A - i * (i - 1) / 2 + (j - i);  // upper triangle of A
      } else if (j == W - 1) {
        slot = N_HCC + i;
      } else {
        continue;  // wci: written per block above
      }
      cam_part[((size_t)cam * n_chunks + blockIdx.x) * N_CAM + slot] =
          cam_acc[kq];
    }
  }
}

// Kernel B, second pass: add each camera's chunk partials in chunk order.
template <int INTR_W>
__global__ void cam_reduce_kernel(const float *__restrict__ cam_part,
                                  int n_chunks, float *__restrict__ hcc,
                                  float *__restrict__ gc) {
  constexpr int A = CamEntries<INTR_W>::A, N_CAM = CamEntries<INTR_W>::N;
  constexpr int N_HCC = CamEntries<INTR_W>::N_HCC;
  const int cam = blockIdx.x, s = threadIdx.x;
  if (s >= N_CAM) return;
  float acc = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch)
    acc += cam_part[((size_t)cam * n_chunks + ch) * N_CAM + s];
  if (s >= N_HCC) {
    gc[cam * A + (s - N_HCC)] = acc;
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

template <int INTR_W>
int launch_gram(const float *packed, const float *tpl, const float *uv,
                const float *mask, float *out, int n_blocks, int n_keys,
                int loss, int component, float f_scale, void *stream) {
  if (n_blocks > 0) {
    gram_kernel<INTR_W, false><<<n_blocks, NT, 0, (cudaStream_t)stream>>>(
        packed, tpl, uv, mask, 1, n_keys, loss, component,
        f_scale * f_scale, 1, out, nullptr, nullptr, nullptr, nullptr,
        nullptr);
  }
  return (int)cudaGetLastError();
}

template <int INTR_W>
int launch_gram_fused(const float *packed, const float *tpl,
                      const float *uv, const float *mask, int n_cams,
                      int n_ims, int n_keys, int loss, int component,
                      float f_scale, int chunk, float *hcc, float *gc,
                      float *wci, float *gii, float *gi, float *corner,
                      float *cam_part, void *stream) {
  if (n_cams > 0 && n_ims > 0) {
    const int n_chunks = (n_ims + chunk - 1) / chunk;
    const dim3 grid(n_chunks, n_cams);
    gram_kernel<INTR_W, true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        packed, tpl, uv, mask, n_ims, n_keys, loss,
        component, f_scale * f_scale, chunk, nullptr, wci, gii, gi, corner,
        cam_part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr int threads = (CamEntries<INTR_W>::N + 31) / 32 * 32;
    cam_reduce_kernel<INTR_W><<<n_cams, threads, 0, (cudaStream_t)stream>>>(
        cam_part, n_chunks, hcc, gc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A, standard model. packed (B, 96), tpl (K, 3), uv (B, K, 2),
// mask (B, K) -> out (B, 22, 22).
int pct_template_gram(const float *packed, const float *tpl, const float *uv,
                      const float *mask, float *out, int n_blocks, int n_keys,
                      int loss, int component, float f_scale, void *stream) {
  return launch_gram<9>(packed, tpl, uv, mask, out, n_blocks, n_keys, loss,
                        component, f_scale, stream);
}

// Kernel B, standard model. Same inputs over B = n_cams * n_ims
// camera-major blocks -> hcc (C, 15, 15), gc (C, 15), wci (B, 15, 6),
// gii (B, 6, 6), gi (B, 6), corner (B,); cam_part is
// (C, ceil(n_ims / chunk), 135) scratch.
int pct_template_gram_fused(const float *packed, const float *tpl,
                            const float *uv, const float *mask, int n_cams,
                            int n_ims, int n_keys, int loss, int component,
                            float f_scale, int chunk, float *hcc, float *gc,
                            float *wci, float *gii, float *gi, float *corner,
                            float *cam_part, void *stream) {
  return launch_gram_fused<9>(packed, tpl, uv, mask, n_cams, n_ims, n_keys,
                              loss, component, f_scale, chunk, hcc, gc, wci,
                              gii, gi, corner, cam_part, stream);
}

// Kernel A at intrinsic width intr_w (8, 9, 12, 16, 18): packed (B, PPB)
// of that width's layout -> out (B, W, W), W = intr_w + 13. Another width
// returns cudaErrorInvalidValue and launches nothing.
int pct_template_gram_model(int intr_w, const float *packed, const float *tpl,
                            const float *uv, const float *mask, float *out,
                            int n_blocks, int n_keys, int loss, int component,
                            float f_scale, void *stream) {
  switch (intr_w) {
#define PCT_CASE(IW)                                                        \
  case IW:                                                                  \
    return launch_gram<IW>(packed, tpl, uv, mask, out, n_blocks, n_keys,    \
                           loss, component, f_scale, stream);
    PCT_CASE(8) PCT_CASE(9) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel B at intrinsic width intr_w, a = intr_w + 6: hcc (C, a, a),
// gc (C, a), wci (B, a, 6), gii, gi, corner as above; cam_part is
// (C, ceil(n_ims / chunk), a (a + 1) / 2 + a) scratch.
int pct_template_gram_fused_model(int intr_w, const float *packed,
                                  const float *tpl, const float *uv,
                                  const float *mask, int n_cams, int n_ims,
                                  int n_keys, int loss, int component,
                                  float f_scale, int chunk, float *hcc,
                                  float *gc, float *wci, float *gii,
                                  float *gi, float *corner, float *cam_part,
                                  void *stream) {
  switch (intr_w) {
#define PCT_CASE(IW)                                                        \
  case IW:                                                                  \
    return launch_gram_fused<IW>(packed, tpl, uv, mask, n_cams, n_ims,      \
                                 n_keys, loss, component, f_scale, chunk,   \
                                 hcc, gc, wci, gii, gi, corner, cam_part,   \
                                 stream);
    PCT_CASE(8) PCT_CASE(9) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
