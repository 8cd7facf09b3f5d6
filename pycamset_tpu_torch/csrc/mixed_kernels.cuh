// Gram kernels with per-key columns for Hopper (sm_90a), float32: the
// kernels and their launchers, shared by the translation units that export
// them through a plain C interface (mixed_grams.cu: C and D at every camera
// model, E and F at the standard model; mixed_models_e.cu and
// mixed_models_f.cu: E and F at the other models, each unit compiled by its
// own nvcc at once). One template over the key width cw serves the
// self-calibration
// chain and the two multi-target chains. They put a per-GROUP SE(3) between
// the image pose and the point, Xc = Re (Rp (Rg Xp + tg) + tp) + te, and the
// key axis carries cw columns in chain order:
//   cw = 3  the self-calibration chain (Projection + Extrinsic3D +
//           RigidTform3d + FreePoint): the free point's three columns; no
//           group pose (Rg = I, tg = 0);
//   cw = 9  the mixed chain (free points, GroupRigidTform3d + FreePoint):
//           [group rotation 3 | group translation 3 | point 3];
//   cw = 6  the grouped template chain (GroupTemplatePoints, the point from
//           the template): [group rotation 3 | group translation 3].
// The group pose is expanded per key (one-hot), so a key's group columns are
// per-key columns here; the reduction to per-group blocks is the caller's.
//
// Replaces four Pallas TPU kernels of pycamset_tpu/optim/pallas_grams.py:
//
//   Kernel C  mixed_kernel<IW, 3, true> + mixed_reduce_kernel<IW, 3, true>
//                 <- make_pallas_selfcal_grams_fused (_fused_selfcal_body)
//   Kernel E  mixed_kernel<IW, CW, true> + mixed_reduce_kernel<IW, CW, true>,
//             cw 9, 6 <- make_pallas_mixed_grams_fused (_fused_mixed_body)
//       per camera: hcc, gc and the key couplings wcc = Jc^T Jk (a cw x K;
//       C: wck), summed over the camera's images; per block: wic = Ji^T Jk
//       (6 cw x K; C: wik), wci, gii, gi and the cost corner; per key:
//       hkk = Jk^T Jk and gk = Jk^T r over all blocks.
//   Kernel D  mixed_kernel<IW, 3, false> + mixed_reduce_kernel<IW, 3, false>
//                 <- make_pallas_selfcal_grams (_selfcal_kernel_body)
//   Kernel F  mixed_kernel<IW, CW, false> + mixed_reduce_kernel<IW, CW, false>
//                 <- _mixed_grams_factory (_mixed_kernel_body)
//       per block: the extended W x W gram [Jc | Ji | r]^T [Jc | Ji | r]
//       (W = a + 7; corner = the (robust) cost); per (block, key): wcc_b
//       (a cw) and wic_b (6 cw); per key: hkk and gk over all blocks.
//
// IW is the camera model's intrinsic width (projection_core.cuh Model): all
// four kernels are built at the five widths the JAX kernels serve, 9
// standard (a = 15, entries pct_selfcal_gram{,_fused} and
// pct_mixed_gram{,_fused}), 8 fisheye (a = 14), 12 rational (18), 16
// thin-prism (22) and 18 tilted (24), through the entries
// pct_selfcal_gram{,_fused}_model and pct_mixed_gram{,_fused}_model. The
// model fixes the gram width, the packed row (the tilted model's 136
// parameters and the column masks take two loads a thread), the tile
// geometry (gram_tiles.cuh Tiles), the per-key sums (3a + 9 floats in C and
// E) and with them the shared memory and the blocks an SM (Occupancy).
//
// Every pose column is masked by imask and key column j by kmask[:, j] in
// the kernel, as the Pallas kernels do, and every camera column by cmask,
// but in Kernel C, which takes none (a null cmask reads as 1): its wrapper
// masks the reduced pieces, as the JAX wrapper does. The projection core is
// the one of Kernels A and B (projection_core.cuh), fed the per-key point
// Xg = Rg Xp + tg (C, D: the free point); it also hands back the weighted
// d(u, v)/dXc rows, and with g = (Re Rp)^T d(u, v)/dXc each key column is
// g . dir_j, dir_j being its direction in the group's output frame times
// kmask[k, j]: dRg[j] Xp (rotation), e_j (translation), Rg e_j (point; e_j
// for cw = 3). A key's directions do not change with the image.
//
// What bounds them on an H100: instruction issue first, device memory
// second. Per real detection the block gram is 253 products of two rows and
// the key couplings 21 cw more, beside one projection core (the standard
// model; (a + 7)(a + 8) / 2 and (a + 6) cw at camera width a). Kernel C at
// self-cal 16 x 100 writes wik (B x 18 x K floats: 44 MB, 0.013 ms at 3.35
// TB/s), D at 64 x 12 wck_b and wik_b (74 MB); E at 16 x 100 writes wic
// (133 MB at cw 9 and K = 384, its whole byte bound, 0.040 ms), F at 64 x 12
// wcc_b and wic_b (223 MB). The first ports fed the block gram one entry per
// thread from shared memory, two loads per FMA (C at 16 x 100: 2.0e7
// warp-wide loads, over half its time); E/F split the key columns over the
// grid in column triples, so the projection core ran three times per
// detection; C kept its 54 per-key sums in registers beside the core (168
// registers, three blocks an SM); and one thread added each key's hkk/gk
// partials in a chain of dependent loads. In this design, on an H100 SXM
// (700 W), Kernel C at self-cal 16 x 100 takes 0.074 ms in its first pass
// (chunk 10) and 0.015 in its second; builds that skip one phase each
// split the first pass into the core, its row stores and the per-image
// flush 0.031, the block-gram tiles 0.020, the per-key sums of g 0.018 and
// the wik stores 0.006, which add up: the phases do not overlap, so the
// kernel is issue-bound at four blocks an SM, as A/B are. Kernel D at
// 64 x 12 (chunk 6): 0.036 + 0.006 ms, against a byte bound of 0.024 ms
// (wck_b and wik_b are 74 MB of it).
//
// The design. Kernels A/B's block (template_grams.cu): 128 threads, one per
// key of a key tile, the register-tile gram loop of gram_tiles.cuh (6 x 6
// tiles, three row streams a warp, masked slots compacted out by a warp
// ballot, partials added in a fixed order), at most 128 registers. The grid
// is (key tiles, chunks of `chunk` images, cameras for C/E / one group for
// D/F); a block walks its chunk inside, and the projection core runs once per
// (block, key) slot. It writes the slot's two weighted rows straight into
// the row tile as A/B's does (a masked slot's zeros go to a shared zero
// row): rows kept in registers for the couplings, or stored only for live
// slots, held all 46 values at once and spilled. The rows are stored
// unmasked: the couplings multiply each camera or pose value by its
// column mask as they read it, and each gram entry (i, j) takes the masks
// of its two columns at the image's end (the masks are 0 or 1, so the bits
// are those of masked rows). The key columns are g . dir_j. At cw 9 and 6
// the directions are read from shared memory, where the block stores them
// once (held in registers they spilled); at cw 3 they are the three kmask
// values, held in registers. The per-slot couplings (wic; D/F: wcc_b) go
// out at once as (block, entry, key) rows, consecutive threads on
// consecutive keys, so every store is coalesced; every slot stores, a
// masked one zeros, so that no warp splits its stores in two.
//
// The per-key sums are the register problem: at cw = 9 a key's wcc, hkk
// and gk would be 189 sums, past any register budget beside the core. But
// each is linear in g, and a key's directions are fixed, so the thread
// keeps the sums of g instead: Gc[i] = sum (ru_i gu + rv_i gv) (15 x 3, C/E
// only: wcc[i, j] = Gc[i] . dir_j), Gr = sum (r_u gu + r_v gv) (3: gk_j =
// Gr . dir_j) and H = sum (gu gu^T + gv gv^T) (6: hkk_pq = dir_p^T H
// dir_q), 54 floats a key for C/E and 9 for D/F at any width. They sit in
// shared memory, one column a thread (no conflicts, no barrier), and go out
// per chunk; the second pass adds them over chunks (and cameras) and then
// applies the directions. In float32 this moves rounding only: the
// directions are applied to sums instead of to each term, and every
// product a sum holds is one of the first port's. Shared memory is dynamic:
// C 54 KB (row tile 26.6, sums 27.6), four blocks an SM; E 65 KB (and
// directions 10.8), three; D 31 KB and F 42 KB, four (the standard model).
// At the other models C takes 53 KB (fisheye, four blocks), 63 and 69 KB
// (rational, thin-prism: three) and 80 KB (tilted: two); E at cw 9 takes
// 63, 74, 80 and 91 KB (fisheye, rational: three; thin-prism, tilted:
// two), at cw 6 59, 69, 75 and 87 KB (three, and two for the tilted); F
// 37 to 54 KB (the register target's blocks).
//
// A rig axis (the fleet): one launch of each pass serves R rigs of one
// shape. The grid's z axis holds every rig's groups (C/E: R x the cameras;
// D/F: one group a rig), and a block reads its rig's per-key data and key
// masks (kd and kmask hold the rigs' one after the other, RigKeys). Every
// per-block and per-camera array is indexed by its block or camera across
// the rigs, so the rigs' partial sums stay apart, and the second pass adds
// each rig's per-key parts over its own chunks only, in one rig's order: a
// rig's outputs are those of a launch of its own, bit for bit, and one rig
// is the launch the kernels had before.
//
// Second pass: one launch adds the first pass's partials in a fixed order:
// no float atomics, so two launches on the same inputs give the same bits.
// Its hkk/gk role spreads each key's partials over 32 threads (one thread a
// key waited on a chain of up to 200 loads). Any n_ims and any K work, a
// ragged last key tile included, with no padding. Each launcher runs on the
// given stream, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

#include "gram_tiles.cuh"
#include "projection_core.cuh"


namespace {

using namespace pct_core;
using namespace pct_tiles;

constexpr int RT = 256;        // threads per block of the second pass
constexpr int RK = 32;         // keys per block of the second pass's wcc role
constexpr int HK_K = 8;        // keys per block of its hkk/gk role
constexpr int HK_G = RT / HK_K;  // part groups per key there
// per-key group data (pack_key_group_data, the JAX layout), (KD_ROWS, K)
constexpr int KD_ROWS = 48;
constexpr int KD_XG = 0, KD_RG = 3, KD_DRG = 12, KD_XP = 39;
// per-key sums of g, a key's rows in the chunk partials: Gc (a x 3, C/E
// only), then Gr (3) and H's upper triangle (6)
constexpr int N_HK = 9;

template <class M, int CW>
struct Mix {
  static constexpr int N_GC = 3 * M::A;             // Gc sums per key
  static constexpr int NCC = M::A * CW;             // wcc entries per key
  static constexpr int NIC = 6 * CW;                // wic entries per key
};

template <class M, bool FUSED>
struct Sums {
  static constexpr int GR = FUSED ? 3 * M::A : 0;   // first Gr row
  static constexpr int N = GR + N_HK;               // sums per key
};

// Gram entry (i, j) that Kernels C and E sum over a camera's images: hcc or
// gc.
template <class M>
__device__ __forceinline__ bool cam_entry(int i, int j) {
  return i < M::A && (j < M::A || j == M::W - 1);
}

// The cw directions of key k in the group's output frame, times
// kmask[k, j], as KeyDirs<CW>::N values: the rotation columns' dRg[j] Xp
// (3 x 3), the translation columns' kmask (their directions are e_j), the
// point columns' Rg e_j (3 x 3, cw = 9 only); at cw = 3 the point columns'
// kmask (their directions are e_j). kd: at cw 9 and 6 the per-key group
// data (KD_ROWS, K); at cw = 3 the free points keyp (K, 3), which only
// point() reads.
template <int CW>
struct KeyDirs {
  static constexpr int N = CW == 9 ? 21 : (CW == 6 ? 12 : 3);
  // floats of kd per key: a rig's kd is ROWS * K floats, its kmask CW * K
  static constexpr int ROWS = CW == 3 ? 3 : KD_ROWS;
  // where the first pass keeps them: shared memory (21 or 12 values held in
  // registers beside the core spilled), or registers (cw = 3)
  static constexpr bool SHARED = CW != 3;
  float v[N];

  // the key's point Xg = Rg Xp + tg (cw = 3: the free point)
  static __device__ __forceinline__ void point(const float *__restrict__ kd,
                                               int k, int n_keys,
                                               float (&xg)[3]) {
    #pragma unroll
    for (int a = 0; a < 3; ++a)
      xg[a] = CW == 3 ? kd[(size_t)k * 3 + a]
                      : kd[(size_t)(KD_XG + a) * n_keys + k];
  }

  __device__ __forceinline__ void load(const float *__restrict__ kd,
                                       const float *__restrict__ kmask, int k,
                                       int n_keys) {
    if constexpr (CW == 3) {
      #pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = kmask[(size_t)k * 3 + j];
      return;
    }
    float xp[3];
    #pragma unroll
    for (int a = 0; a < 3; ++a) xp[a] = kd[(size_t)(KD_XP + a) * n_keys + k];
    #pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float km = kmask[(size_t)k * CW + j];
      if (j >= 3 && j < 6) {
        v[6 + j] = km;
        continue;
      }
      #pragma unroll
      for (int a = 0; a < 3; ++a) {
        float d;
        if (j < 3) {  // rotation: dRg[j] Xp
          const size_t r0 = KD_DRG + 9 * j + 3 * a;
          d = kd[r0 * n_keys + k] * xp[0] + kd[(r0 + 1) * n_keys + k] * xp[1] +
              kd[(r0 + 2) * n_keys + k] * xp[2];
        } else {  // point: Rg e_j
          d = kd[(size_t)(KD_RG + 3 * a + (j - 6)) * n_keys + k];
        }
        v[(j < 3 ? 3 * j : 3 * j - 6) + a] = d * km;
      }
    }
  }

  // g . dir_j
  __device__ __forceinline__ float dot(const float (&g)[3], int j) const {
    if constexpr (CW == 3) return g[j] * v[j];
    if (j >= 3 && j < 6) return g[j - 3] * v[6 + j];
    const int o = j < 3 ? 3 * j : 3 * j - 6;
    return g[0] * v[o] + g[1] * v[o + 1] + g[2] * v[o + 2];
  }

  // dir_j itself
  __device__ __forceinline__ void dir(int j, float (&d)[3]) const {
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      if constexpr (CW == 3)
        d[a] = a == j ? v[j] : 0.f;
      else if (j >= 3 && j < 6)
        d[a] = a == j - 3 ? v[6 + j] : 0.f;
      else
        d[a] = v[(j < 3 ? 3 * j : 3 * j - 6) + a];
    }
  }
};

// Where rig `rig`'s per-key data and key masks start in kd and kmask (each
// rig's follow the last's)
template <int CW>
struct RigKeys {
  static __device__ __forceinline__ size_t kd(int rig, int n_keys) {
    return (size_t)rig * KeyDirs<CW>::ROWS * n_keys;
  }
  static __device__ __forceinline__ size_t kmask(int rig, int n_keys) {
    return (size_t)rig * CW * n_keys;
  }
};

// The blocks an SM the first pass asks for (__launch_bounds__): the
// register target, four (<= 128 registers) at the standard and fisheye
// models as for Kernels A and B, three at the wider models, whose cores hold
// more live values; but never more than its shared memory admits (228 KB an
// SM, 1 KB reserved a block): a register cap for blocks that cannot be
// resident only caps the registers. The standard model keeps the four it
// was built with, E's 65 KB notwithstanding (three resident): its bits and
// registers are the reference's.
template <int INTR_W, int CW, bool FUSED>
struct Occupancy {
  using Mo = Model<INTR_W>;
  // the dynamic shared memory: the row tile, the per-key sums and, at cw 9
  // and 6, the keys' direction values
  static constexpr int DYN_FLOATS =
      Tiles<Mo>::ROWS_FLOATS +
      (Sums<Mo, FUSED>::N + (KeyDirs<CW>::SHARED ? KeyDirs<CW>::N : 0)) * NT;
  // with the static arrays (prm, colm_buf, live_count, zrow) and the
  // reserve
  static constexpr int SMEM_BYTES =
      (int)sizeof(float) *
          (DYN_FLOATS + Mo::PPB + 2 * (Mo::W - 1) + NW + Mo::ROW) +
      1024;
  static constexpr int SMEM_BLOCKS = 228 * 1024 / SMEM_BYTES;
  static constexpr int REG_BLOCKS = INTR_W <= 9 ? 4 : 3;
  static constexpr int MIN_BLOCKS =
      INTR_W == 9 || REG_BLOCKS <= SMEM_BLOCKS ? REG_BLOCKS : SMEM_BLOCKS;
};
// C and D keep the bounds they were built with at every model
static_assert(Occupancy<8, 3, true>::MIN_BLOCKS == 4 &&
                  Occupancy<12, 3, true>::MIN_BLOCKS == 3 &&
                  Occupancy<16, 3, true>::MIN_BLOCKS == 3 &&
                  Occupancy<18, 3, true>::MIN_BLOCKS == 2 &&
                  Occupancy<8, 3, false>::MIN_BLOCKS == 4 &&
                  Occupancy<18, 3, false>::MIN_BLOCKS == 3,
              "C and D's blocks an SM");

// The first pass. Grid (key tiles of NT, chunks of `chunk` blocks,
// n_groups); group g's blocks are g * group, ..., (g + 1) * group - 1 (C/E:
// a camera's images; D/F: one group of all of a rig's blocks). Group g
// belongs to rig g / rig_groups (C/E: the rig's cameras; D/F: 1), whose
// per-key data and key masks it reads: a launch over R rigs holds R rigs'
// blocks, rig-major, and R rigs' kd and kmask, each rig's after the last's;
// every per-block and per-camera array is indexed by its block or camera
// across the rigs, so one rig's sums and outputs stay apart from another's.
// Dynamic shared
// memory: the row tile, then the per-key sums (Sums<M, FUSED>::N rows of
// NT), then, at cw 9 and 6, the keys' direction values (KeyDirs<CW>::N
// rows of NT). kd: at cw 9 and 6 (E/F) the per-key group data (KD_ROWS, K);
// at cw = 3 (C/D) the free points keyp (K, 3) (KeyDirs). cmask may be null
// (Kernel C): every camera column's mask is then 1.
// blk_part (tiles, B, N_ENTRIES): per-block gram entries of one key tile
// (C/E: the non-camera entries). Kernels C/E only: cam_part (C, chunks,
// tiles, N_ENTRIES) holds the chunk's hcc/gc entries, gc_part (C, chunks,
// 3a, K) its Gc sums; for Kernels D/F, wcc_out is wcc_b (B, a cw, K).
// wic_out (B, 6 cw, K). hk_part (groups * chunks, 9, K): the chunk's Gr
// and H sums.
template <int INTR_W, int CW, bool FUSED>
__global__ void
__launch_bounds__(NT, Occupancy<INTR_W, CW, FUSED>::MIN_BLOCKS)
mixed_kernel(const float *__restrict__ packed, const float *__restrict__ kd,
             const float *__restrict__ uv, const float *__restrict__ mask,
             const float *__restrict__ cmask,
             const float *__restrict__ imask,
             const float *__restrict__ kmask, int group, int rig_groups,
             int n_keys, int loss, int component, float c2, int chunk,
             float *__restrict__ blk_part, float *__restrict__ cam_part,
             float *__restrict__ gc_part, float *__restrict__ wcc_out,
             float *__restrict__ wic_out, float *__restrict__ hk_part) {
  using Mo = Model<INTR_W>;
  using T = Tiles<Mo>;
  using M = Mix<Mo, CW>;
  using S = Sums<Mo, FUSED>;
  constexpr int A = Mo::A, W = Mo::W, PPB = Mo::PPB;
  constexpr int N_ENTRIES = Mo::N_ENTRIES, N_EPT = T::N_EPT;
  // the packed row, then the image's W - 1 column masks, N_PV a thread
  // (two at the thin-prism and tilted models)
  constexpr int N_PV = (PPB + W - 1 + NT - 1) / NT;
  extern __shared__ __align__(16) float smem[];
  float *rows = smem;                  // the row tile; partial tiles
  float *sums = rows + T::ROWS_FLOATS;  // sums[r * NT + t]: key t's sum r
  __shared__ __align__(16) float prm[PPB];
  // the column masks of the image, double-buffered: the entry threads
  // read an image's after its rows are gone
  __shared__ float colm_buf[2][W - 1];
  __shared__ int live_count[NW];
  __shared__ float zrow[Mo::ROW];      // the rows of every masked slot
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int ch = blockIdx.y, n_chunks = gridDim.y;
  const int grp = blockIdx.z;
  const int n_blocks = gridDim.z * group;
  const int first = ch * chunk;
  const int blk0 = grp * group + first;
  const int n_blk = min(chunk, group - first);
  const int k = tile * NT + t;
  const bool has_key = k < n_keys;
  const size_t part = (size_t)grp * n_chunks + ch;

  const TileLane tl = tile_lane<T>(rows, warp, lane);
  const auto er = entry_role<T>(t);

  // the key's point Xg and directions, for every image of the chunk
  float xg[3] = {0.f, 0.f, 0.f};
  KeyDirs<CW> kdir;                    // cw = 3: held here for the chunk
  float *dsh = sums + S::N * NT + t;   // dsh[i * NT]: direction value i
  if (has_key) {
    // the rig's per-key data and key masks (D/F: one group a rig)
    const int rig = FUSED ? grp / rig_groups : grp;
    const float *kd_r = kd + RigKeys<CW>::kd(rig, n_keys);
    KeyDirs<CW>::point(kd_r, k, n_keys, xg);
    kdir.load(kd_r, kmask + RigKeys<CW>::kmask(rig, n_keys), k, n_keys);
    if constexpr (KeyDirs<CW>::SHARED) {
      #pragma unroll
      for (int i = 0; i < KeyDirs<CW>::N; ++i) dsh[i * NT] = kdir.v[i];
    }
  }
  #pragma unroll
  for (int r = 0; r < S::N; ++r) sums[r * NT + t] = 0.f;
  if (t < Mo::ROW) zrow[t] = 0.f;      // read after the first barrier

  float acc[G * G];
  #pragma unroll
  for (int i = 0; i < G * G; ++i) acc[i] = 0.f;
  float cam_acc[N_EPT];
  #pragma unroll
  for (int q = 0; q < N_EPT; ++q) cam_acc[q] = 0.f;

  // this thread's slot of the next image, and the next image's parameters
  // and column masks, loaded an image ahead
  float m = 0.f, p_next[N_PV];
  #pragma unroll
  for (int i = 0; i < N_PV; ++i) p_next[i] = 0.f;
  float2 m_uv = make_float2(0.f, 0.f);
  auto fetch = [&](int b) {
    if (has_key) {
      const size_t s = (size_t)b * n_keys + k;
      m = mask[s];
      m_uv = reinterpret_cast<const float2 *>(uv)[s];
    }
    #pragma unroll
    for (int i = 0; i < N_PV; ++i) {
      const int c = t + i * NT;
      if (c < PPB) {
        p_next[i] = packed[(size_t)b * PPB + c];
      } else if (c < PPB + W - 1) {
        const int cc = c - PPB;
        p_next[i] = cc >= A ? imask[(size_t)b * 6 + (cc - A)]
                    : cmask != nullptr ? cmask[(size_t)b * A + cc] : 1.f;
      }
    }
  };
  fetch(blk0);

  for (int bi = 0; bi < n_blk; ++bi) {
    const int blk = blk0 + bi;
    // the previous image's last readers of prm, and the last readers of
    // this buffer of column masks (two images back), passed a barrier since
    float *colm = colm_buf[bi & 1];
    #pragma unroll
    for (int i = 0; i < N_PV; ++i) {
      const int c = t + i * NT;
      if (c < PPB) {
        prm[c] = p_next[i];
      } else if (c < PPB + W - 1) {
        colm[c - PPB] = p_next[i];
      }
    }
    const float km = m;
    const float2 kuv = m_uv;
    if (bi + 1 < n_blk) fetch(blk + 1);
    const unsigned live = __ballot_sync(0xffffffffu, km != 0.f);
    if (lane == 0) live_count[warp] = __popc(live);
    __syncthreads();  // counts, prm and colm are in; the last tile is read
    int pos, n_live;
    live_slot(live_count, warp, lane, live, pos, n_live);

    float *wic = wic_out + (size_t)blk * M::NIC * n_keys + k;
    float *wcc = wcc_out + (size_t)blk * M::NCC * n_keys + k;  // D/F only
    if (has_key) {
      // the key's u row at tile row pos, its v row at n_live + pos, written
      // by the core as it goes; a masked slot writes zeros to the zero row
      float *ru_row = km != 0.f ? rows + pos * T::RS : zrow;
      float *rv_row = km != 0.f ? rows + (n_live + pos) * T::RS : zrow;
      float dxu[3], dxv[3];
      key_rows_m<Mo, true>(prm, xg[0], xg[1], xg[2], kuv.x, kuv.y, km, loss,
                           component, c2, ru_row, rv_row, dxu, dxv);
      if (km != 0.f) {
        #pragma unroll
        for (int c = Mo::ROW; c < T::RC; ++c) {
          ru_row[c] = 0.f;
          rv_row[c] = 0.f;
        }
      }
      if constexpr (KeyDirs<CW>::SHARED) {
        #pragma unroll
        for (int i = 0; i < KeyDirs<CW>::N; ++i) kdir.v[i] = dsh[i * NT];
      }
      // g = (Re Rp)^T d(u, v)/dXc, then each key column is g . dir_j
      const float *rerp = prm + Mo::OFF_RERP;
      float gu[3], gv[3];
      #pragma unroll
      for (int b = 0; b < 3; ++b) {
        gu[b] = dxu[0] * rerp[b] + dxu[1] * rerp[3 + b] + dxu[2] * rerp[6 + b];
        gv[b] = dxv[0] * rerp[b] + dxv[1] * rerp[3 + b] + dxv[2] * rerp[6 + b];
      }
      float jcu[CW], jcv[CW];
      #pragma unroll
      for (int j = 0; j < CW; ++j) {
        jcu[j] = kdir.dot(gu, j);
        jcv[j] = kdir.dot(gv, j);
      }
      // the rows' camera and pose columns, masked as they are read
      #pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float u = ru_row[A + i] * colm[A + i];
        const float v = rv_row[A + i] * colm[A + i];
        #pragma unroll
        for (int j = 0; j < CW; ++j)
          wic[(size_t)(i * CW + j) * n_keys] = u * jcu[j] + v * jcv[j];
      }
      #pragma unroll
      for (int i = 0; i < A; ++i) {
        const float u = ru_row[i] * colm[i], v = rv_row[i] * colm[i];
        if constexpr (FUSED) {
          #pragma unroll
          for (int b = 0; b < 3; ++b)
            sums[(3 * i + b) * NT + t] += u * gu[b] + v * gv[b];
        } else {
          #pragma unroll
          for (int j = 0; j < CW; ++j)
            wcc[(size_t)(i * CW + j) * n_keys] = u * jcu[j] + v * jcv[j];
        }
      }
      float *hk = sums + S::GR * NT + t;
      #pragma unroll
      for (int b = 0; b < 3; ++b)
        hk[b * NT] += ru_row[W - 1] * gu[b] + rv_row[W - 1] * gv[b];
      int h = 3;
      #pragma unroll
      for (int a = 0; a < 3; ++a) {
        #pragma unroll
        for (int b = a; b < 3; ++b, ++h)
          hk[h * NT] += gu[a] * gu[b] + gv[a] * gv[b];
      }
    }
    __syncthreads();  // the live rows are in
    if (tl.on) tile_rows<T>(acc, tl, 2 * n_live);
    __syncthreads();  // every lane is done with the rows
    if (tl.on) tile_store(acc, tl);
    __syncthreads();  // the partials are in
    #pragma unroll
    for (int q = 0; q < N_EPT; ++q) {
      if (!er.valid[q]) continue;
      // the rows are unmasked: entry (i, j) takes the masks of its columns
      // (0 or 1, so the same bits as masked rows)
      const int i = er.oi[q], j = er.oj[q];
      const float sum = entry_sum<T>(rows, er.src[q]) *
                        (i < W - 1 ? colm[i] : 1.f) *
                        (j < W - 1 ? colm[j] : 1.f);
      if (FUSED && cam_entry<Mo>(i, j)) {
        cam_acc[q] += sum;  // hcc and gc keep summing over the chunk
      } else {
        blk_part[((size_t)tile * n_blocks + blk) * N_ENTRIES + t + q * NT] =
            sum;
      }
    }
    // the next image's rows and counts are written only after its first
    // barrier, which every entry thread reaches after its reads above
  }

  if constexpr (FUSED) {
    #pragma unroll
    for (int q = 0; q < N_EPT; ++q) {
      if (er.valid[q] && cam_entry<Mo>(er.oi[q], er.oj[q]))
        cam_part[(part * n_tiles + tile) * N_ENTRIES + t + q * NT] =
            cam_acc[q];
    }
  }
  if (has_key) {
    if constexpr (FUSED) {
      #pragma unroll
      for (int r = 0; r < M::N_GC; ++r)
        gc_part[(part * M::N_GC + r) * n_keys + k] = sums[r * NT + t];
    }
    #pragma unroll
    for (int r = 0; r < N_HK; ++r)
      hk_part[(part * N_HK + r) * n_keys + k] = sums[(S::GR + r) * NT + t];
  }
}

// Second pass: add the first pass's partials in a fixed order. kd and
// kmask as in the first pass (at cw = 3 the directions are kmask alone and
// kd, the free points, is not read), n_rigs rigs' of them: n_blocks and
// n_cams count every rig's, rig-major. One launch;
// a thread block's role follows from its index: first the B blocks (their
// gram entries over key tiles), then, for Kernels C/E, the C cameras (hcc, gc
// over chunks and key tiles) and the wcc entries (Gc over chunks, then the
// directions) of RK keys a block, last the hkk/gk of HK_K keys a block (Gr
// and H over every chunk of every group of its rig, then the directions;
// rig-major, as many blocks a rig as one rig takes). A block or
// camera role takes the gram entries RT apart, N_EPR a thread (one at the
// standard model's 253, fully unrolled: the first port's code; two at the
// tilted model's 496).
template <int INTR_W, int CW, bool FUSED>
__global__ void __launch_bounds__(RT)
mixed_reduce_kernel(const float *__restrict__ kd,
                    const float *__restrict__ kmask,
                    const float *__restrict__ blk_part,
                    const float *__restrict__ cam_part,
                    const float *__restrict__ gc_part,
                    const float *__restrict__ hk_part, int n_blocks,
                    int n_cams, int n_rigs, int n_tiles, int n_chunks,
                    int n_keys,
                    float *__restrict__ gram, float *__restrict__ hcc,
                    float *__restrict__ gc, float *__restrict__ wcc,
                    float *__restrict__ wci, float *__restrict__ gii,
                    float *__restrict__ gi, float *__restrict__ corner,
                    float *__restrict__ hkk, float *__restrict__ gk) {
  using Mo = Model<INTR_W>;
  using M = Mix<Mo, CW>;
  constexpr int A = Mo::A, W = Mo::W, N_ENTRIES = Mo::N_ENTRIES;
  constexpr int N_EPR = (N_ENTRIES + RT - 1) / RT;  // entries a thread
  __shared__ float red[HK_G][N_HK][HK_K];
  __shared__ float fin[N_HK][HK_K];
  __shared__ float kds[KeyDirs<CW>::N][RK];
  const int t = threadIdx.x;
  long long b = blockIdx.x;
  if (b < n_blocks) {
    #pragma unroll
    for (int q = 0; q < N_EPR; ++q) {
      const int e = t + q * RT;
      if (e >= N_ENTRIES) return;
      int i, j;
      entry_ij<W>(e, i, j);
      if (FUSED && cam_entry<Mo>(i, j)) continue;
      float acc = 0.f;
      #pragma unroll 4
      for (int tile = 0; tile < n_tiles; ++tile)
        acc += blk_part[((size_t)tile * n_blocks + b) * N_ENTRIES + e];
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
    }
    return;
  }
  b -= n_blocks;
  if constexpr (FUSED) {
    if (b < n_cams) {
      #pragma unroll
      for (int q = 0; q < N_EPR; ++q) {
        const int e = t + q * RT;
        if (e >= N_ENTRIES) return;
        int i, j;
        entry_ij<W>(e, i, j);
        if (!cam_entry<Mo>(i, j)) continue;
        float acc = 0.f;
        for (int ch = 0; ch < n_chunks; ++ch)
          #pragma unroll 4
          for (int tile = 0; tile < n_tiles; ++tile)
            acc += cam_part[(((size_t)b * n_chunks + ch) * n_tiles + tile) *
                                N_ENTRIES + e];
        if (j < A) {
          hcc[(b * A + i) * A + j] = acc;
          hcc[(b * A + j) * A + i] = acc;
        } else {
          gc[b * A + i] = acc;
        }
      }
      return;
    }
    b -= n_cams;
    // wcc of camera c and keys kt * RK, ...: the keys' directions first,
    // then thread (row group ig, key kl) adds Gc rows ig, ig + 8, ... over
    // the camera's chunks and applies them
    const int n_kt = (n_keys + RK - 1) / RK;
    if (b < (long long)n_cams * n_kt) {
      const int c = (int)(b / n_kt), kl = t % RK, ig = t / RK;
      const int k = (int)(b % n_kt) * RK + kl;
      const int rig = c / (n_cams / n_rigs);
      kd += RigKeys<CW>::kd(rig, n_keys);
      kmask += RigKeys<CW>::kmask(rig, n_keys);
      if (ig == 0 && k < n_keys) {
        KeyDirs<CW> kdir;
        kdir.load(kd, kmask, k, n_keys);
        #pragma unroll
        for (int i = 0; i < KeyDirs<CW>::N; ++i) kds[i][kl] = kdir.v[i];
      }
      __syncthreads();
      if (k >= n_keys) return;
      KeyDirs<CW> kdir;
      #pragma unroll
      for (int i = 0; i < KeyDirs<CW>::N; ++i) kdir.v[i] = kds[i][kl];
      for (int i = ig; i < A; i += RT / RK) {
        float s[3] = {0.f, 0.f, 0.f};
        #pragma unroll 4
        for (int ch = 0; ch < n_chunks; ++ch) {
          const float *p = gc_part +
              (((size_t)c * n_chunks + ch) * M::N_GC + 3 * i) * n_keys + k;
          #pragma unroll
          for (int a = 0; a < 3; ++a) s[a] += p[(size_t)a * n_keys];
        }
        #pragma unroll
        for (int j = 0; j < CW; ++j)
          wcc[((size_t)c * M::NCC + i * CW + j) * n_keys + k] = kdir.dot(s, j);
      }
      return;
    }
    b -= (long long)n_cams * n_kt;
  }
  // hkk/gk of keys b * HK_K, ...: thread (key kl, part group jg) adds the
  // parts jg, jg + HK_G, ...; then thread (sum r, key kl) adds the groups'
  // sums in order, and one thread per key applies the directions
  const int kl = t % HK_K, jg = t / HK_K;
  const int n_hk = (n_keys + HK_K - 1) / HK_K;
  const int rig = (int)(b / n_hk);
  const int k0 = (int)(b % n_hk) * HK_K;
  {
    // the rig's parts: its groups' chunks
    const int n_parts = (FUSED ? n_cams / n_rigs : 1) * n_chunks;
    const float *parts = hk_part + (size_t)rig * n_parts * N_HK * n_keys;
    const int k = k0 + kl;
    float s[N_HK];
    #pragma unroll
    for (int r = 0; r < N_HK; ++r) s[r] = 0.f;
    if (k < n_keys) {
      #pragma unroll 4
      for (int p = jg; p < n_parts; p += HK_G) {
        #pragma unroll
        for (int r = 0; r < N_HK; ++r)
          s[r] += parts[((size_t)p * N_HK + r) * n_keys + k];
      }
    }
    #pragma unroll
    for (int r = 0; r < N_HK; ++r) red[jg][r][kl] = s[r];
  }
  __syncthreads();
  if (t < N_HK * HK_K) {
    const int r = t / HK_K, kk = t % HK_K;
    float acc = 0.f;
    #pragma unroll 8
    for (int g = 0; g < HK_G; ++g) acc += red[g][r][kk];
    fin[r][kk] = acc;
  }
  __syncthreads();
  const int k = k0 + t;
  if (t >= HK_K || k >= n_keys) return;
  // H from its upper triangle (fin[3..8]: 00 01 02 11 12 22)
  const float hm[3][3] = {{fin[3][t], fin[4][t], fin[5][t]},
                          {fin[4][t], fin[6][t], fin[7][t]},
                          {fin[5][t], fin[7][t], fin[8][t]}};
  KeyDirs<CW> kdir;
  kdir.load(kd + RigKeys<CW>::kd(rig, n_keys),
            kmask + RigKeys<CW>::kmask(rig, n_keys), k, n_keys);
  const float gr[3] = {fin[0][t], fin[1][t], fin[2][t]};
  const size_t kr = (size_t)rig * n_keys + k;   // the key across the rigs
  #pragma unroll
  for (int p = 0; p < CW; ++p) {
    float d[3], hd[3];   // dir_p, H dir_p
    kdir.dir(p, d);
    #pragma unroll
    for (int a = 0; a < 3; ++a)
      hd[a] = hm[a][0] * d[0] + hm[a][1] * d[1] + hm[a][2] * d[2];
    gk[kr * CW + p] = kdir.dot(gr, p);
    #pragma unroll
    for (int q = p; q < CW; ++q) {
      const float v = kdir.dot(hd, q);
      hkk[(kr * CW + p) * CW + q] = v;
      hkk[(kr * CW + q) * CW + p] = v;
    }
  }
}

// the first pass's dynamic shared memory, set on the kernel once
template <int INTR_W, int CW, bool FUSED>
cudaError_t first_pass_smem(size_t &bytes) {
  bytes = sizeof(float) * Occupancy<INTR_W, CW, FUSED>::DYN_FLOATS;
  static bool set = false;
  if (set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      mixed_kernel<INTR_W, CW, FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mixed_kernel<INTR_W, CW, FUSED>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  set = err == cudaSuccess;
  return err;
}

// What the device makes of the first pass mixed_kernel<INTR_W, CW, FUSED>,
// into out[6]: the blocks of 128 threads an SM can hold at the dynamic
// shared memory its launcher passes (the runtime's occupancy calculator),
// that dynamic shared memory in bytes, the static shared memory, registers
// a thread and local (spill) bytes a thread (cudaFuncGetAttributes), and
// the blocks an SM its __launch_bounds__ asked for (Occupancy's MIN_BLOCKS).
template <int INTR_W, int CW, bool FUSED>
int first_pass_occupancy(int *out) {
  size_t smem;
  cudaError_t err = first_pass_smem<INTR_W, CW, FUSED>(smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, mixed_kernel<INTR_W, CW, FUSED>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mixed_kernel<INTR_W, CW, FUSED>, NT, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = (int)smem;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = Occupancy<INTR_W, CW, FUSED>::MIN_BLOCKS;
  return (int)cudaSuccess;
}

// kd: the per-key group data (KD_ROWS, K) at cw 9 and 6; the free points
// keyp (K, 3) at cw = 3. n_rigs rigs of n_blocks blocks each: every array
// holds the rigs' rows one rig after the other (kd (R, KD_ROWS, K), kmask
// (R, K, cw), packed (R * B, PPB), ..., hkk (R, K, cw, cw)); one launch
// of each pass serves them all, and each rig's outputs are those of a
// launch of its own (the same sums in the same order).
template <int INTR_W, int CW>
int launch_mixed(const float *packed, const float *kd, const float *uv,
                 const float *mask, const float *cmask, const float *imask,
                 const float *kmask, int n_rigs, int n_blocks, int n_keys,
                 int loss, int component, float f_scale, int chunk,
                 float *gram, float *wcc, float *wic, float *hkk, float *gk,
                 float *blk_part, float *hk_part, cudaStream_t st) {
  if (n_rigs <= 0 || n_blocks <= 0 || n_keys <= 0)
    return (int)cudaGetLastError();
  const int n_tiles = (n_keys + NT - 1) / NT;
  const int n_chunks = (n_blocks + chunk - 1) / chunk;
  size_t smem;
  cudaError_t err = first_pass_smem<INTR_W, CW, false>(smem);
  if (err != cudaSuccess) return (int)err;
  mixed_kernel<INTR_W, CW, false>
      <<<dim3(n_tiles, n_chunks, n_rigs), NT, smem, st>>>(
          packed, kd, uv, mask, cmask, imask, kmask, n_blocks, 1, n_keys,
          loss, component, f_scale * f_scale, chunk, blk_part, nullptr,
          nullptr, wcc, wic, hk_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_red = (long long)n_rigs * n_blocks +
                          (long long)n_rigs * ((n_keys + HK_K - 1) / HK_K);
  mixed_reduce_kernel<INTR_W, CW, false><<<(unsigned)n_red, RT, 0, st>>>(
      kd, kmask, blk_part, nullptr, nullptr, hk_part, n_rigs * n_blocks,
      n_rigs, n_rigs, n_tiles, n_chunks, n_keys, gram, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, hkk, gk);
  return (int)cudaGetLastError();
}

// n_rigs rigs of n_cams cameras of n_ims images each, rig-major (hcc
// (R * C, a, a), ..., hkk (R, K, cw, cw)), as launch_mixed.
template <int INTR_W, int CW>
int launch_mixed_fused(const float *packed, const float *kd, const float *uv,
                       const float *mask, const float *cmask,
                       const float *imask, const float *kmask, int n_rigs,
                       int n_cams, int n_ims, int n_keys, int loss,
                       int component,
                       float f_scale, int chunk, float *hcc, float *gc,
                       float *wcc, float *wic, float *wci, float *gii,
                       float *gi, float *corner, float *hkk, float *gk,
                       float *blk_part, float *cam_part, float *gc_part,
                       float *hk_part, cudaStream_t st) {
  if (n_rigs <= 0 || n_cams <= 0 || n_ims <= 0 || n_keys <= 0)
    return (int)cudaGetLastError();
  const int n_tiles = (n_keys + NT - 1) / NT;
  const int n_chunks = (n_ims + chunk - 1) / chunk;
  const int cams = n_rigs * n_cams;   // every rig's cameras
  size_t smem;
  cudaError_t err = first_pass_smem<INTR_W, CW, true>(smem);
  if (err != cudaSuccess) return (int)err;
  mixed_kernel<INTR_W, CW, true>
      <<<dim3(n_tiles, n_chunks, cams), NT, smem, st>>>(
          packed, kd, uv, mask, cmask, imask, kmask, n_ims, n_cams, n_keys,
          loss, component, f_scale * f_scale, chunk, blk_part, cam_part,
          gc_part, nullptr, wic, hk_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = cams * n_ims;
  const long long n_red = (long long)n_blocks + cams +
                          (long long)cams * ((n_keys + RK - 1) / RK) +
                          (long long)n_rigs * ((n_keys + HK_K - 1) / HK_K);
  mixed_reduce_kernel<INTR_W, CW, true><<<(unsigned)n_red, RT, 0, st>>>(
      kd, kmask, blk_part, cam_part, gc_part, hk_part, n_blocks, cams,
      n_rigs, n_tiles, n_chunks, n_keys, nullptr, hcc, gc, wcc, wci, gii, gi,
      corner, hkk, gk);
  return (int)cudaGetLastError();
}

}  // namespace
