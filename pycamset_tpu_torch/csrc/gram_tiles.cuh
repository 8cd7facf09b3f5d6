// The register-tile gram loop shared by the gram kernels of
// template_grams.cu (Kernels A, B) and mixed_grams.cu (Kernels C-F).
//
// A thread block of NT = 128 threads (NW = 4 warps) holds one tile of key
// rows in shared memory, [Jc a | Ji 6 | r | cost column | zeros] at stride
// RS. RS is RC plus two words of pad where RC is a multiple of 4 (26 at the
// standard model's RC = 24, 38 at the tilted model's 36): the row stores of
// one warp and the tile loads of its row streams then fall on distinct
// banks. Masked slots write no row: a warp ballot and the per-warp live
// counts place the live keys' u rows densely in key order, their v rows
// after them (live_slot).
//
// The RC columns form NG groups of G = 6; the upper-triangle group pairs
// are 6 x 6 register tiles: 10 at the standard and fisheye models (RC 24),
// 15 at the rational and thin-prism ones (30), 21 at the tilted one (36).
// Lane N_TILES s + t of a warp owns tile t over row stream
// q = warp + NW s, s < N_SUB = 32 / N_TILES (three streams a warp, two, or
// one: TileLane): per row it loads its two groups (six 64-bit loads,
// broadcast to the lanes that share the row) and issues 36 FMAs
// (tile_rows). At an image's end the lanes' partial tiles go through shared
// memory (tile_store, over the row tile, which is free then) and one thread
// per gram entry adds its partials in a fixed order, warp then stream
// (EntryRole, entry_sum): no float atomics, the same bits on every run.
//
// The geometry is Tiles<M> for a camera model M (projection_core.cuh); the
// names at namespace scope are the standard model's, the defaults of the
// functions, for the kernels that serve it alone (mixed_grams.cu).
#pragma once

#include "projection_core.cuh"

namespace pct_tiles {

constexpr int NW = 4;              // warps per block
constexpr int NT = NW * 32;        // threads per block = keys per row tile
constexpr int G = 6;               // register tile: G x G entries per lane

template <class M>
struct Tiles {
  using Mdl = M;
  static constexpr int RC = (M::ROW + G - 1) / G * G;  // row: gram + cost + 0
  static constexpr int RS = RC % 4 == 0 ? RC + 2 : RC;  // row stride
  static constexpr int NG = RC / G;                    // column groups
  static constexpr int N_TILES = NG * (NG + 1) / 2;    // upper group pairs
  static constexpr int N_SUB = 32 / N_TILES;           // row streams a warp
  static constexpr int N_LANES = N_SUB * N_TILES;      // accumulating lanes
  static constexpr int N_STREAM = NW * N_SUB;          // row streams a block
  static constexpr int CORNER = M::ROW - 1;  // the cost column, for the corner
  static constexpr int N_EPT = (M::N_ENTRIES + NT - 1) / NT;  // entries a thread
  static constexpr int ROWS_FLOATS = 2 * NT * RS;      // the row tile
  static constexpr int N_PPT = (M::PPB + NT - 1) / NT;  // parameters a thread
  static_assert(N_SUB >= 1, "one warp holds a stream's tiles");
  static_assert(RS % 2 == 0 && RS >= RC, "64-bit tile loads");
  static_assert(NW * N_LANES * G * G <= ROWS_FLOATS,
                "the partials fit in the row tile");
};

using StdTiles = Tiles<pct_core::Standard>;

using pct_core::N_ENTRIES;
using pct_core::PPB;
using pct_core::ROW;
using pct_core::W;

// the standard model's geometry
constexpr int RC = StdTiles::RC;                // 24
constexpr int RS = StdTiles::RS;                // 26
constexpr int NG = StdTiles::NG;                // 4
constexpr int N_TILES = StdTiles::N_TILES;      // 10
constexpr int N_SUB = StdTiles::N_SUB;          // 3
constexpr int N_LANES = StdTiles::N_LANES;      // 30
constexpr int N_STREAM = StdTiles::N_STREAM;    // 12
constexpr int CORNER = StdTiles::CORNER;        // 22
constexpr int N_EPT = StdTiles::N_EPT;          // 2
constexpr int ROWS_FLOATS = StdTiles::ROWS_FLOATS;
static_assert(RC == 24 && RS == 26 && N_LANES == 30 && N_EPT == 2 &&
                  PPB <= NT,
              "the standard geometry");

// tile t (row-major over the upper triangle of NG x NG) -> groups (a, b)
template <class T = StdTiles>
__device__ __forceinline__ void tile_groups(int t, int &a, int &b) {
  a = 0;
  while (t >= T::NG - a) {
    t -= T::NG - a;
    ++a;
  }
  b = a + t;
}

template <class T = StdTiles>
__device__ __forceinline__ int tile_of(int a, int b) {
  return a * T::NG - a * (a - 1) / 2 + (b - a);
}

// The accumulating role of lane `lane` of warp `warp`: tile lane % N_TILES
// over row stream q = warp + NW * (lane / N_TILES), which walks the rows q,
// q + N_STREAM, ...: the rows a warp reads at once are NW apart, on
// distinct banks. `partial` is where its tile goes at an image's end.
struct TileLane {
  bool on;
  const float *col_a, *col_b;
  int q;
  float *partial;
};

template <class T = StdTiles>
__device__ __forceinline__ TileLane tile_lane(float *rows, int warp,
                                              int lane) {
  TileLane r;
  r.on = lane < T::N_LANES;
  int ta, tb;
  tile_groups<T>(r.on ? lane % T::N_TILES : 0, ta, tb);
  r.col_a = rows + ta * G;
  r.col_b = rows + tb * G;
  r.q = warp + NW * (lane / T::N_TILES);
  r.partial = rows + (warp * T::N_LANES + lane) * G * G;
  return r;
}

// acc += the lane's tile over its stream's rows among the first n_rows
template <class T = StdTiles>
__device__ __forceinline__ void tile_rows(float (&acc)[G * G],
                                          const TileLane &tl, int n_rows) {
  #pragma unroll 8  // a tile gives a stream about 17 rows (standard model)
  for (int r = tl.q; r < n_rows; r += T::N_STREAM) {
    const float2 *pa = reinterpret_cast<const float2 *>(tl.col_a + r * T::RS);
    const float2 *pb = reinterpret_cast<const float2 *>(tl.col_b + r * T::RS);
    float x[G], y[G];
    #pragma unroll
    for (int h = 0; h < G / 2; ++h) {
      const float2 u = pa[h], v = pb[h];
      x[2 * h] = u.x;
      x[2 * h + 1] = u.y;
      y[2 * h] = v.x;
      y[2 * h + 1] = v.y;
    }
    #pragma unroll
    for (int i = 0; i < G; ++i) {
      #pragma unroll
      for (int j = 0; j < G; ++j)
        acc[i * G + j] = fmaf(x[i], y[j], acc[i * G + j]);
    }
  }
}

// the lane's partial tile into shared memory; acc restarts at zero
__device__ __forceinline__ void tile_store(float (&acc)[G * G],
                                           const TileLane &tl) {
  float4 *dst = reinterpret_cast<float4 *>(tl.partial);
  #pragma unroll
  for (int i = 0; i < G * G / 4; ++i) {
    dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                         acc[4 * i + 3]);
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
}

// The entry role of thread t: gram entries e = t, t + NT, ... of the
// model's N_ENTRIES. (oi, oj) is the output position, src the entry's
// offset in a lane's partials (the corner reads the cost column's square).
template <int N>
struct EntryRoleN {
  int oi[N], oj[N], src[N];
  bool valid[N];
};

using EntryRole = EntryRoleN<N_EPT>;

template <class T = StdTiles>
__device__ __forceinline__ EntryRoleN<T::N_EPT> entry_role(int t) {
  constexpr int GW = T::Mdl::W;
  EntryRoleN<T::N_EPT> r;
  #pragma unroll
  for (int k = 0; k < T::N_EPT; ++k) {
    const int e = t + k * NT;
    r.valid[k] = e < T::Mdl::N_ENTRIES;
    r.oi[k] = r.oj[k] = 0;
    if (r.valid[k]) pct_core::entry_ij<GW>(e, r.oi[k], r.oj[k]);
    const bool is_corner = r.oi[k] == GW - 1 && r.oj[k] == GW - 1;
    const int ri = is_corner ? T::CORNER : r.oi[k];
    const int rj = is_corner ? T::CORNER : r.oj[k];
    r.src[k] = tile_of<T>(ri / G, rj / G) * G * G + (ri % G) * G + rj % G;
  }
  return r;
}

// one entry's partials added in a fixed order: warps, then streams
template <class T = StdTiles>
__device__ __forceinline__ float entry_sum(const float *rows, int src) {
  float sum = 0.f;
  for (int w = 0; w < NW; ++w) {
    #pragma unroll
    for (int sub = 0; sub < T::N_SUB; ++sub)
      sum += rows[(w * T::N_LANES + sub * T::N_TILES) * G * G + src];
  }
  return sum;
}

// Where a live slot's rows go: lane `lane` of warp `warp` with the block's
// live ballot `live` of its warp and the per-warp counts -> its u row's
// position; the v row sits n_live rows further.
__device__ __forceinline__ void live_slot(const int *live_count, int warp,
                                          int lane, unsigned live, int &pos,
                                          int &n_live) {
  int first = 0;
  n_live = 0;
  #pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = live_count[w];
    first += w < warp ? c : 0;
    n_live += c;
  }
  pos = first + __popc(live & ((1u << lane) - 1u));
}

}  // namespace pct_tiles
