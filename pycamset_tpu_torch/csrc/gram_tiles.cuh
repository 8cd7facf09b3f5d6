// The register-tile gram loop shared by the gram kernels of
// template_grams.cu (Kernels A, B) and mixed_grams.cu (Kernels C-F).
//
// A thread block of NT = 128 threads (NW = 4 warps) holds one tile of key
// rows in shared memory, [Jc 15 | Ji 6 | r | cost column | 0] at stride RS =
// 26 (two words of pad: the row stores of one warp and the tile loads of
// three row streams then fall on distinct banks). Masked slots write no
// row: a warp ballot and the per-warp live counts place the live keys' u
// rows densely in key order, their v rows after them (live_slot).
//
// The 24 columns form 4 groups of 6; the 10 upper-triangle group pairs are
// 6 x 6 register tiles. Lane 10 s + t of a warp (lanes 0-29) owns tile t
// over row stream q = warp + NW s (TileLane): per row it loads its two
// groups (six 64-bit loads, broadcast to the 10 lanes that share the row)
// and issues 36 FMAs (tile_rows). At an image's end the lanes' partial tiles
// go through shared memory (tile_store, over the row tile, which is free
// then) and one thread per gram entry adds its partials in a fixed order,
// warp then stream (EntryRole, entry_sum): no float atomics, the same bits on
// every run.
#pragma once

#include "projection_core.cuh"

namespace pct_tiles {

using pct_core::N_ENTRIES;
using pct_core::PPB;
using pct_core::ROW;
using pct_core::W;

constexpr int NW = 4;              // warps per block
constexpr int NT = NW * 32;        // threads per block = keys per row tile
constexpr int RC = 24;             // tile row: 22 gram + cost + zero columns
constexpr int RS = 26;             // tile row stride (conflict-free reads)
constexpr int G = 6;               // register tile: G x G entries per lane
constexpr int NG = RC / G;         // column groups
constexpr int N_TILES = NG * (NG + 1) / 2;  // upper-triangle group pairs
constexpr int N_SUB = 3;           // row streams per warp
constexpr int N_LANES = N_SUB * N_TILES;    // accumulating lanes per warp
constexpr int N_STREAM = NW * N_SUB;        // row streams per block
constexpr int CORNER = ROW - 1;    // the cost column, read for the corner
constexpr int N_EPT = (N_ENTRIES + NT - 1) / NT;  // gram entries a thread
constexpr int ROWS_FLOATS = 2 * NT * RS;    // the row tile, in floats

static_assert(N_LANES <= 32, "one warp holds its tiles");
static_assert(PPB <= NT, "one thread loads each block parameter");
static_assert(NW * N_LANES * G * G <= ROWS_FLOATS,
              "the partials fit in the row tile");

// tile t (row-major over the upper triangle of NG x NG) -> groups (a, b)
__device__ __forceinline__ void tile_groups(int t, int &a, int &b) {
  a = 0;
  while (t >= NG - a) {
    t -= NG - a;
    ++a;
  }
  b = a + t;
}

__device__ __forceinline__ int tile_of(int a, int b) {
  return a * NG - a * (a - 1) / 2 + (b - a);
}

// The accumulating role of lane `lane` of warp `warp`: tile lane % N_TILES
// over row stream q = warp + NW * (lane / N_TILES), which walks the rows q,
// q + N_STREAM, ...: the three rows a warp reads at once are NW apart, on
// distinct banks. `partial` is where its tile goes at an image's end.
struct TileLane {
  bool on;
  const float *col_a, *col_b;
  int q;
  float *partial;
};

__device__ __forceinline__ TileLane tile_lane(float *rows, int warp,
                                              int lane) {
  TileLane r;
  r.on = lane < N_LANES;
  int ta, tb;
  tile_groups(r.on ? lane % N_TILES : 0, ta, tb);
  r.col_a = rows + ta * G;
  r.col_b = rows + tb * G;
  r.q = warp + NW * (lane / N_TILES);
  r.partial = rows + (warp * N_LANES + lane) * G * G;
  return r;
}

// acc += the lane's tile over its stream's rows among the first n_rows
__device__ __forceinline__ void tile_rows(float (&acc)[G * G],
                                          const TileLane &tl, int n_rows) {
  #pragma unroll 8  // a tile gives a stream about 17 rows
  for (int r = tl.q; r < n_rows; r += N_STREAM) {
    const float2 *pa = reinterpret_cast<const float2 *>(tl.col_a + r * RS);
    const float2 *pb = reinterpret_cast<const float2 *>(tl.col_b + r * RS);
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

// The entry role of thread t: gram entries e = t, t + NT, ... of the 253.
// (oi, oj) is the output position, src the entry's offset in a lane's
// partials (the corner reads the cost column's square).
struct EntryRole {
  int oi[N_EPT], oj[N_EPT], src[N_EPT];
  bool valid[N_EPT];
};

__device__ __forceinline__ EntryRole entry_role(int t) {
  EntryRole r;
  #pragma unroll
  for (int k = 0; k < N_EPT; ++k) {
    const int e = t + k * NT;
    r.valid[k] = e < N_ENTRIES;
    r.oi[k] = r.oj[k] = 0;
    if (r.valid[k]) pct_core::entry_ij(e, r.oi[k], r.oj[k]);
    const bool is_corner = r.oi[k] == W - 1 && r.oj[k] == W - 1;
    const int ri = is_corner ? CORNER : r.oi[k];
    const int rj = is_corner ? CORNER : r.oj[k];
    r.src[k] = tile_of(ri / G, rj / G) * G * G + (ri % G) * G + rj % G;
  }
  return r;
}

// one entry's partials added in a fixed order: warps, then streams
__device__ __forceinline__ float entry_sum(const float *rows, int src) {
  float sum = 0.f;
  for (int w = 0; w < NW; ++w) {
    #pragma unroll
    for (int sub = 0; sub < N_SUB; ++sub)
      sum += rows[(w * N_LANES + sub * N_TILES) * G * G + src];
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
