// Dense SPD factor + solve in ONE launch for Hopper (sm_90a), float32, plain
// C interface.
//
// Replaces the Pallas TPU kernel of pycamset_tpu/ops/pallas_cholesky.py
// (_pallas_psd_solve_raw, kernel _make_psd_kernel): on the Jacobi-normalised,
// ridged SPD system a x = b of the LM's reduced (Schur) step it computes
//   - a blocked Cholesky a = L L^T whose pivots are clamped at 1e-8
//     (L_jj = d_jj / sqrt(max(d_jj, 1e-8)), as the TPU kernel's rank-1 loop);
//   - forward and backward substitution;
//   - `refine` passes of iterative refinement x += solve(b - a x);
//   - res2 = |b - a x|^2 and b2 = |b|^2, so the caller can fall back on a
//     system the float32 factor and its refinement did not solve.
// Unlike the TPU kernel, the refinement carries x and forms each residual
// in double (n^2 FP64 FMAs a pass, exact products of the float32 a and
// b), and res2 is that double residual; x is returned rounded to float32.
// In float32 the residual of the late LM steps' systems (condition 1e5 to
// 1e6 as the damping shrinks) stalls at res2/b2 ~ 1e-8 to 1e-6, for this
// kernel and for the library route alike, above the fallback's 1e-8: the
// double residual lets the refinement converge, so the check measures what
// it is for, a factor that failed.
// The TPU's 128-wide identity-padded panels, its Newton-Schulz triangular
// inverse (chosen for the MXU) and its VMEM cap n <= 1024 are not carried
// over. Here the matrix lives in device memory and the 50 MB L2: a and its
// factor together take 8 n^2 bytes, 33.5 MB at the limit n = 2048
// (PSD_MAX_N), so both stay in L2 for the whole launch.
//
// What bounds it on an H100: the work is 2n^3/3 FLOP (0.76 GFLOP at
// n = 1044, 11 us at 67 TFLOP/s) against 4n^2 bytes read once (1.3 us), so
// operations bound it on paper. In practice its latency is set by the chain
// of dependent steps: per 64-wide panel one grid-wide sync after the panel
// below the diagonal and one after the trailing update, and per substitution
// one grid-wide sync per panel. The design keeps that chain short:
//   - one cooperative launch, at most one block per SM, every stage
//     separated by cooperative_groups' grid sync (no launch gaps);
//   - 64-wide panels (17 at n = 1044); block 0 takes each panel step's
//     diagonal tile alone (diag_path) while the other blocks update the
//     rest of the trailing matrix, each walking only its own tiles: one
//     round of loads (the panel and the old values together), the update
//     in shared memory, the factor and its inverse straight from there,
//     and only the inverse stored. Within the tile one warp runs the 64
//     pivots in registers (shuffles, no block barrier a step), the first 32
//     carrying the rows below them along, and the other warps update,
//     invert and multiply between and beside them. This path sets the pace
//     of each trailing step (about 29,000 cycles a tile on an H100, the
//     pivots half of it), the other blocks' tiles 8,000-19,000;
//   - the panel below the diagonal and both substitutions go through the
//     explicit inverses of the diagonal tiles, staged in shared memory:
//     every step is a product that all blocks share out, and each block
//     recomputes the tile's 64 unknowns itself instead of waiting on
//     another sync;
//   - each trailing tile is a 64 x 64 x 64 product out of shared memory,
//     4 x 4 outputs per thread;
//   - every global load a step needs is issued before the first value is
//     used or any store that may alias it: a step costs one L2 round trip,
//     not one per value, and the backward sweep's column products are
//     spread over all eight warps of a block (8 rows each).
// Arithmetic: the factor and the substitutions are FP32 FMAs on the CUDA
// cores, the residuals FP64 FMAs; no tensor cores (no TF32). Every sum runs
// in a fixed order and no float atomics are used, so repeat launches give
// the same bits.
//
// The launcher runs on the given stream, allocates nothing, and returns the
// CUDA error of the launch (cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be co-resident).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 64;               // panel width
constexpr int LDS = NB + 1;          // padded shared-memory row stride
constexpr int LDP = NB + 4;          // float4-aligned row stride
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float PIV_FLOOR = 1e-8f;   // the TPU kernel's _PIV_FLOOR
constexpr int PSD_MAX_N = 2048;
// the diagonal path's tile (64, 65), panel (64, 68) then inverse, L21 X11
// (32, 33), 256 floats of the inverse's products and 1 / diag(L); the
// trailing update uses two (64, 65) tiles, the panel rows one, the
// substitutions one and 384 floats, the residual 2n floats
constexpr int SMEM_FLOATS = NB * LDS + NB * LDP + 32 * 33 + 256 + NB;

struct Args {
  const float *a;     // (n, n) the system, read only
  const float *b;     // (n,)
  float *x;           // (n,) solution
  float *res;         // (2,) res2, b2
  float *l;           // (n, n) factor (lower tiles), scratch
  float *minv;        // (p, 64, 64) inverses of the diagonal tiles
  float *w;           // (n,) forward right-hand side / residual
  float *y;           // (n,) forward solution, then backward work vector
  double *xd;         // (n,) the solution, carried in double
  double *rd;         // (n,) the final residual, in double
  int n;
  int refine;
};

// Loads of data that other blocks write during the launch bypass L1.
__device__ __forceinline__ float ld(const float *p) { return __ldcg(p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A barrier over a team of nt threads: the whole block (nt = THREADS), or
// warps 1..7 (named barrier 1, nt = THREADS - 32) while warp 0 factors.
__device__ __forceinline__ void team_sync(int nt) {
  if (nt == THREADS)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
}

// Warp 0 factors the 32 x 32 block at w (stride LDS) in place with the
// clamped rank-1 loop, lane i holding row i in registers (the column of
// each step reaches the other lanes by shuffles), and writes 1 / L_ii to
// rdiag. With PANEL it carries the 32 rows below the block through the
// same steps, lane i holding row 32 + i: their L (L21 = A21 L11^-T) comes
// out of the same 32 steps, with no inverse and no block barrier.
template <bool PANEL>
__device__ void factor_warp(float *w, float *rdiag) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float d[32], e[32], ljj = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    d[c] = w[lane * LDS + c];
    if constexpr (PANEL) e[c] = w[(32 + lane) * LDS + c];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float dj = __shfl_sync(full, d[j], j);
    const float piv = dj < PIV_FLOOR ? PIV_FLOOR : dj;  // NaN stays NaN
    const float r = rsqrtf(piv);
    const float li = lane >= j ? d[j] * r : 0.f;         // L[lane][j]
    float ei = 0.f;
    if constexpr (PANEL) ei = e[j] * r;                  // L[32 + lane][j]
#pragma unroll
    for (int m = j + 1; m < 32; ++m) {
      const float lm = __shfl_sync(full, li, m);         // L[m][j]
      if (m <= lane) d[m] -= li * lm;
      if constexpr (PANEL) e[m] -= ei * lm;
    }
    d[j] = li;
    if constexpr (PANEL) e[j] = ei;
    if (lane == j) ljj = li;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    w[lane * LDS + c] = d[c];
    if constexpr (PANEL) w[(32 + lane) * LDS + c] = e[c];
  }
  rdiag[lane] = __frcp_rn(ljj);
}

// x = l^-1 for the lower-triangular 32 x 32 block l (stride LDS) with
// 1 / diag(l) in rdiag, by the team of threads me = 0 .. nt - 1: the four
// 8 x 8 diagonal blocks by substitution (a thread a column), then two
// doublings inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 (B A^-1), C^-1]],
// each two products over the team. x must hold zeros above the diagonal on
// entry: the products run over whole rows and columns, fully unrolled (a
// loop that starts at the diagonal waits on a shared-memory load a term),
// and the zeros add nothing. tmp holds 256 floats. Ends on a team sync.
__device__ void tri_inverse32(const float *l, float *x, const float *rdiag,
                              float *tmp, int me, int nt) {
  for (int e = me; e < 32; e += nt) {
    const int b0 = (e >> 3) * 8, c = e & 7;
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = r == c ? 1.f : 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float xr = acc[r] * rdiag[b0 + r];
      x[(b0 + r) * LDS + b0 + c] = xr;
#pragma unroll
      for (int q = r + 1; q < 8; ++q)
        acc[q] = fmaf(-l[(b0 + q) * LDS + b0 + r], xr, acc[q]);
    }
  }
  team_sync(nt);
#pragma unroll
  for (int s = 8; s < 32; s *= 2) {
    const int ss = s * s, outs = 16 * s;    // 32 / (2 s) pairs of s x s
    for (int e = me; e < outs; e += nt) {    // T = B A^-1
      const int a0 = 2 * s * (e / ss), i = (e % ss) / s, c = e % s;
      const float *b = l + (a0 + s + i) * LDS + a0;
      const float *ac = x + a0 * LDS + a0 + c;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < s; ++m) acc = fmaf(b[m], ac[m * LDS], acc);
      tmp[e] = acc;
    }
    team_sync(nt);
    for (int e = me; e < outs; e += nt) {    // X21 = -C^-1 T
      const int p = e / ss, a0 = 2 * s * p, i = (e % ss) / s, c = e % s;
      const float *ci = x + (a0 + s + i) * LDS + a0 + s;
      const float *tp = tmp + p * ss + c;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < s; ++m) acc = fmaf(ci[m], tp[m * s], acc);
      x[(a0 + s + i) * LDS + a0 + c] = -acc;
    }
    team_sync(nt);
  }
}

// The diagonal path of a panel step, one block: tile t's update by panel
// k, A = W - P P^T (P: the panel's 64 columns in the tile's rows), the
// clamped factor A = L L^T and its inverse X = L^-1, written to minv_t
// (64 x 64, exact zeros above the diagonal). `tile` is the tile's top-left
// entry (in a or l, leading dimension n), `panel` P's top-left entry or
// null for no update, tb the tile's rows (the last tile is padded with the
// identity). The updated tile never leaves shared memory, and its L is not
// written: nothing reads a diagonal tile's L (panel_rows, the trailing
// tiles and both substitutions read the tiles below the diagonal and the
// inverses). The steps, each ended by a block barrier:
//   1. every load (P, and the old values each thread updates) in flight
//      at once; A's left half (A11, A21) = W - P P^T by all threads, float4
//      loads of P, the sums in the order m = 0 .. 63;
//   2. warp 0 factors A11 and carries A21 through the same 32 steps
//      (factor_warp<true>: L11 and L21); meanwhile warps 1..4 update A22 by
//      P;
//   3. A22 -= L21 L21^T by all threads;
//   4. warp 0 factors A22 (L22); meanwhile warps 1..7 invert L11
//      (tri_inverse32) and form T = L21 X11;
//   5. all threads invert L22 and form X21 = -X22 T; then the stores.
// The chain of dependent steps is the 64 pivots in registers of one warp,
// with one update, one inverse and one product between the two halves.
__device__ void diag_path(const float *tile, const float *panel, int n,
                          int tb, float *minv_t, float *sm) {
  float *sw = sm;                     // (64, 65) A, then L on and below
  float *sp = sw + NB * LDS;          // (64, 68) P, then X = L^-1 (65)
  float *sx = sp;
  float *st = sp + NB * LDP;          // (32, 33) T = L21 X11
  float *stmp = st + 32 * 33;         // 256 floats for tri_inverse32
  float *rdiag = stmp + 256;          // 1 / L_jj
  const int tid = threadIdx.x, warp = tid >> 5;
  // outputs of the update by P: rows ty, 32 + ty, columns tx + 8 v
  // (A11, A21); threads 32..159 also rows 32 + uy, 48 + uy, columns 32 +
  // tx + 8 v (A22)
  const int ty = tid >> 3, tx = tid & 7, uy = (tid - 32) >> 3;
  const bool upd22 = tid >= 32 && tid < 160;
  auto old_at = [&](int r, int c) {
    return (r < tb && c < tb) ? ld(tile + (size_t)r * n + c)
                              : (r == c ? 1.f : 0.f);
  };
  float pv[NB * NB / THREADS], w1[2][4], w2[2][4];
  if (panel) {
#pragma unroll
    for (int u = 0; u < NB * NB / THREADS; ++u) {
      const int r = (tid + u * THREADS) / NB, c = tid % NB;
      pv[u] = r < tb ? ld(panel + (size_t)r * n + c) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      w1[i][v] = old_at(ty + 32 * i, tx + 8 * v);
      w2[i][v] = upd22 ? old_at(32 + uy + 16 * i, 32 + tx + 8 * v) : 0.f;
    }
  if (panel) {
#pragma unroll
    for (int u = 0; u < NB * NB / THREADS; ++u) {
      const int r = (tid + u * THREADS) / NB, c = tid % NB;
      sp[r * LDP + c] = pv[u];
    }
  }
  __syncthreads();
  // w -= sum_m P[r0 + 32 i][m] P[c0 + 8 v][m], m = 0 .. 63 in order
  auto update = [&](float (&w)[2][4], int r0, int ri, int c0) {
    float acc[2][4] = {};
#pragma unroll 4
    for (int m = 0; m < NB; m += 4) {
      float4 a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[i] = *reinterpret_cast<const float4 *>(sp + (r0 + ri * i) * LDP + m);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        b[v] = *reinterpret_cast<const float4 *>(sp + (c0 + 8 * v) * LDP + m);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[i][v] = fmaf(a[i].x, b[v].x, acc[i][v]);
          acc[i][v] = fmaf(a[i].y, b[v].y, acc[i][v]);
          acc[i][v] = fmaf(a[i].z, b[v].z, acc[i][v]);
          acc[i][v] = fmaf(a[i].w, b[v].w, acc[i][v]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) w[i][v] -= acc[i][v];
  };
  if (panel) update(w1, ty, 32, tx);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      sw[(ty + 32 * i) * LDS + tx + 8 * v] = w1[i][v];
  __syncthreads();
  if (warp == 0) {
    factor_warp<true>(sw, rdiag);
  } else if (upd22) {
    if (panel) update(w2, 32 + uy, 16, 32 + tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        sw[(32 + uy + 16 * i) * LDS + 32 + tx + 8 * v] = w2[i][v];
  }
  __syncthreads();
  // X = 0 (P is spent): the inverse's products run over zeros above the
  // diagonal
  for (int e = tid; e < NB * LDS; e += THREADS) sx[e] = 0.f;
  {  // A22 -= L21 L21^T; thread -> row 32 + ty, columns 32 + tx + 8 k
    float o[4] = {};
#pragma unroll 8
    for (int m = 0; m < 32; ++m) {
      const float a = sw[(32 + ty) * LDS + m];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = fmaf(a, sw[(32 + tx + 8 * k) * LDS + m], o[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) sw[(32 + ty) * LDS + 32 + tx + 8 * k] -= o[k];
  }
  __syncthreads();
  if (warp == 0) {
    factor_warp<false>(sw + 32 * LDS + 32, rdiag + 32);
  } else {
    tri_inverse32(sw, sx, rdiag, stmp, tid - 32, THREADS - 32);
    // T = L21 X11: warp w (1..7) rows w - 1 + 7 u, lane c column c
    const int c = tid & 31, w = warp - 1;
    float acc[5] = {};
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      const float xm = sx[m * LDS + c];
#pragma unroll
      for (int u = 0; u < 5; ++u)
        if (w + 7 * u < 32)
          acc[u] = fmaf(sw[(32 + w + 7 * u) * LDS + m], xm, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 5; ++u)
      if (w + 7 * u < 32) st[(w + 7 * u) * 33 + c] = acc[u];
  }
  __syncthreads();
  tri_inverse32(sw + 32 * LDS + 32, sx + 32 * LDS + 32, rdiag + 32, stmp,
                tid, THREADS);
  {  // X21 = -X22 T: warp w rows w + 8 u, lane c column c
    const int c = tid & 31;
    float acc[4] = {};
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      const float tm = st[m * 33 + c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(sx[(32 + warp + 8 * u) * LDS + 32 + m], tm, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sx[(32 + warp + 8 * u) * LDS + c] = -acc[u];
  }
  __syncthreads();
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    minv_t[e] = c <= r ? sx[r * LDS + c] : 0.f;
  }
  __syncthreads();
}

// Minv_j (64 x 64) into registers (16 a thread), then into shared
// memory at stride LDS: all loads are in flight together, and in the
// substitutions the next tile's are issued before a step's row updates, so
// their latency hides behind them.
struct MinvTile {
  float v[NB * NB / THREADS];
};

__device__ __forceinline__ MinvTile load_minv(const Args &g, int j) {
  MinvTile t;
  const float *mj = g.minv + (size_t)j * NB * NB;
#pragma unroll
  for (int u = 0; u < NB * NB / THREADS; ++u)
    t.v[u] = ld(mj + threadIdx.x + u * THREADS);
  return t;
}

__device__ __forceinline__ void store_minv(const MinvTile &t, float *sminv) {
#pragma unroll
  for (int u = 0; u < NB * NB / THREADS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    sminv[(e / NB) * LDS + e % NB] = t.v[u];
  }
}

// l[tile I rows, tile J cols] -= P_I P_J^T over panel k (64 wide), for the
// trailing tile (I, J); one block, 4 x 4 outputs per thread.
__device__ void trailing_tile(const Args &g, int k, int ti, int tj,
                              float *sm) {
  float *pi = sm, *pj = sm + NB * LDS;
  const int n = g.n, k0 = k * NB, i0 = ti * NB, j0 = tj * NB;
  const int tid = threadIdx.x;
  float vi[NB * NB / THREADS], vj[NB * NB / THREADS];
#pragma unroll
  for (int u = 0; u < NB * NB / THREADS; ++u) {   // all loads in flight
    const int r = (tid + u * THREADS) / NB, c = tid % NB;
    vi[u] = (i0 + r < n) ? ld(g.l + (size_t)(i0 + r) * n + k0 + c) : 0.f;
    vj[u] = (j0 + r < n) ? ld(g.l + (size_t)(j0 + r) * n + k0 + c) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < NB * NB / THREADS; ++u) {
    const int r = (tid + u * THREADS) / NB, c = tid % NB;
    pi[r * LDS + c] = vi[u];
    pj[r * LDS + c] = vj[u];
  }
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};
  for (int m = 0; m < NB; ++m) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = pi[(ty + 16 * u) * LDS + m];
      b[u] = pj[(tx + 16 * u) * LDS + m];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
  }
  // all 16 old values are loaded before any store: a load after a store
  // that may alias it would wait for one L2 round trip each
  float old[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = i0 + ty + 16 * u, c = j0 + tx + 16 * v;
      old[u][v] = (r < n && c < n) ? ld(g.l + (size_t)r * n + c) : 0.f;
    }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = i0 + ty + 16 * u, c = j0 + tx + 16 * v;
      if (r < n && c < n) g.l[(size_t)r * n + c] = old[u][v] - acc[u][v];
    }
  __syncthreads();
}

// l[r, panel k] = a_r Minv_k^T for the rows r below the diagonal tile k;
// one warp per row, rows shared out over the grid. Each of a lane's two
// entries is a product over all 64 columns, unrolled, in two sums added
// last: Minv_k holds exact zeros above its diagonal (diag_path writes
// them), so the terms past the diagonal add nothing, and the shared-memory
// loads pipeline instead of waiting a term each.
__device__ void panel_rows(const Args &g, int k, float *sm) {
  float *sminv = sm;                  // (64, 65) Minv_k
  float *srow = sm + NB * LDS;        // one 64-row per warp
  const int n = g.n, k0 = k * NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  store_minv(load_minv(g, k), sminv);
  __syncthreads();
  float *row = srow + warp * NB;
  for (int r = k0 + NB + blockIdx.x * WARPS + warp; r < n;
       r += gridDim.x * WARPS) {
    float *lr = g.l + (size_t)r * n + k0;
    row[lane] = ld(lr + lane);
    row[lane + 32] = ld(lr + lane + 32);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const float *mc = sminv + c * LDS;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int m = 0; m < NB; m += 2) {
        s0 = fmaf(row[m], mc[m], s0);
        s1 = fmaf(row[m + 1], mc[m + 1], s1);
      }
      lr[c] = s0 + s1;
    }
    __syncwarp();
  }
  __syncthreads();
}

// One forward + backward substitution through the diagonal-tile inverses:
// solves L L^T dx = w, and sets xd = dx (first) or xd += dx. Ends on a grid
// sync.
__device__ void substitute(const Args &g, cg::grid_group &grid, bool first,
                           float *sm) {
  float *sminv = sm, *sv = sm + NB * LDS, *ss = sv + NB, *part = ss + NB;
  const int n = g.n, p = (n + NB - 1) / NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid >> 2, q = tid & 3;
  // forward: L y = w, column sweep; w_i -= L_ij y_j below tile j
  store_minv(load_minv(g, 0), sminv);
  for (int j = 0; j < p; ++j) {
    const int j0 = j * NB, jb = min(NB, n - j0);
    if (tid < NB) sv[tid] = tid < jb ? ld(g.w + j0 + tid) : 0.f;
    __syncthreads();
    {  // y_t = sum_m Minv[t][m] w_m; thread (t, q) sums m = q mod 4
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < NB / 4; ++u)
        s = fmaf(sminv[ti * LDS + q + 4 * u], sv[q + 4 * u], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) {
        ss[ti] = s;
        if (blockIdx.x == 0 && ti < jb) g.y[j0 + ti] = s;
      }
    }
    __syncthreads();
    // the next tile's inverse: tile j + 1, or tile p - 1 again for the
    // backward sweep
    const MinvTile next = load_minv(g, min(j + 1, p - 1));
    for (int r = j0 + NB + blockIdx.x * WARPS + warp; r < n;
         r += gridDim.x * WARPS) {
      const float *lr = g.l + (size_t)r * n + j0;
      const float wr = ld(g.w + r);
      float s = ld(lr + lane) * ss[lane];
      s = fmaf(ld(lr + lane + 32), ss[lane + 32], s);
      s = warp_sum(s);
      if (lane == 0) g.w[r] = wr - s;
    }
    store_minv(next, sminv);
    grid.sync();
  }
  // backward: L^T x = y, in place on y; y_c -= (L_jc)^T x_j left of tile j
  for (int j = p - 1; j >= 0; --j) {
    const int j0 = j * NB, jb = min(NB, n - j0);
    if (tid < NB) sv[tid] = tid < jb ? ld(g.y + j0 + tid) : 0.f;
    __syncthreads();
    {  // x_t = sum_m Minv[m][t] y_m; thread (t, q) sums m = q mod 4
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < NB / 4; ++u)
        s = fmaf(sminv[(q + 4 * u) * LDS + ti], sv[q + 4 * u], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) {
        ss[ti] = s;
        if (blockIdx.x == 0 && ti < jb)
          g.xd[j0 + ti] = first ? (double)s : __ldcg(g.xd + j0 + ti) + s;
      }
    }
    __syncthreads();
    const MinvTile next = load_minv(g, j > 0 ? j - 1 : 0);
    // a block takes 32 columns, warp w the rows 8w .. 8w + 7 of tile j;
    // the eight partial sums meet in shared memory in a fixed order
    for (int c0 = blockIdx.x * 32; c0 < j0; c0 += gridDim.x * 32) {
      const int c = c0 + lane;
      float s = 0.f;
      if (c < j0) {
#pragma unroll
        for (int mm = 0; mm < NB / WARPS; ++mm) {
          const int m = warp * (NB / WARPS) + mm;
          if (m < jb) s = fmaf(ld(g.l + (size_t)(j0 + m) * n + c), ss[m], s);
        }
      }
      part[warp * 32 + lane] = s;
      __syncthreads();
      if (warp == 0 && c < j0) {
        const float yc = ld(g.y + c);
        float t = 0.f;
        for (int w = 0; w < WARPS; ++w) t += part[w * 32 + lane];
        g.y[c] = yc - t;
      }
      __syncthreads();
    }
    store_minv(next, sminv);
    grid.sync();
  }
}

// The residual of the carried solution in double, r = b - a xd (a and b
// are float32, so every product is exact): w = float(r) is the next
// right-hand side; on the last pass r itself goes to rd and the rounded
// solution to x. One warp per row; ends on a grid sync.
__device__ void residual(const Args &g, cg::grid_group &grid, bool last,
                         double *sxd) {
  const int n = g.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n; i += THREADS) sxd[i] = __ldcg(g.xd + i);
  __syncthreads();
  for (int r = blockIdx.x * WARPS + warp; r < n; r += gridDim.x * WARPS) {
    const float *ar = g.a + (size_t)r * n;
    double s = 0.0;
#pragma unroll 8
    for (int m = lane; m < n; m += 32) s = fma((double)ar[m], sxd[m], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const double rr = (double)g.b[r] - s;
      g.w[r] = (float)rr;
      if (last) {
        g.rd[r] = rr;
        g.x[r] = (float)sxd[r];
      }
    }
  }
  grid.sync();
}

// Block 0: sum of v[i]^2 in double, in a fixed order.
template <typename T>
__device__ double block_sumsq(const T *v, int n, double *sm) {
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < n; i += THREADS) {
    const double e = (double)__ldcg(v + i);
    s = fma(e, e, s);
  }
  sm[tid] = s;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) sm[tid] += sm[tid + h];
    __syncthreads();
  }
  const double out = sm[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(THREADS, 1) psd_solve_kernel(Args g) {
  extern __shared__ double smd[];
  float *sm = reinterpret_cast<float *>(smd);
  cg::grid_group grid = cg::this_grid();
  const int n = g.n, p = (n + NB - 1) / NB;
  const int tid = threadIdx.x;
  // stage 0: copy the lower tiles of a (all but tile (0, 0), which block 0
  // factors straight from a) and b
  for (size_t e = (size_t)blockIdx.x * THREADS + tid; e < (size_t)n * n;
       e += (size_t)gridDim.x * THREADS) {
    const int r = (int)(e / n), c = (int)(e % n);
    if (c / NB <= r / NB && r >= NB) g.l[e] = g.a[e];
  }
  for (int i = blockIdx.x * THREADS + tid; i < n; i += gridDim.x * THREADS)
    g.w[i] = g.b[i];
  if (blockIdx.x == 0) diag_path(g.a, nullptr, n, min(NB, n), g.minv, sm);
  grid.sync();
  // factorisation: per panel k, the rows below it, then the trailing
  // update. Trailing tile t (row-major over the lower triangle) is block
  // 1 + (t - 1) % (grid - 1)'s, and block 0 takes the diagonal tile t = 0
  // alone, updates, factors and inverts it (all tiles are block 0's on a
  // grid of one). Each block steps through its own tiles only: testing
  // every tile's owner costs about 340 cycles a tile, 46,000 at the first
  // panel of n = 1044, longer than the diagonal path.
  const int step = gridDim.x > 1 ? gridDim.x - 1 : 1;
  for (int k = 0; k + 1 < p; ++k) {
    panel_rows(g, k, sm);
    grid.sync();
    const int m = p - 1 - k;                 // trailing tile rows
    const int n_tiles = m * (m + 1) / 2;
    int t = blockIdx.x;
    if (blockIdx.x == 0) {
      const int t0 = (k + 1) * NB;
      diag_path(g.l + (size_t)t0 * n + t0, g.l + (size_t)t0 * n + k * NB, n,
                min(NB, n - t0), g.minv + (size_t)(k + 1) * NB * NB, sm);
      t = gridDim.x > 1 ? n_tiles : 1;
    }
    for (; t < n_tiles; t += step) {
      // t -> (ti, tj), k < tj <= ti
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tj = t - ti * (ti + 1) / 2;
      trailing_tile(g, k, k + 1 + ti, k + 1 + tj, sm);
    }
    grid.sync();
  }
  // solve, then `refine` passes of refinement on the double residual
  substitute(g, grid, true, sm);
  for (int it = 0; it < g.refine; ++it) {
    residual(g, grid, false, smd);
    substitute(g, grid, false, sm);
  }
  residual(g, grid, true, smd);
  if (blockIdx.x == 0) {
    const double res2 = block_sumsq(g.rd, n, smd);
    const double b2 = block_sumsq(g.b, n, smd);
    if (tid == 0) {
      g.res[0] = (float)res2;
      g.res[1] = (float)b2;
    }
  }
}

// The diagonal path alone on tile k + 1 of l (its update by panel k; k =
// -1: tile 0 as it stands), one ordinary launch of one block: the device
// function psd_solve_kernel runs, for timing it and holding its inverse
// against a float64 one.
__global__ void __launch_bounds__(THREADS, 1)
    psd_diag_tile_kernel(const float *l, int n, int k, float *minv) {
  extern __shared__ double smd[];
  const int t0 = (k + 1) * NB;
  diag_path(l + (size_t)t0 * n + t0,
            k < 0 ? nullptr : l + (size_t)t0 * n + k * NB, n,
            min(NB, n - t0), minv, reinterpret_cast<float *>(smd));
}

// ---- A batch of systems: one block a system (the fleet's reduced steps).
//
// The counterpart of _pallas_psd_solve_raw under jax.vmap, whose grid
// gains a batch axis: blockIdx.x is the system. The same function as
// psd_solve_kernel (clamped factor, substitution, `refine` passes on the
// double residual, res2 and b2), by the plain column algorithm, with only
// block barriers: an ordinary launch, which a CUDA graph captures at any
// batch size. The factor lives in dynamic shared memory where it fits
// (n <= batch_smem_max_n(), 237 in the 227 KB a block may take), else in
// the caller's device scratch (lg, one (n, ld) slab a system, in L2 at
// the fleets' sizes); the vectors are always in shared memory. Rows are
// stored with an odd stride ld, so a column walk (one row a thread) hits
// 32 banks. Per column j: the column scaled by 1 / sqrt(max(L_jj, 1e-8))
// (stored, and copied to `col`), then the trailing update, a warp a row
// and a lane a column; two block barriers a column. The substitutions are
// a barrier a row. Fixed orders throughout: repeat launches give the same
// bits. What bounds it: n block barriers in sequence at the fleets' n
// (33 - 168), not the 2n^3/3 FLOP; simple first, as the TPU kernel under
// vmap was one grid step a system.
constexpr int BATCH_THREADS = 256;
constexpr int BATCH_WARPS = BATCH_THREADS / 32;
constexpr size_t BLOCK_SMEM_MAX = 227 * 1024;

__host__ __device__ constexpr int batch_ld(int n) { return n | 1; }

// red (BATCH_THREADS doubles), xd (n doubles), w, y, col (n floats each),
// then the factor (n rows of ld floats) when it is staged
constexpr size_t batch_smem_bytes(int n, bool factor) {
  return (size_t)(BATCH_THREADS + n) * sizeof(double) +
         (size_t)3 * n * sizeof(float) +
         (factor ? (size_t)n * batch_ld(n) * sizeof(float) : 0);
}

int batch_smem_max_n() {
  int n = 1;
  while (n < PSD_MAX_N && batch_smem_bytes(n + 1, true) <= BLOCK_SMEM_MAX)
    ++n;
  return n;
}

// y = (L L^T)^-1 w, w overwritten (forward solution in place), by the
// block; ends on a block barrier.
__device__ void batch_substitute(const float *L, int n, int ld, float *w,
                                 float *y) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const float zj = w[j] / L[(size_t)j * ld + j];
    for (int i = j + 1 + tid; i < n; i += BATCH_THREADS)
      w[i] = fmaf(-L[(size_t)i * ld + j], zj, w[i]);
    if (tid == 0) y[j] = zj;
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {
    const float xj = y[j] / L[(size_t)j * ld + j];
    for (int i = tid; i < j; i += BATCH_THREADS)
      y[i] = fmaf(-L[(size_t)j * ld + i], xj, y[i]);
    __syncthreads();
    if (tid == 0) y[j] = xj;   // nobody reads y[j] again in this sweep
  }
  __syncthreads();
}

// w = float(b - a xd) (double products of the float32 a, exact); on the
// last pass also x = float(xd), res2 = |b - a xd|^2 and b2 = |b|^2. A
// warp a row; ends on a block barrier.
__device__ void batch_residual(const float *a, const float *b, int n,
                               const double *xd, float *w, double *red,
                               bool last, float *x, float *res2,
                               float *b2) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double part = 0.0;
  for (int r = warp; r < n; r += BATCH_WARPS) {
    const float *ar = a + (size_t)r * n;
    double s = 0.0;
    for (int m = lane; m < n; m += 32) s = fma((double)ar[m], xd[m], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const double rr = (double)b[r] - s;
    if (lane == 0) w[r] = (float)rr;
    part = fma(rr, rr, part);
  }
  if (!last) {
    __syncthreads();
    return;
  }
  for (int i = tid; i < n; i += BATCH_THREADS) x[i] = (float)xd[i];
  red[tid] = lane == 0 ? part : 0.0;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int v = 0; v < BATCH_WARPS; ++v) s += red[v * 32];
    *res2 = (float)s;
  }
  __syncthreads();
  double bb = 0.0;
  for (int i = tid; i < n; i += BATCH_THREADS) {
    const double e = (double)b[i];
    bb = fma(e, e, bb);
  }
  red[tid] = bb;
  __syncthreads();
  for (int h = BATCH_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] += red[tid + h];
    __syncthreads();
  }
  if (tid == 0) *b2 = (float)red[0];
}

template <bool SMEM_FACTOR>
__global__ void __launch_bounds__(BATCH_THREADS)
    psd_batched_kernel(const float *a_all, const float *b_all, int n,
                       int refine, float *x_all, float *res2, float *b2,
                       float *lg) {
  extern __shared__ double smd[];
  const int sys = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, ld = batch_ld(n);
  const float *a = a_all + (size_t)sys * n * n;
  const float *b = b_all + (size_t)sys * n;
  double *red = smd;
  double *xd = red + BATCH_THREADS;
  float *w = reinterpret_cast<float *>(xd + n);
  float *y = w + n;
  float *col = y + n;
  float *L = SMEM_FACTOR ? col + n : lg + (size_t)sys * n * ld;

  for (size_t e = tid; e < (size_t)n * n; e += BATCH_THREADS) {
    const int r = (int)(e / n), c = (int)(e % n);
    if (c <= r) L[(size_t)r * ld + c] = a[e];
  }
  for (int i = tid; i < n; i += BATCH_THREADS) w[i] = b[i];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float dj = L[(size_t)j * ld + j];
    const float s = sqrtf(dj < PIV_FLOOR ? PIV_FLOOR : dj);  // NaN stays
    for (int i = j + tid; i < n; i += BATCH_THREADS) {
      const float v = L[(size_t)i * ld + j] / s;
      if (i > j) L[(size_t)i * ld + j] = v;  // L_jj after the barrier: every
      col[i] = v;                            // thread reads d_jj first
    }
    __syncthreads();
    if (tid == 0) L[(size_t)j * ld + j] = col[j];
    for (int i = j + 1 + warp; i < n; i += BATCH_WARPS) {
      const float li = col[i];
      float *row = L + (size_t)i * ld;
      for (int k = j + 1 + lane; k <= i; k += 32)
        row[k] = fmaf(-li, col[k], row[k]);
    }
    __syncthreads();
  }

  batch_substitute(L, n, ld, w, y);
  for (int i = tid; i < n; i += BATCH_THREADS) xd[i] = (double)y[i];
  __syncthreads();
  for (int it = 0; it < refine; ++it) {
    batch_residual(a, b, n, xd, w, red, false, nullptr, nullptr, nullptr);
    batch_substitute(L, n, ld, w, y);
    for (int i = tid; i < n; i += BATCH_THREADS) xd[i] += (double)y[i];
    __syncthreads();
  }
  batch_residual(a, b, n, xd, w, red, true, x_all + (size_t)sys * n,
                 res2 + sys, b2 + sys);
}

template <bool SMEM_FACTOR>
cudaError_t launch_batched(const float *a, const float *b, int batch, int n,
                           int refine, float *x, float *res2, float *b2,
                           float *l, cudaStream_t stream) {
  const size_t smem = batch_smem_bytes(n, SMEM_FACTOR);
  // the attribute is the function's, per device: set once, uncaptured (the
  // LM's first step, or the fleet runner's, runs outside any capture)
  static bool set_on[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!set_on[dev]) {
    err = cudaFuncSetAttribute(psd_batched_kernel<SMEM_FACTOR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BLOCK_SMEM_MAX);
    if (err != cudaSuccess) return err;
    set_on[dev] = true;
  }
  psd_batched_kernel<SMEM_FACTOR><<<batch, BATCH_THREADS, smem, stream>>>(
      a, b, n, refine, x, res2, b2, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (n, n), b (n,) -> x (n,), res (2,) = (|b - a x|^2, |b|^2) with x the
// solution before its rounding to float32. Scratch: l (n, n), minv
// (ceil(n / 64), 64, 64), w and y (n,) float; xd and rd (n,) double.
int pct_psd_solve(const float *a, const float *b, int n, int refine,
                  float *x, float *res, float *l, float *minv, float *w,
                  float *y, double *xd, double *rd, void *stream) {
  if (n < 1 || n > PSD_MAX_N || refine < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  // grid size per device, found once: one block per SM, all co-resident
  static int grid_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(psd_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, psd_solve_kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid_of[dev] = sms;
  }
  Args g{a, b, x, res, l, minv, w, y, xd, rd, n, refine};
  void *params[] = {&g};
  err = cudaLaunchCooperativeKernel((const void *)psd_solve_kernel,
                                    dim3(grid_of[dev]), dim3(THREADS), params,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// l (n, n): the lower tiles of a system as they stand before panel k + 1
// (tile k + 1 and the panel k's rows beside it; read only) -> minv (64,
// 64), the inverse of tile k + 1's factor. -1 <= k, (k + 1) * 64 < n.
int pct_psd_diag_tile(const float *l, int n, int k, float *minv,
                      void *stream) {
  if (n < 1 || n > PSD_MAX_N || k < -1 || (k + 1) * NB >= n)
    return (int)cudaErrorInvalidValue;
  psd_diag_tile_kernel<<<1, THREADS, SMEM_FLOATS * sizeof(float),
                         (cudaStream_t)stream>>>(l, n, k, minv);
  return (int)cudaGetLastError();
}

// a (batch, n, n), b (batch, n) -> x (batch, n), res2 and b2 (batch,):
// each system as pct_psd_solve solves it, one block a system, in one
// ordinary launch. l: (batch, n, n | 1) float scratch, needed only when
// n > pct_psd_batched_smem_max_n() (else it may be null).
int pct_psd_solve_batched(const float *a, const float *b, int batch, int n,
                          int refine, float *x, float *res2, float *b2,
                          float *l, void *stream) {
  if (n < 1 || n > PSD_MAX_N || refine < 0 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= batch_smem_max_n())
    return (int)launch_batched<true>(a, b, batch, n, refine, x, res2, b2,
                                     nullptr, (cudaStream_t)stream);
  if (l == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_batched<false>(a, b, batch, n, refine, x, res2, b2, l,
                                    (cudaStream_t)stream);
}

// The largest n whose factor pct_psd_solve_batched stages in shared memory.
int pct_psd_batched_smem_max_n(void) { return batch_smem_max_n(); }

}  // extern "C"
