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
//   - 64-wide panels (17 at n = 1044), each diagonal tile factored and
//     inverted by one block right after that block updated it, while the
//     other blocks update the rest of the trailing matrix; within the tile
//     one warp factors each 32-wide diagonal block in registers (shuffles,
//     no block barrier a step) and the block does the products between;
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
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float PIV_FLOOR = 1e-8f;   // the TPU kernel's _PIV_FLOOR
constexpr int PSD_MAX_N = 2048;
// two (64, 65) float tiles, a (32, 33) one and a line: the diagonal
// factor's tile (then L), its inverse, L21 X11 and 1 / diag(L); the
// trailing update uses the two tiles, the panel one, the substitutions one
// and 384 floats, the residual 2n floats
constexpr int SMEM_FLOATS = 2 * NB * LDS + 32 * 33 + NB;

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

// One warp factors the 32 x 32 block at sa (stride LDS) in place with the
// clamped rank-1 loop, lane i holding row i in registers (the column of
// each step reaches the other lanes by shuffles), writes 1 / L_ii to
// rdiag, and then writes the block's inverse to sx (stride LDS), lane c
// substituting for column c.
__device__ void factor_block32(float *sa, float *sx, float *rdiag) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float d[32], ljj = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) d[c] = sa[lane * LDS + c];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float dj = __shfl_sync(full, d[j], j);
    const float piv = dj < PIV_FLOOR ? PIV_FLOOR : dj;  // NaN stays NaN
    const float r = rsqrtf(piv);
    const float li = lane >= j ? d[j] * r : 0.f;         // L[lane][j]
#pragma unroll
    for (int m = j + 1; m < 32; ++m) {
      const float lm = __shfl_sync(full, li, m);         // L[m][j]
      if (m <= lane) d[m] -= li * lm;
    }
    d[j] = li;
    if (lane == j) ljj = li;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) sa[lane * LDS + c] = d[c];
  rdiag[lane] = __frcp_rn(ljj);
  __syncwarp();
  // column `lane` of L^-1: x_r = (e_r - sum_{m<r} L_rm x_m) / L_rr
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    float acc = r == lane ? 1.f : 0.f;
#pragma unroll
    for (int m = 0; m < r; ++m) acc -= sa[r * LDS + m] * d[m];
    d[r] = acc * rdiag[r];
  }
#pragma unroll
  for (int r = 0; r < 32; ++r) sx[r * LDS + lane] = d[r];
  __syncwarp();
}

// Factor the diagonal tile t (rows/cols t*64 .. t*64+tb) of the factor
// buffer with the clamped rank-1 loop, write its L back, and write its
// inverse (identity on the padded rows). One block; `src` is the tile's
// top-left entry (in a or in l), leading dim n. The tile splits into 32 x
// 32 blocks: warp 0 factors and inverts the two diagonal blocks
// (factor_block32), and the whole block forms L21 = A21 X11^T, the update
// A22 -= L21 L21^T and X21 = -X22 (L21 X11) in between.
__device__ void factor_diag(const Args &g, const float *src, int t,
                            float *sm) {
  float *sa = sm;                      // the tile, then its L
  float *sx = sm + NB * LDS;           // its inverse
  float *st = sm + 2 * NB * LDS;       // (32, 33) L21 X11
  float *rdiag = st + 32 * 33;         // 1 / L_ii
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = g.n;
  const int t0 = t * NB;
  const int tb = min(NB, n - t0);
  float v[NB * NB / THREADS];
#pragma unroll
  for (int u = 0; u < NB * NB / THREADS; ++u) {   // all loads in flight
    const int r = (tid + u * THREADS) / NB, c = tid % NB;
    v[u] = (r < tb && c < tb) ? ld(src + (size_t)r * n + c)
                              : (r == c ? 1.f : 0.f);
  }
#pragma unroll
  for (int u = 0; u < NB * NB / THREADS; ++u) {
    const int r = (tid + u * THREADS) / NB, c = tid % NB;
    sa[r * LDS + c] = v[u];
    sx[r * LDS + c] = 0.f;
  }
  __syncthreads();
  if (warp == 0) factor_block32(sa, sx, rdiag);
  __syncthreads();
  // thread -> row 32 + (tid >> 3), columns (tid & 7) + 8k, k < 4
  const int r2 = 32 + (tid >> 3), c0 = tid & 7;
  float o[4] = {};
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {           // L21 = A21 X11^T
    const float a = sa[r2 * LDS + m];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = fmaf(a, sx[(c0 + 8 * k) * LDS + m], o[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) sa[r2 * LDS + c0 + 8 * k] = o[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = 0.f;
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {           // A22 -= L21 L21^T
    const float a = sa[r2 * LDS + m];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = fmaf(a, sa[(32 + c0 + 8 * k) * LDS + m], o[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sa[r2 * LDS + 32 + c0 + 8 * k] -= o[k];
  __syncthreads();
  if (warp == 0)
    factor_block32(sa + 32 * LDS + 32, sx + 32 * LDS + 32, rdiag + 32);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = 0.f;
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {           // T = L21 X11 (while warp 0 works)
    const float a = sa[r2 * LDS + m];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = fmaf(a, sx[m * LDS + c0 + 8 * k], o[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) st[(r2 - 32) * 33 + c0 + 8 * k] = o[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = 0.f;
#pragma unroll 8
  for (int m = 0; m < 32; ++m) {           // X21 = -X22 T
    const float a = sx[r2 * LDS + 32 + m];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = fmaf(a, st[m * 33 + c0 + 8 * k], o[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sx[r2 * LDS + c0 + 8 * k] = -o[k];
  __syncthreads();
  float *mt = g.minv + (size_t)t * NB * NB;
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    mt[e] = sx[r * LDS + c];
    if (r < tb && c <= r) g.l[(size_t)(t0 + r) * n + t0 + c] = sa[r * LDS + c];
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
// one warp per row, rows shared out over the grid.
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
      float s = 0.f;
      for (int m = 0; m <= c; ++m) s = fmaf(row[m], sminv[c * LDS + m], s);
      lr[c] = s;
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
  if (blockIdx.x == 0) factor_diag(g, g.a, 0, sm);
  grid.sync();
  // factorisation: per panel k, the rows below it, then the trailing
  // update; block 0 takes the next diagonal tile alone and factors it
  for (int k = 0; k + 1 < p; ++k) {
    panel_rows(g, k, sm);
    grid.sync();
    const int m = p - 1 - k;                 // trailing tile rows
    const int n_tiles = m * (m + 1) / 2;
    const int others = gridDim.x > 1 ? gridDim.x - 1 : 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int owner = (t == 0 || gridDim.x == 1) ? 0 : 1 + (t - 1) % others;
      if (owner != (int)blockIdx.x) continue;
      // t -> (ti, tj), k < tj <= ti, row-major over the lower triangle
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tj = t - ti * (ti + 1) / 2;
      trailing_tile(g, k, k + 1 + ti, k + 1 + tj, sm);
      if (t == 0)
        factor_diag(g, g.l + (size_t)(k + 1) * NB * n + (k + 1) * NB, k + 1,
                    sm);
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

}  // extern "C"
