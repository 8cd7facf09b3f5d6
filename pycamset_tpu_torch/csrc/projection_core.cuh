// Projection core shared by the gram kernels (template_grams.cu and
// mixed_grams.cu), standard camera model (intr_w 9), float32.
//
// The counterpart of the JAX package's _projection_columns
// (pycamset_tpu/optim/pallas_grams.py): for one key of one (camera, image)
// block, Xw = Rp X + tp, Xc = Re Xw + te, Brown 5-coefficient distortion, the
// closed-form 2 x 21 Jacobian [Jc 15 | Ji 6], IRLS weights of the four losses
// under component or observation semantics, and, for the chains with
// per-key columns (self-calibration, multi-target), the weighted
// d(u, v)/dXc itself.
#pragma once

#include <cuda_runtime.h>

namespace pct_core {

constexpr int PPB = 96;            // packed per-block parameter row
constexpr int A = 15;              // camera columns (9 intr + 6 extr)
constexpr int W = 22;              // gram width: [Jc 15 | Ji 6 | r]
constexpr int ROW = 23;            // tile row: gram columns + cost column
constexpr int N_ENTRIES = 253;     // upper triangle of the 22 x 22 gram

// pack_block_params layout (pycamset_tpu/optim/pallas_grams.py _layout(9))
constexpr int OFF_RE = 9, OFF_DRE = 18, OFF_TE = 45, OFF_DRP = 57;
constexpr int OFF_RP = 48, OFF_TP = 84, OFF_RERP = 87;

enum { LOSS_LINEAR = 0, LOSS_HUBER = 1, LOSS_SOFT_L1 = 2, LOSS_CAUCHY = 3 };

// rho (scaled by c2 = f_scale^2) and IRLS weight of a squared residual s;
// the forms of pycamset_tpu/optim/losses.py::make_loss
__device__ __forceinline__ void loss_rho_w(int loss, float c2, float s,
                                           float &rho, float &w) {
  const float z = s / c2;
  if (loss == LOSS_HUBER) {
    rho = c2 * (z <= 1.f ? z : 2.f * sqrtf(z) - 1.f);
    w = fminf(1.f, 1.f / sqrtf(fmaxf(z, 1e-30f)));
  } else if (loss == LOSS_SOFT_L1) {
    rho = c2 * 2.f * (sqrtf(1.f + z) - 1.f);
    w = 1.f / sqrtf(1.f + z);
  } else if (loss == LOSS_CAUCHY) {
    rho = c2 * log1pf(z);
    w = 1.f / (1.f + z);
  } else {
    rho = s;
    w = 1.f;
  }
}

// The two weighted rows [J (21) | r~ | cost column] of one key at the point
// (tx, ty, tz). The cost column holds r~ under the linear loss and sqrt(rho)
// under a robust one, so the sum of its squares is the block's (robust)
// cost. With WITH_DXC, also the weighted d(u, v)/dXc rows dxu/dxv (3 each),
// from which a caller builds any column whose dXc/dparam it knows.
template <bool WITH_DXC = false>
__device__ __forceinline__ void key_rows(const float *p, float tx, float ty,
                                         float tz, float u, float v, float m,
                                         int loss, int component, float c2,
                                         float *ru_row, float *rv_row,
                                         float *dxu = nullptr,
                                         float *dxv = nullptr) {
  if (m == 0.f) {  // masked slot: exact zeros, whatever its geometry
    for (int c = 0; c < ROW; ++c) {
      ru_row[c] = 0.f;
      rv_row[c] = 0.f;
    }
    if constexpr (WITH_DXC) {
      for (int a = 0; a < 3; ++a) {
        dxu[a] = 0.f;
        dxv[a] = 0.f;
      }
    }
    return;
  }
  const float *rp = p + OFF_RP, *re = p + OFF_RE;
  float xw[3], xc[3];
  for (int a = 0; a < 3; ++a)
    xw[a] = rp[3 * a] * tx + rp[3 * a + 1] * ty + rp[3 * a + 2] * tz +
            p[OFF_TP + a];
  for (int a = 0; a < 3; ++a)
    xc[a] = re[3 * a] * xw[0] + re[3 * a + 1] * xw[1] + re[3 * a + 2] * xw[2] +
            p[OFF_TE + a];

  const float fx = p[0], px = p[1], fy = p[2], py = p[3];
  const float k1 = p[4], k2 = p[5], p1 = p[6], p2 = p[7], k3 = p[8];
  const float inv_z = 1.f / xc[2];
  const float x = xc[0] * inv_z, y = xc[1] * inv_z;
  const float r2 = x * x + y * y, xy = x * y;
  const float radial = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
  const float dradial = k1 + r2 * (2.f * k2 + 3.f * k3 * r2);
  const float xd = x * radial + 2.f * p1 * xy + p2 * (r2 + 2.f * x * x);
  const float yd = y * radial + p1 * (r2 + 2.f * y * y) + 2.f * p2 * xy;

  float r_u = (fx * xd + px - u) * m;
  float r_v = (fy * yd + py - v) * m;
  float mu = m, mv = m, cu = r_u, cv = r_v;
  if (loss != LOSS_LINEAR && component) {  // rho per residual component
    float rho_u, w_u, rho_v, w_v;
    loss_rho_w(loss, c2, r_u * r_u, rho_u, w_u);
    loss_rho_w(loss, c2, r_v * r_v, rho_v, w_v);
    const float swu = sqrtf(w_u), swv = sqrtf(w_v);
    mu = m * swu;
    mv = m * swv;
    r_u *= swu;
    r_v *= swv;
    cu = sqrtf(fmaxf(rho_u * m, 0.f));
    cv = sqrtf(fmaxf(rho_v * m, 0.f));
  } else if (loss != LOSS_LINEAR) {  // rho per 2-D observation
    float rho, w;
    loss_rho_w(loss, c2, r_u * r_u + r_v * r_v, rho, w);
    const float sw = sqrtf(w);
    mu = mv = m * sw;
    r_u *= sw;
    r_v *= sw;
    cu = sqrtf(fmaxf(rho * m, 0.f));
    cv = 0.f;
  }

  // intrinsics [fx, px, fy, py | k1, k2, p1, p2, k3]
  ru_row[0] = xd * mu;
  ru_row[1] = mu;
  ru_row[2] = 0.f;
  ru_row[3] = 0.f;
  rv_row[0] = 0.f;
  rv_row[1] = 0.f;
  rv_row[2] = yd * mv;
  rv_row[3] = mv;
  const float fmu = fx * mu, fmv = fy * mv;
  ru_row[4] = fmu * x * r2;
  ru_row[5] = fmu * x * r2 * r2;
  ru_row[6] = fmu * 2.f * xy;
  ru_row[7] = fmu * (r2 + 2.f * x * x);
  ru_row[8] = fmu * x * r2 * r2 * r2;
  rv_row[4] = fmv * y * r2;
  rv_row[5] = fmv * y * r2 * r2;
  rv_row[6] = fmv * (r2 + 2.f * y * y);
  rv_row[7] = fmv * 2.f * xy;
  rv_row[8] = fmv * y * r2 * r2 * r2;

  // d(u, v)/dXc
  const float dxd_dx = radial + 2.f * x * x * dradial + 2.f * p1 * y + 6.f * p2 * x;
  const float dxd_dy = 2.f * xy * dradial + 2.f * p1 * x + 2.f * p2 * y;
  const float dyd_dy = radial + 2.f * y * y * dradial + 6.f * p1 * y + 2.f * p2 * x;
  const float du_dx = fx * dxd_dx, du_dy = fx * dxd_dy;
  const float dv_dx = fy * dxd_dy, dv_dy = fy * dyd_dy;
  const float du[3] = {du_dx * inv_z, du_dy * inv_z,
                       -(du_dx * x + du_dy * y) * inv_z};
  const float dv[3] = {dv_dx * inv_z, dv_dy * inv_z,
                       -(dv_dx * x + dv_dy * y) * inv_z};

  // extrinsic rotation: dXc/drve[j] = dRe[j] Xw
  for (int j = 0; j < 3; ++j) {
    const float *d = p + OFF_DRE + 9 * j;
    float su = 0.f, sv = 0.f;
    for (int a = 0; a < 3; ++a) {
      const float dxc = d[3 * a] * xw[0] + d[3 * a + 1] * xw[1] + d[3 * a + 2] * xw[2];
      su += du[a] * dxc;
      sv += dv[a] * dxc;
    }
    ru_row[9 + j] = su * mu;
    rv_row[9 + j] = sv * mv;
  }
  // extrinsic translation: dXc/dte = I
  for (int a = 0; a < 3; ++a) {
    ru_row[12 + a] = du[a] * mu;
    rv_row[12 + a] = dv[a] * mv;
  }
  // pose rotation: dXc/drvp[j] = Re dRp[j] X
  for (int j = 0; j < 3; ++j) {
    const float *d = p + OFF_DRP + 9 * j;
    float dxw[3];
    for (int a = 0; a < 3; ++a)
      dxw[a] = d[3 * a] * tx + d[3 * a + 1] * ty + d[3 * a + 2] * tz;
    float su = 0.f, sv = 0.f;
    for (int a = 0; a < 3; ++a) {
      const float dxc = re[3 * a] * dxw[0] + re[3 * a + 1] * dxw[1] + re[3 * a + 2] * dxw[2];
      su += du[a] * dxc;
      sv += dv[a] * dxc;
    }
    ru_row[15 + j] = su * mu;
    rv_row[15 + j] = sv * mv;
  }
  // pose translation: dXc/dtp = Re
  for (int b = 0; b < 3; ++b) {
    float su = 0.f, sv = 0.f;
    for (int a = 0; a < 3; ++a) {
      su += du[a] * re[3 * a + b];
      sv += dv[a] * re[3 * a + b];
    }
    ru_row[18 + b] = su * mu;
    rv_row[18 + b] = sv * mv;
  }
  ru_row[21] = r_u;
  rv_row[21] = r_v;
  ru_row[22] = cu;
  rv_row[22] = cv;

  if constexpr (WITH_DXC) {
    for (int a = 0; a < 3; ++a) {
      dxu[a] = du[a] * mu;
      dxv[a] = dv[a] * mv;
    }
  }
}

// Entry e of the 253-entry upper triangle -> gram (i, j), i <= j.
__device__ __forceinline__ void entry_ij(int e, int &i, int &j) {
  i = 0;
  while (e >= W - i) {
    e -= W - i;
    ++i;
  }
  j = i + e;
}

}  // namespace pct_core
