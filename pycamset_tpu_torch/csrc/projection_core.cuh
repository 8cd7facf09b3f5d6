// Projection core shared by the gram kernels (template_grams.cu and
// mixed_grams.cu), float32, templated on the camera model.
//
// The counterpart of the JAX package's _projection_columns
// (pycamset_tpu/optim/pallas_grams.py, with _brown_columns and
// _fisheye_columns): for one key of one (camera, image) block,
// Xw = Rp X + tp, Xc = Re Xw + te, the model's distortion, the closed-form
// 2 x (a + 6) Jacobian [Jc a | Ji 6], IRLS weights of the four losses under
// component or observation semantics, and, for the chains with per-key
// columns (self-calibration, multi-target), the weighted d(u, v)/dXc itself.
//
// A model (Model<INTR_W>) fixes the intrinsic width and with it the camera
// width A, the gram width W, the packed per-block row (PPB and its offsets,
// the JAX _layout) and which distortion terms exist: 9 standard (Brown 5),
// 12 rational (radial num / den), 16 thin-prism (+ s1..s4), 18 tilted (+ the
// taux/tauy sensor homography Mt, packed with dMt/dtaux and dMt/dtauy), 8
// fisheye (Kannala-Brandt k1..k4). Lens<M> holds the model's distortion:
// the point, its coefficient columns and d(xd, yd)/d(x, y). The tilt turns
// the prism columns' structural zeros into real entries, and nothing here
// skips a product for being zero elsewhere. The standard model's arithmetic
// is that of the first port, expression for expression, so its outputs keep
// their bits; the names of its layout (PPB, A, W, ...) stay in the namespace
// for the kernels that serve it alone (mixed_grams.cu).
#pragma once

#include <cuda_runtime.h>

namespace pct_core {

template <int INTR_W_>
struct Model {
  static_assert(INTR_W_ == 8 || INTR_W_ == 9 || INTR_W_ == 12 ||
                    INTR_W_ == 16 || INTR_W_ == 18,
                "camera models: fisheye 8, standard 9, rational 12, "
                "thin-prism 16, tilted 18");
  static constexpr int INTR_W = INTR_W_;
  static constexpr bool FISHEYE = INTR_W == 8;
  static constexpr bool RATIONAL = INTR_W >= 12;
  static constexpr bool PRISM = INTR_W >= 16;
  static constexpr bool TILT = INTR_W >= 18;
  static constexpr int A = INTR_W + 6;         // camera columns
  static constexpr int W = A + 7;              // gram: [Jc A | Ji 6 | r]
  static constexpr int ROW = W + 1;            // tile row: + cost column
  static constexpr int N_ENTRIES = W * (W + 1) / 2;
  // pack_block_params layout (pallas_grams.py _layout(INTR_W)):
  // [intr | Re 9 | dRe 27 | te 3 | Rp 9 | dRp 27 | tp 3 | ReRp 9
  //  (| Mt 9 | dMt/dtaux 9 | dMt/dtauy 9)], padded to a multiple of 8
  static constexpr int OFF_RE = INTR_W, OFF_DRE = INTR_W + 9;
  static constexpr int OFF_TE = INTR_W + 36, OFF_RP = INTR_W + 39;
  static constexpr int OFF_DRP = INTR_W + 48, OFF_TP = INTR_W + 75;
  static constexpr int OFF_RERP = INTR_W + 78, OFF_MT = INTR_W + 87;
  static constexpr int OFF_DMX = INTR_W + 96, OFF_DMY = INTR_W + 105;
  static constexpr int PPB = (INTR_W + (TILT ? 114 : 87) + 7) / 8 * 8;
};

using Standard = Model<9>;

// the standard model's layout, for the kernels that serve it alone
constexpr int PPB = Standard::PPB;             // 96
constexpr int A = Standard::A;                 // 15 (9 intr + 6 extr)
constexpr int W = Standard::W;                 // 22: [Jc 15 | Ji 6 | r]
constexpr int ROW = Standard::ROW;             // 23
constexpr int N_ENTRIES = Standard::N_ENTRIES;  // 253
constexpr int OFF_RE = Standard::OFF_RE, OFF_DRE = Standard::OFF_DRE;
constexpr int OFF_TE = Standard::OFF_TE, OFF_DRP = Standard::OFF_DRP;
constexpr int OFF_RP = Standard::OFF_RP, OFF_TP = Standard::OFF_TP;
constexpr int OFF_RERP = Standard::OFF_RERP;
static_assert(PPB == 96 && W == 22 && N_ENTRIES == 253 && OFF_RERP == 87,
              "the standard layout");

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

// The distortion of model M at the normalized point (x, y): forward() sets
// the distorted point (xd, yd) and what the columns need again; columns()
// writes the distortion coefficients' columns [4, INTR_W) of the two rows,
// scaled by fmu = fx mu and fmv = fy mv; jac() gives d(xd, yd)/d(x, y).
template <class M>
struct Lens {
  float xd, yd;
  float radial, dradial, inv_den;   // Brown family
  float p1, p2;                     // Brown: the tangential coefficients
  float k1, k2, k3;                 // standard: the radial coefficients

  // The standard model's coefficients, read with the affine intrinsics and
  // before the divide, where the first port read them: so placed, its
  // kernels keep their registers (A 115, B 124) as well as their bits.
  __device__ __forceinline__ void load(const float *p) {
    if constexpr (M::INTR_W == 9) {
      k1 = p[4];
      k2 = p[5];
      p1 = p[6];
      p2 = p[7];
      k3 = p[8];
    }
  }
  float bx, by;                     // Brown: the point before the tilt
  float iw, a00, a01, a10, a11;     // tilt: 1/w and the homography's 2 x 2
  float theta, t2, poly, s, inv_r;  // fisheye

  __device__ __forceinline__ void forward(const float *p, float x, float y,
                                          float r2, float xy) {
    if constexpr (M::FISHEYE) {
      const float k1 = p[4], k2 = p[5], k3 = p[6], k4 = p[7];
      const float r = sqrtf(r2 + 1e-18f);  // smoothed: finite on the axis
      inv_r = 1.f / r;
      theta = atanf(r);
      t2 = theta * theta;
      poly = 1.f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)));
      s = theta * poly * inv_r;
      xd = s * x;
      yd = s * y;
    } else if constexpr (M::INTR_W == 9) {
      radial = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
      dradial = k1 + r2 * (2.f * k2 + 3.f * k3 * r2);
      xd = x * radial + 2.f * p1 * xy + p2 * (r2 + 2.f * x * x);
      yd = y * radial + p1 * (r2 + 2.f * y * y) + 2.f * p2 * xy;
    } else {
      const float k1 = p[4], k2 = p[5], k3 = p[8];
      p1 = p[6];
      p2 = p[7];
      const float num = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
      const float dnum = k1 + r2 * (2.f * k2 + 3.f * k3 * r2);
      const float k4 = p[9], k5 = p[10], k6 = p[11];
      const float den = 1.f + r2 * (k4 + r2 * (k5 + r2 * k6));
      const float dden = k4 + r2 * (2.f * k5 + 3.f * k6 * r2);
      inv_den = 1.f / den;
      radial = num * inv_den;
      dradial = (dnum - radial * dden) * inv_den;
      bx = x * radial + 2.f * p1 * xy + p2 * (r2 + 2.f * x * x);
      by = y * radial + p1 * (r2 + 2.f * y * y) + 2.f * p2 * xy;
      if constexpr (M::PRISM) {
        bx += r2 * (p[12] + r2 * p[13]);
        by += r2 * (p[14] + r2 * p[15]);
      }
      if constexpr (M::TILT) {
        const float *mt = p + M::OFF_MT;
        iw = 1.f / (mt[6] * bx + mt[7] * by + mt[8]);
        xd = (mt[0] * bx + mt[1] * by + mt[2]) * iw;
        yd = (mt[3] * bx + mt[4] * by + mt[5]) * iw;
        a00 = (mt[0] - xd * mt[6]) * iw;
        a01 = (mt[1] - xd * mt[7]) * iw;
        a10 = (mt[3] - yd * mt[6]) * iw;
        a11 = (mt[4] - yd * mt[7]) * iw;
      } else {
        xd = bx;
        yd = by;
      }
    }
  }

  // one Brown column (jx, jy) of d(xd, yd)/dcoef before the tilt, into
  // gram column c
  __device__ __forceinline__ void put(int c, float jx, float jy, float fmu,
                                      float fmv, float *ru,
                                      float *rv) const {
    if constexpr (M::TILT) {
      ru[c] = fmu * (a00 * jx + a01 * jy);
      rv[c] = fmv * (a10 * jx + a11 * jy);
    } else {
      ru[c] = fmu * jx;
      rv[c] = fmv * jy;
    }
  }

  __device__ __forceinline__ void columns(const float *p, float x, float y,
                                          float r2, float xy, float fmu,
                                          float fmv, float *ru,
                                          float *rv) const {
    if constexpr (M::FISHEYE) {
      // d theta_d / dk_i = theta^(2i + 3)
      float tp = t2 * theta;
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        ru[4 + i] = fmu * (x * tp * inv_r);
        rv[4 + i] = fmv * (y * tp * inv_r);
        tp = tp * t2;
      }
    } else if constexpr (M::INTR_W == 9) {
      ru[4] = fmu * x * r2;
      ru[5] = fmu * x * r2 * r2;
      ru[6] = fmu * 2.f * xy;
      ru[7] = fmu * (r2 + 2.f * x * x);
      ru[8] = fmu * x * r2 * r2 * r2;
      rv[4] = fmv * y * r2;
      rv[5] = fmv * y * r2 * r2;
      rv[6] = fmv * (r2 + 2.f * y * y);
      rv[7] = fmv * 2.f * xy;
      rv[8] = fmv * y * r2 * r2 * r2;
    } else {
      // numerator k's see 1/den; denominator k's are -radial r2^i / den
      const float r4 = r2 * r2, r6 = r4 * r2;
      put(4, x * r2 * inv_den, y * r2 * inv_den, fmu, fmv, ru, rv);
      put(5, x * r4 * inv_den, y * r4 * inv_den, fmu, fmv, ru, rv);
      put(6, 2.f * xy, r2 + 2.f * y * y, fmu, fmv, ru, rv);
      put(7, r2 + 2.f * x * x, 2.f * xy, fmu, fmv, ru, rv);
      put(8, x * r6 * inv_den, y * r6 * inv_den, fmu, fmv, ru, rv);
      const float rd = radial * inv_den;
      put(9, -x * rd * r2, -y * rd * r2, fmu, fmv, ru, rv);
      put(10, -x * rd * r4, -y * rd * r4, fmu, fmv, ru, rv);
      put(11, -x * rd * r6, -y * rd * r6, fmu, fmv, ru, rv);
      if constexpr (M::PRISM) {
        put(12, r2, 0.f, fmu, fmv, ru, rv);
        put(13, r4, 0.f, fmu, fmv, ru, rv);
        put(14, 0.f, r2, fmu, fmv, ru, rv);
        put(15, 0.f, r4, fmu, fmv, ru, rv);
      }
      if constexpr (M::TILT) {
        // taux, tauy: the packed dMt through the homography's quotient
        #pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float *dm = p + (t == 0 ? M::OFF_DMX : M::OFF_DMY);
          const float dw = dm[6] * bx + dm[7] * by + dm[8];
          ru[16 + t] = fmu * ((dm[0] * bx + dm[1] * by + dm[2] - xd * dw)
                              * iw);
          rv[16 + t] = fmv * ((dm[3] * bx + dm[4] * by + dm[5] - yd * dw)
                              * iw);
        }
      }
    }
  }

  __device__ __forceinline__ void jac(const float *p, float x, float y,
                                      float r2, float xy, float &dxx,
                                      float &dxy, float &dyx,
                                      float &dyy) const {
    if constexpr (M::FISHEYE) {
      // s depends on r alone: d(xd, yd)/d(x, y) = s I + g [x y]^T [x y],
      // g = (ds/dr) / r; in float32 g cancels near the axis
      const float k1 = p[4], k2 = p[5], k3 = p[6], k4 = p[7];
      const float dtheta_d =
          poly + 2.f * t2 * (k1 + t2 * (2.f * k2 +
                                        t2 * (3.f * k3 + t2 * 4.f * k4)));
      const float g = (dtheta_d / (1.f + r2) - s) * inv_r * inv_r;
      dxx = s + x * x * g;
      dxy = x * y * g;
      dyx = dxy;
      dyy = s + y * y * g;
    } else {
      dxx = radial + 2.f * x * x * dradial + 2.f * p1 * y + 6.f * p2 * x;
      dxy = 2.f * xy * dradial + 2.f * p1 * x + 2.f * p2 * y;
      dyx = dxy;
      dyy = radial + 2.f * y * y * dradial + 6.f * p1 * y + 2.f * p2 * x;
      if constexpr (M::PRISM) {  // the prism breaks dyx == dxy
        const float dpx = p[12] + 2.f * p[13] * r2;
        const float dpy = p[14] + 2.f * p[15] * r2;
        dxx = dxx + 2.f * x * dpx;
        dxy = dxy + 2.f * y * dpx;
        dyx = dyx + 2.f * x * dpy;
        dyy = dyy + 2.f * y * dpy;
      }
      if constexpr (M::TILT) {
        const float xx = a00 * dxx + a01 * dyx, xy_ = a00 * dxy + a01 * dyy;
        const float yx = a10 * dxx + a11 * dyx, yy = a10 * dxy + a11 * dyy;
        dxx = xx;
        dxy = xy_;
        dyx = yx;
        dyy = yy;
      }
    }
  }
};

// The two weighted rows [J (A + 6) | r~ | cost column] of one key at the
// point (tx, ty, tz), model M. The cost column holds r~ under the linear
// loss and sqrt(rho) under a robust one, so the sum of its squares is the
// block's (robust) cost. With WITH_DXC, also the weighted d(u, v)/dXc rows
// dxu/dxv (3 each), from which a caller builds any column whose
// dXc/dparam it knows.
template <class M, bool WITH_DXC = false>
__device__ __forceinline__ void key_rows_m(const float *p, float tx,
                                           float ty, float tz, float u,
                                           float v, float m, int loss,
                                           int component, float c2,
                                           float *ru_row, float *rv_row,
                                           float *dxu = nullptr,
                                           float *dxv = nullptr) {
  constexpr int IW = M::INTR_W, CA = M::A;
  if (m == 0.f) {  // masked slot: exact zeros, whatever its geometry
    for (int c = 0; c < M::ROW; ++c) {
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
  const float *rp = p + M::OFF_RP, *re = p + M::OFF_RE;
  float xw[3], xc[3];
  for (int a = 0; a < 3; ++a)
    xw[a] = rp[3 * a] * tx + rp[3 * a + 1] * ty + rp[3 * a + 2] * tz +
            p[M::OFF_TP + a];
  for (int a = 0; a < 3; ++a)
    xc[a] = re[3 * a] * xw[0] + re[3 * a + 1] * xw[1] + re[3 * a + 2] * xw[2] +
            p[M::OFF_TE + a];

  const float fx = p[0], px = p[1], fy = p[2], py = p[3];
  Lens<M> lens;
  lens.load(p);
  const float inv_z = 1.f / xc[2];
  const float x = xc[0] * inv_z, y = xc[1] * inv_z;
  const float r2 = x * x + y * y, xy = x * y;
  lens.forward(p, x, y, r2, xy);
  const float xd = lens.xd, yd = lens.yd;

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

  // intrinsics [fx, px, fy, py | distortion]; the affine four come after
  // any tilt, so their zeros stay zeros
  ru_row[0] = xd * mu;
  ru_row[1] = mu;
  ru_row[2] = 0.f;
  ru_row[3] = 0.f;
  rv_row[0] = 0.f;
  rv_row[1] = 0.f;
  rv_row[2] = yd * mv;
  rv_row[3] = mv;
  const float fmu = fx * mu, fmv = fy * mv;
  lens.columns(p, x, y, r2, xy, fmu, fmv, ru_row, rv_row);

  // d(u, v)/dXc
  float dxd_dx, dxd_dy, dyd_dx, dyd_dy;
  lens.jac(p, x, y, r2, xy, dxd_dx, dxd_dy, dyd_dx, dyd_dy);
  const float du_dx = fx * dxd_dx, du_dy = fx * dxd_dy;
  const float dv_dx = fy * dyd_dx, dv_dy = fy * dyd_dy;
  const float du[3] = {du_dx * inv_z, du_dy * inv_z,
                       -(du_dx * x + du_dy * y) * inv_z};
  const float dv[3] = {dv_dx * inv_z, dv_dy * inv_z,
                       -(dv_dx * x + dv_dy * y) * inv_z};

  // extrinsic rotation: dXc/drve[j] = dRe[j] Xw
  for (int j = 0; j < 3; ++j) {
    const float *d = p + M::OFF_DRE + 9 * j;
    float su = 0.f, sv = 0.f;
    for (int a = 0; a < 3; ++a) {
      const float dxc = d[3 * a] * xw[0] + d[3 * a + 1] * xw[1] + d[3 * a + 2] * xw[2];
      su += du[a] * dxc;
      sv += dv[a] * dxc;
    }
    ru_row[IW + j] = su * mu;
    rv_row[IW + j] = sv * mv;
  }
  // extrinsic translation: dXc/dte = I
  for (int a = 0; a < 3; ++a) {
    ru_row[IW + 3 + a] = du[a] * mu;
    rv_row[IW + 3 + a] = dv[a] * mv;
  }
  // pose rotation: dXc/drvp[j] = Re dRp[j] X
  for (int j = 0; j < 3; ++j) {
    const float *d = p + M::OFF_DRP + 9 * j;
    float dxw[3];
    for (int a = 0; a < 3; ++a)
      dxw[a] = d[3 * a] * tx + d[3 * a + 1] * ty + d[3 * a + 2] * tz;
    float su = 0.f, sv = 0.f;
    for (int a = 0; a < 3; ++a) {
      const float dxc = re[3 * a] * dxw[0] + re[3 * a + 1] * dxw[1] + re[3 * a + 2] * dxw[2];
      su += du[a] * dxc;
      sv += dv[a] * dxc;
    }
    ru_row[CA + j] = su * mu;
    rv_row[CA + j] = sv * mv;
  }
  // pose translation: dXc/dtp = Re
  for (int b = 0; b < 3; ++b) {
    float su = 0.f, sv = 0.f;
    for (int a = 0; a < 3; ++a) {
      su += du[a] * re[3 * a + b];
      sv += dv[a] * re[3 * a + b];
    }
    ru_row[CA + 3 + b] = su * mu;
    rv_row[CA + 3 + b] = sv * mv;
  }
  ru_row[M::W - 1] = r_u;
  rv_row[M::W - 1] = r_v;
  ru_row[M::ROW - 1] = cu;
  rv_row[M::ROW - 1] = cv;

  if constexpr (WITH_DXC) {
    for (int a = 0; a < 3; ++a) {
      dxu[a] = du[a] * mu;
      dxv[a] = dv[a] * mv;
    }
  }
}

// The standard model's rows (Kernels C-F).
template <bool WITH_DXC = false>
__device__ __forceinline__ void key_rows(const float *p, float tx, float ty,
                                         float tz, float u, float v, float m,
                                         int loss, int component, float c2,
                                         float *ru_row, float *rv_row,
                                         float *dxu = nullptr,
                                         float *dxv = nullptr) {
  key_rows_m<Standard, WITH_DXC>(p, tx, ty, tz, u, v, m, loss, component, c2,
                                 ru_row, rv_row, dxu, dxv);
}

// Entry e of the GW x GW gram's upper triangle -> gram (i, j), i <= j.
template <int GW = W>
__device__ __forceinline__ void entry_ij(int e, int &i, int &j) {
  i = 0;
  while (e >= GW - i) {
    e -= GW - i;
    ++i;
  }
  j = i + e;
}

}  // namespace pct_core
