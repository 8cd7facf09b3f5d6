"""Calibration uncertainty: parameter covariances from the solved system.

Counterpart of ``pycamset_tpu/optim/uncertainty.py``: first-order error
propagation of the bundle adjustment,

    Cov(x) ~= sigma^2 (J^T J)^{-1},   sigma^2 = RSS / (n_res - n_free),

at the solution, with the sparse Jacobian of
``driver.make_optimisation_function``: the residuals and the local
Jacobians are evaluated on ``device`` (the card unless the caller names
another: float32 there, float64 on the CPU), the covariance is assembled
and inverted in float64 on the host (numpy and scipy), as in the JAX
package. Gauge-fixed and user-fixed parameters carry zero uncertainty
(they are not in the free vector).

The routes, by the free-parameter count and the handler: the dense
Jacobi-equilibrated inverse (``parameter_covariance``) up to
``DENSE_COV_MAX_PARAMS``; above it the Schur selected inverse of
``_sparse_sigma`` when the free tail is a block of 3D points (head at most
``SCHUR_HEAD_MAX``), else head-only sigmas from a sparse LU in batches of
``_LU_BATCH`` columns; a tied (``shared_intrinsics``) calibration folds J
through the tying map first (``_tied_sigma``).

Float32 residuals and Jacobians carry their rounding into the covariance:
the equilibrated inverse amplifies it along the weakly constrained
directions, so a card's sigmas differ from the float64 CPU ones most
there.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

# above this many free parameters the dense inverse is skipped; sigmas
# come from a sparse factorization (see calibration_uncertainty)
DENSE_COV_MAX_PARAMS = 6000


def _weighted_r_jac(param_handler, x, device="cuda", dtype=None):
    """Residuals + sparse Jacobian at x, IRLS-weighted to match the
    calibration's robust loss (the solver's own objective)."""
    from pycamset_tpu_torch.optim.driver import make_optimisation_function
    from pycamset_tpu_torch.optim.losses import make_loss

    if getattr(param_handler.op_fun, "aux_width", 0):
        raise NotImplementedError(
            "calibration_uncertainty does not yet support rolling-shutter "
            "(per-detection aux input) chains — the CSR jacobian assembly "
            "covers the global-shutter chains only")
    # the solution stands in for the start where one is given: the start
    # only fills the free entries, which x overwrites (and a handler loaded
    # from a file would otherwise seed by PnP, which needs OpenCV)
    loss_fn, jac_fn, x0 = make_optimisation_function(
        param_handler, device=device, x0=x, dtype=dtype)
    x = np.asarray(x0 if x is None else x, dtype=float)
    r = np.asarray(loss_fn(x), dtype=float).reshape(-1)
    jac = jac_fn(x)

    loss = param_handler.problem_opts.get("loss", "linear")
    if loss != "linear":
        from scipy.sparse import diags
        _rho, weight_fn = make_loss(
            loss, float(param_handler.problem_opts.get("f_scale", 1.0)))
        semantics = param_handler.problem_opts.get("loss_semantics",
                                                   "component")

        def sqrt_weight(s):
            return np.sqrt(weight_fn(torch.as_tensor(s)).numpy())

        if semantics == "component":
            sw = sqrt_weight(r * r)
        else:  # per 2-D observation
            sw = np.repeat(sqrt_weight(np.sum(r.reshape(-1, 2) ** 2,
                                              axis=1)), 2)
        r = r * sw
        jac = diags(sw) @ jac
    return r, jac, x


def _equilibrated_inverse(jtj: np.ndarray, warn: bool):
    """(inverse of the Jacobi-scaled system, the scale d): raw BA
    parameters mix px-scale intrinsics with metre-scale geometry (cond(JtJ)
    near 1e16+), so the system is scaled by 1/sqrt(diag) to O(1)
    conditioning; the covariance transforms back exactly."""
    d = 1.0 / np.sqrt(np.maximum(np.diag(jtj), np.finfo(float).tiny))
    scaled = jtj * d[:, None] * d[None, :]
    try:
        return np.linalg.inv(scaled), d
    except np.linalg.LinAlgError:
        if warn:
            logging.warning(
                "J^T J is singular at the solution (degenerate geometry or "
                "an unconstrained gauge direction); falling back to the "
                "pseudo-inverse — sigmas along null directions read as the "
                "minimum-norm values, not true uncertainties")
        return np.linalg.pinv(scaled), d


def parameter_covariance(param_handler, x=None, device="cuda", dtype=None):
    """Covariance of the FREE parameter vector at the solution.

    Robust-loss calibrations are IRLS-weighted with the solver's own
    weights (first-order Gauss-Newton approximation of the robust
    covariance), so down-weighted outliers do not inflate sigma^2.

    :param x: the solved free vector (defaults to the handler's start:
        pass the optimiser's ``res["x"]``).
    :param device, dtype: where and in which precision the residuals and
        Jacobian are evaluated (dtype as ``config.default_device_dtype``
        unless given).
    :return: (cov (n_free, n_free), sigma (n_free,), sigma2, dof)
    """
    r, jac, _x = _weighted_r_jac(param_handler, x, device, dtype)
    n_res, n_free = jac.shape
    if n_free > DENSE_COV_MAX_PARAMS:
        raise ValueError(
            f"{n_free} free parameters: the dense covariance would be "
            "infeasible — use calibration_uncertainty (sparse sigmas) or "
            "fix parameters")
    dof = max(n_res - n_free, 1)
    sigma2 = float(r @ r) / dof

    jtj = np.asarray((jac.T @ jac).todense(), dtype=float)
    cov_s, d = _equilibrated_inverse(jtj, warn=True)
    cov = sigma2 * cov_s * d[:, None] * d[None, :]
    return cov, np.sqrt(np.clip(np.diag(cov), 0.0, None)), sigma2, dof


# camera/pose/extra columns the Schur path will densify; above this the
# head itself is too large and sigmas fall back to batched LU columns
SCHUR_HEAD_MAX = 8000
_LU_BATCH = 64  # identity columns solved per batch (bounds the dense RHS)


def _blockdiag_inverse(D, groups: np.ndarray):
    """Inverse of a block-diagonal sparse matrix whose blocks are the
    ``groups``-partitioned columns (each group <= 3 wide: one 3D point's
    free coordinates). Returns a CSR matrix."""
    from scipy.sparse import csr_matrix

    t = D.shape[0]
    n_grp = int(groups.max()) + 1 if t else 0
    # local position of each column inside its group
    sizes = np.bincount(groups, minlength=n_grp)
    if sizes.max(initial=0) > 3:
        raise ValueError("point blocks wider than 3 — not a point tail")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    local = np.arange(t) - offsets[groups]

    blocks = np.zeros((n_grp, 3, 3))
    blocks[:, [0, 1, 2], [0, 1, 2]] = 1.0  # identity padding for short blocks
    coo = D.tocoo()
    gi, gj = groups[coo.row], groups[coo.col]
    if np.any(gi != gj):
        raise ValueError("point tail couples across points — not "
                         "block-diagonal")
    blocks[gi, local[coo.row], local[coo.col]] = coo.data
    inv = np.linalg.inv(blocks)

    # scatter the real (non-padding) entries back to sparse
    rows, cols, vals = [], [], []
    for k in range(3):
        for m in range(3):
            keep = (sizes > k) & (sizes > m)
            g = np.nonzero(keep)[0]
            rows.append(offsets[g] + k)
            cols.append(offsets[g] + m)
            vals.append(inv[g, k, m])
    return csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(t, t))


def _sparse_sigma(param_handler, x, n_head_cols: int,
                  tail_groups: np.ndarray | None = None, device="cuda",
                  dtype=None):
    """Sigmas of ALL free parameters where the dense inverse cannot be
    formed.

    When ``tail_groups`` maps every free column past ``n_head_cols`` onto
    its 3D point, the point block is eliminated exactly (Schur selected
    inverse): head sigmas from diag(S^-1) of the reduced camera system
    S = A - W D^-1 W^T, point sigmas from the diagonal 3x3 blocks of
    D^-1 + D^-1 W^T S^-1 W D^-1. Without a grouping (or a
    non-block-diagonal tail) the head columns are solved through a sparse
    LU in fixed-size batches and tail sigmas stay unreported.

    :return: (sigma (n_free,), sigma2, dof, points_solved)
    """
    from scipy.linalg import lu_factor, lu_solve
    from scipy.sparse import diags
    from scipy.sparse.linalg import splu

    r, jac, _x = _weighted_r_jac(param_handler, x, device, dtype)
    n_res, n_free = jac.shape
    dof = max(n_res - n_free, 1)
    sigma2 = float(r @ r) / dof
    jtj = (jac.T @ jac).tocsc()
    # same Jacobi equilibration as the dense path
    d = 1.0 / np.sqrt(np.maximum(jtj.diagonal(), np.finfo(float).tiny))
    jtj_s = (diags(d) @ jtj @ diags(d)).tocsc()
    h = n_head_cols
    t = n_free - h

    if (tail_groups is not None and t > 0 and h <= SCHUR_HEAD_MAX
            and tail_groups.size == t):
        try:
            A = jtj_s[:h, :h].toarray()
            W = jtj_s[:h, h:].tocsr()
            D = jtj_s[h:, h:]
            groups = np.unique(tail_groups, return_inverse=True)[1]
            Dinv = _blockdiag_inverse(D, groups)
            S = A - (W @ Dinv @ W.T).toarray()
            # LU, not Cholesky: near-singular self-cal systems are only
            # semi-definite in floats (matches the dense path's inv())
            cf = lu_factor(S)
            s_inv_diag = np.diag(lu_solve(cf, np.eye(h)))
            # selected inverse of the point blocks, chunked over points
            U = (W @ Dinv).tocsc()
            tail_diag = np.asarray(Dinv.diagonal())
            chunk = max(1, min(t, (1 << 25) // max(h, 1)))  # ~256MB f64 cap
            for lo in range(0, t, chunk):
                hi = min(lo + chunk, t)
                Uc = U[:, lo:hi].toarray()
                Vc = lu_solve(cf, Uc)
                tail_diag[lo:hi] += np.einsum("ij,ij->j", Uc, Vc)
            diag_scaled = np.concatenate([s_inv_diag, tail_diag])
            sigma = np.sqrt(np.clip(diag_scaled * d * d * sigma2, 0.0, None))
            return sigma, sigma2, dof, True
        except (np.linalg.LinAlgError, ValueError) as err:
            logging.warning(
                "Schur covariance failed (%s); falling back to head-only "
                "sparse sigmas", err)

    lu = splu(jtj_s)
    sigma = np.zeros(n_free)
    head = np.arange(h)
    for lo in range(0, h, _LU_BATCH):  # batched: bounds the dense RHS
        cols = head[lo:lo + _LU_BATCH]
        rhs = np.zeros((n_free, cols.size))
        rhs[cols, np.arange(cols.size)] = 1.0
        sol = lu.solve(rhs)
        sigma[cols] = np.sqrt(np.clip(
            sol[cols, np.arange(cols.size)] * d[cols] ** 2 * sigma2,
            0.0, None))
    return sigma, sigma2, dof, False


def _tied_sigma(param_handler, x, free_mask: np.ndarray, n_c: int, w: int,
                device="cuda", dtype=None):
    """Sigmas for a shared-intrinsics (tied) calibration.

    The solve constrained every camera of a lens group to one intrinsic
    vector: fold J through the tying map G (untied free -> tied free:
    intrinsic columns collapse onto their group's block, everything else
    passes through), invert the TIED system, and broadcast the shared
    sigmas back to every camera.

    :return: (sigma over the untied free layout, sigma2, dof)
    """
    from scipy.sparse import csr_matrix

    from pycamset_tpu_torch.optim.shared_intr import resolve_lens_groups

    gid = resolve_lens_groups(
        param_handler.problem_opts.get("shared_intrinsics"),
        param_handler.cam_names)
    n_groups = int(gid.max()) + 1
    r, jac, _x = _weighted_r_jac(param_handler, x, device, dtype)
    free_idx = np.nonzero(free_mask)[0]
    n_free = free_idx.size
    intr_span = w * n_c
    tied_of = np.empty(n_free, dtype=np.int64)
    next_id = n_groups * w
    for k, fi in enumerate(free_idx):
        if fi < intr_span:
            tied_of[k] = gid[fi // w] * w + fi % w
        else:
            tied_of[k] = next_id
            next_id += 1
    n_tied = next_id
    g = csr_matrix((np.ones(n_free), (np.arange(n_free), tied_of)),
                   shape=(n_free, n_tied))
    jtj_t = np.asarray((g.T @ (jac.T @ jac) @ g).todense(), dtype=float)
    n_res = jac.shape[0]
    dof = max(n_res - n_tied, 1)
    sigma2 = float(r @ r) / dof
    cov_s, d = _equilibrated_inverse(jtj_t, warn=False)
    sigma_t = np.sqrt(np.clip(np.diag(cov_s) * d * d * sigma2, 0.0, None))
    return sigma_t[tied_of], sigma2, dof


def _scatter_free(prim, sigma_free: np.ndarray) -> np.ndarray:
    """Free-vector sigmas -> full-layout sigmas (0 for fixed params)."""
    full = np.zeros(prim.unfixed_full().shape[0])
    full[prim.unfixed_full()] = sigma_free
    return full


def calibration_uncertainty(camset, x=None, device="cuda", dtype=None
                            ) -> dict:
    """Per-parameter standard errors of a calibrated CameraSet (also one
    loaded from a ``.camset`` file).

    Requires the calibration history (``camset.calibration_handler``).

    :param x: the solved free vector (default: the CameraSet's
        ``calibration_params``).
    :param device: where the residuals and Jacobian are evaluated (the
        card unless the caller names another).
    :param dtype: their precision (default as
        ``config.default_device_dtype``: float32 on a card).
    :return: dict with
        - ``"cameras"``: {name: {"int_sigma" (intr_w,), "ext_sigma" (6,)}}
          — intrinsic rows are [fx, px, fy, py | dist...] in the model's
          packed order; extrinsic rows [rvec (rad), t (m)];
        - ``"pose_sigma"``: (n_ims, 6) per-image target-pose sigmas;
        - ``"point_sigma"``: (n_points, 3) for self-calibration handlers
          (absent otherwise, and on the head-only sparse route);
        - ``"extra_sigma"``: the free parameters between the poses and the
          points (e.g. a multi-target handler's relative poses), if any;
        - ``"sigma2"``, ``"dof"``: the residual variance (px^2) and its
          degrees of freedom.
    """
    handler = camset.calibration_handler
    if handler is None:
        raise ValueError("the CameraSet has no calibration history")
    if x is None:
        x = camset.calibration_params

    prim = handler.bundlePrimitive
    free_mask = np.asarray(prim.unfixed_full(), dtype=bool)
    n_c = prim.intr.shape[0]
    w = prim.intr_width
    n_p = prim.poses.shape[0]
    pose_lo = (w + 6) * n_c
    pose_hi = pose_lo + 6 * n_p

    points_available = True
    if handler.problem_opts.get("shared_intrinsics"):
        # tied calibration: every camera reports its group's shared lens
        sigma_free, sigma2, dof = _tied_sigma(handler, x, free_mask, n_c, w,
                                              device, dtype)
    elif int(free_mask.sum()) > DENSE_COV_MAX_PARAMS:
        # large self-cal: eliminate the trailing free-geometry block via a
        # Schur selected inverse
        bp = getattr(prim, "bundle_pts", None)
        pt_lo = free_mask.size - (bp.size if bp is not None else 0)
        head = int(free_mask[:pt_lo].sum())
        free_idx = np.nonzero(free_mask)[0]
        tail_groups = ((free_idx[head:] - pt_lo) // 3
                       if free_idx.size > head else None)
        sigma_free, sigma2, dof, points_available = _sparse_sigma(
            handler, x, head, tail_groups, device, dtype)
        if not points_available:
            logging.warning(
                "%d free parameters: camera/pose sigmas via a sparse "
                "factorization; point sigmas were not solved at this scale",
                int(free_mask.sum()))
    else:
        _cov, sigma_free, sigma2, dof = parameter_covariance(handler, x,
                                                             device, dtype)
    full = _scatter_free(prim, sigma_free)

    intr_sig = full[:w * n_c].reshape(n_c, w)
    extr_sig = full[w * n_c:pose_lo].reshape(n_c, 6)
    pose_sig = full[pose_lo:pose_hi].reshape(n_p, 6)

    out = {
        "cameras": {
            name: {"int_sigma": intr_sig[i], "ext_sigma": extr_sig[i]}
            for i, name in enumerate(handler.cam_names)
        },
        "pose_sigma": pose_sig,
        "sigma2": sigma2,
        "dof": dof,
    }
    # the trailing block is the primitive's free geometry (bundle_pts,
    # matching base_full's layout); anything between the poses and it is
    # reported separately instead of being mislabelled as points
    tail = full[pose_hi:]
    bp = getattr(prim, "bundle_pts", None)
    if not points_available:
        pass  # sparse path: geometry sigmas were not solved for
    elif bp is not None and tail.size >= bp.size > 0:
        if tail.size > bp.size:
            out["extra_sigma"] = tail[:tail.size - bp.size]
        out["point_sigma"] = tail[tail.size - bp.size:].reshape(-1, 3)
    elif tail.size:
        out["extra_sigma"] = tail
    return out
