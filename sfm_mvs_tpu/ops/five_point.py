"""Nister 5-point minimal essential-matrix solver, jit/vmap-native.

The reference's ``cv2.findEssentialMat`` (sfm.py:307) runs OpenCV's Nister
5-point solver inside sequential RANSAC. This module implements the same
algebra (Nister, "An efficient solution to the five-point relative pose
problem", PAMI 2004) in a fully jit/vmap-compatible form so RANSAC can
solve thousands of minimal samples simultaneously (ransac.py).

Accelerator constraints shape the design:
  * ``jnp.linalg.eig`` (nonsymmetric) is CPU-only in JAX, so the classic
    Stewenius 10x10 action-matrix eigendecomposition is unavailable. We
    follow Nister's original reduction instead: Gauss-Jordan elimination
    of the 10x20 cubic-constraint matrix (a single batched 10x10 solve),
    then the 3x3 polynomial determinant giving a degree-10 univariate
    polynomial in z.
  * Root finding must be fixed-shape: we locate real roots by sign
    changes of the polynomial on a tan-spaced grid covering (-inf, inf)
    (evaluating the reversed polynomial at 1/z for |z| > 1 to avoid f32
    overflow), bisect each bracket a fixed number of iterations, then
    polish with a few guarded Newton steps. Up to 10 roots, carried with
    a validity mask — the RANSAC harness zeroes the inlier count of
    invalid slots.
  * All polynomial expansion happens at *trace time* with Python dicts
    keyed by monomial exponents holding jnp scalar coefficients, so the
    compiled program is pure fixed-shape arithmetic.

Unlike the 8-point solver (epipolar.essential_eight_point), the 5-point
solver is exact on planar scenes and needs only 5 correspondences — the
two robustness regimes the reference's OpenCV solver covers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Monomial = tuple[int, int, int]  # exponents of (x, y, z)
Poly = dict  # Monomial -> jnp scalar coefficient


# ---------------------------------------------------------------------------
# Trace-time polynomial arithmetic in (x, y, z)
# ---------------------------------------------------------------------------

def _padd(a: Poly, b: Poly) -> Poly:
    out = dict(a)
    for e, c in b.items():
        out[e] = out[e] + c if e in out else c
    return out


def _psub(a: Poly, b: Poly) -> Poly:
    out = dict(a)
    for e, c in b.items():
        out[e] = out[e] - c if e in out else -c
    return out


def _pmul(a: Poly, b: Poly) -> Poly:
    out: Poly = {}
    for ea, ca in a.items():
        for eb, cb in b.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            prod = ca * cb
            out[e] = out[e] + prod if e in out else prod
    return out


def _pscale(a: Poly, s) -> Poly:
    return {e: c * s for e, c in a.items()}


def _mat_pmul(A, B):
    """3x3 matrix product of polynomial-entry matrices."""
    return [
        [
            _padd(_padd(_pmul(A[i][0], B[0][j]), _pmul(A[i][1], B[1][j])),
                  _pmul(A[i][2], B[2][j]))
            for j in range(3)
        ]
        for i in range(3)
    ]


def _pdet3(M) -> Poly:
    a = _pmul(M[0][0], _psub(_pmul(M[1][1], M[2][2]), _pmul(M[1][2], M[2][1])))
    b = _pmul(M[0][1], _psub(_pmul(M[1][0], M[2][2]), _pmul(M[1][2], M[2][0])))
    c = _pmul(M[0][2], _psub(_pmul(M[1][0], M[2][1]), _pmul(M[1][1], M[2][0])))
    return _padd(_psub(a, b), c)


# Nister's monomial ordering for the 10x20 constraint matrix. The first 10
# columns are eliminated by Gauss-Jordan; the trailing 10 are the "tail"
# monomials that survive into the B(z) determinant.
_LEAD: list[Monomial] = [
    (3, 0, 0),  # x^3
    (0, 3, 0),  # y^3
    (2, 1, 0),  # x^2 y
    (1, 2, 0),  # x y^2
    (2, 0, 1),  # x^2 z   <- row <e>
    (2, 0, 0),  # x^2     <- row <f>
    (0, 2, 1),  # y^2 z   <- row <g>
    (0, 2, 0),  # y^2     <- row <h>
    (1, 1, 1),  # x y z   <- row <i>
    (1, 1, 0),  # x y     <- row <j>
]
_TAIL: list[Monomial] = [
    (1, 0, 2),  # x z^2
    (1, 0, 1),  # x z
    (1, 0, 0),  # x
    (0, 1, 2),  # y z^2
    (0, 1, 1),  # y z
    (0, 1, 0),  # y
    (0, 0, 3),  # z^3
    (0, 0, 2),  # z^2
    (0, 0, 1),  # z
    (0, 0, 0),  # 1
]


def _constraint_matrix(E1, E2, E3, E4):
    """10x20 coefficient matrix of Nister's cubic constraints.

    E(x,y,z) = x E1 + y E2 + z E3 + E4 (w normalized to 1). The ten cubics
    are det(E) = 0 and the nine entries of 2 E E^T E - tr(E E^T) E = 0.
    """
    dtype = E4.dtype
    X: Monomial = (1, 0, 0)
    Y: Monomial = (0, 1, 0)
    Z: Monomial = (0, 0, 1)
    ONE: Monomial = (0, 0, 0)
    E = [
        [
            {X: E1[i, j], Y: E2[i, j], Z: E3[i, j], ONE: E4[i, j]}
            for j in range(3)
        ]
        for i in range(3)
    ]
    Et = [[E[j][i] for j in range(3)] for i in range(3)]
    EEt = _mat_pmul(E, Et)
    tr = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    EEtE = _mat_pmul(EEt, E)

    polys = [_pdet3(E)]
    for i in range(3):
        for j in range(3):
            polys.append(
                _psub(_pscale(EEtE[i][j], jnp.asarray(2.0, dtype)),
                      _pmul(tr, E[i][j]))
            )

    zero = jnp.asarray(0.0, dtype)
    cols = _LEAD + _TAIL
    rows = [jnp.stack([p.get(m, zero) for m in cols]) for p in polys]
    return jnp.stack(rows)  # (10, 20)


# ---------------------------------------------------------------------------
# Degree-10 real-root extraction (fixed shape)
# ---------------------------------------------------------------------------

def _polyval(coeffs, z):
    """Horner evaluation; coeffs highest-degree first, any broadcastable z."""
    acc = jnp.zeros_like(z) + coeffs[0]
    for k in range(1, coeffs.shape[0]):
        acc = acc * z + coeffs[k]
    return acc


def _safe_eval(coeffs, coeffs_rev, z):
    """n(z) up to a positive factor, overflow-free: for |z|>1 evaluate the
    reversed polynomial at 1/z (n(z) = z^10 * n_rev(1/z); z^10 >= 0)."""
    inner = jnp.abs(z) <= 1.0
    zi = jnp.where(inner, z, 1.0 / jnp.where(z == 0, 1.0, z))
    return jnp.where(inner, _polyval(coeffs, zi), _polyval(coeffs_rev, zi))


def _safe_sign_eval(coeffs, coeffs_rev, z):
    return jnp.sign(_safe_eval(coeffs, coeffs_rev, z))


N_ROOT_SLOTS = 14  # 10 sign-change brackets + 4 local-minimum candidates


def real_roots_deg10(coeffs: jnp.ndarray, grid: int = 1024,
                     bisect_iters: int = 40, newton_iters: int = 3):
    """Real-root *candidates* of a degree-10 polynomial (coeffs (11,),
    highest first).

    Returns (roots (N_ROOT_SLOTS,), valid (N_ROOT_SLOTS,) bool). Sign-change
    bracketing on a tan-spaced grid over (-inf, inf), fixed-iteration
    bisection, then guarded Newton polish (in 1/z coordinates for |z| > 1).
    Slots 10..13 are the grid points with the smallest local minima of
    |n| — candidates for near-double roots whose sign change is lost to
    f32 coefficient noise (this happens systematically on planar scenes,
    whose twisted-pair solutions cluster). Callers must validate those
    candidates against the original equations (essential_five_point
    polishes every candidate with Gauss-Newton on the 10 cubic constraints
    and re-checks the residual).
    """
    dtype = coeffs.dtype
    scale = jnp.maximum(jnp.max(jnp.abs(coeffs)), 1e-30)
    c = coeffs / scale
    c_rev = c[::-1]

    theta = jnp.linspace(-jnp.pi / 2 + 1e-3, jnp.pi / 2 - 1e-3, grid,
                         dtype=dtype)
    zs = jnp.tan(theta)
    vals = _safe_eval(c, c_rev, zs)
    signs = jnp.sign(vals)
    flips = signs[:-1] * signs[1:] < 0  # (grid-1,)

    # First 10 bracket indices, fixed shape: invalid slots point past end.
    idx = jnp.where(flips, jnp.arange(grid - 1), grid)
    idx = jnp.sort(idx)[:10]
    valid = idx < grid
    idx = jnp.minimum(idx, grid - 2)

    # Near-double-root candidates: the 4 deepest interior local minima of
    # |n| that are not already sign changes. (A complex pair sitting just
    # off the real axis — a double root merged by f32 noise — leaves a
    # sharp dip with no crossing.)
    mag = jnp.abs(vals)
    locmin = (mag[1:-1] <= mag[:-2]) & (mag[1:-1] <= mag[2:])
    near_flip = flips[:-1] | flips[1:]
    cand_mag = jnp.where(locmin & ~near_flip, mag[1:-1], jnp.inf)
    _, cand_pos = jax.lax.top_k(-cand_mag, 4)
    extra_z = zs[cand_pos + 1]
    extra_valid = jnp.isfinite(cand_mag[cand_pos])

    lo = zs[idx]
    hi = zs[idx + 1]
    slo = _safe_sign_eval(c, c_rev, lo)

    def bisect(_, carry):
        lo, hi, slo = carry
        mid = 0.5 * (lo + hi)
        smid = _safe_sign_eval(c, c_rev, mid)
        go_left = slo * smid < 0
        return (jnp.where(go_left, lo, mid),
                jnp.where(go_left, mid, hi),
                jnp.where(go_left, slo, smid))

    lo, hi, _ = jax.lax.fori_loop(0, bisect_iters, bisect, (lo, hi, slo))
    z = 0.5 * (lo + hi)

    # Newton polish; for |z| > 1 polish u = 1/z on the reversed polynomial.
    dc = c[:-1] * jnp.arange(10, 0, -1, dtype=dtype)
    dc_rev = c_rev[:-1] * jnp.arange(10, 0, -1, dtype=dtype)

    def newton(_, z):
        inner = jnp.abs(z) <= 1.0
        u = jnp.where(inner, z, 1.0 / jnp.where(z == 0, 1.0, z))
        f = jnp.where(inner, _polyval(c, u), _polyval(c_rev, u))
        df = jnp.where(inner, _polyval(dc, u), _polyval(dc_rev, u))
        step = f / jnp.where(jnp.abs(df) < 1e-20, 1e-20, df)
        step = jnp.clip(step, -0.1, 0.1)  # stay inside the bracket basin
        u2 = u - step
        return jnp.where(inner, u2, 1.0 / jnp.where(u2 == 0, 1e-20, u2))

    z = jax.lax.fori_loop(0, newton_iters, newton, z)
    return (jnp.concatenate([z, extra_z]),
            jnp.concatenate([valid, extra_valid]))


# ---------------------------------------------------------------------------
# The minimal solver
# ---------------------------------------------------------------------------

def essential_five_point(pts1: jnp.ndarray, pts2: jnp.ndarray):
    """All essential matrices consistent with 5 correspondences.

    pts1, pts2: (5, 2) *normalized camera* coordinates (K^-1 pixels), the
    same convention as essential_eight_point. Returns
    (Es (N_ROOT_SLOTS, 3, 3), valid (N_ROOT_SLOTS,) bool): up to 10 real
    solutions plus recovered near-double-root candidates, each projected
    onto the essential manifold; invalid slots are garbage and must be
    masked. Validity is gated on the final normalized constraint residual,
    so duplicate slots may carry the same solution (harmless in RANSAC).

    Fully vmappable: RANSAC maps this over thousands of minimal samples.
    """
    dtype = pts1.dtype
    x1, y1 = pts1[:, 0], pts1[:, 1]
    x2, y2 = pts2[:, 0], pts2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )  # (5, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    E1 = Vt[5].reshape(3, 3)
    E2 = Vt[6].reshape(3, 3)
    E3 = Vt[7].reshape(3, 3)
    E4 = Vt[8].reshape(3, 3)

    M = _constraint_matrix(E1, E2, E3, E4)
    # Row-normalize before elimination: f32 conditioning aid.
    M = M / jnp.maximum(
        jnp.linalg.norm(M, axis=1, keepdims=True), 1e-30)
    # Gauss-Jordan: reduced system [I | X] @ monomials = 0.
    X = jnp.linalg.solve(M[:, :10], M[:, 10:])  # (10, 10)

    # <k> = <e> - z<f>, <l> = <g> - z<h>, <m> = <i> - z<j>. Tail columns:
    # [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1].
    def kx_ky_kc(a, b):
        """Rows a (leading mono*z) and b (leading mono): coefficient polys
        (highest degree first) of x, y, 1 in <a> - z<b>."""
        ra, rb = X[a], X[b]
        px = jnp.stack([-rb[0], ra[0] - rb[1], ra[1] - rb[2], ra[2]])
        py = jnp.stack([-rb[3], ra[3] - rb[4], ra[4] - rb[5], ra[5]])
        pc = jnp.stack(
            [-rb[6], ra[6] - rb[7], ra[7] - rb[8], ra[8] - rb[9], ra[9]])
        return px, py, pc

    kx, ky, kc = kx_ky_kc(4, 5)
    lx, ly, lc = kx_ky_kc(6, 7)
    mx, my, mc = kx_ky_kc(8, 9)

    def conv(a, b):
        return jnp.convolve(a, b)

    # det(B(z)): degree 10 -> 11 coefficients, highest first.
    n = (conv(kx, conv(ly, mc) - conv(lc, my))
         - conv(ky, conv(lx, mc) - conv(lc, mx))
         + conv(kc, conv(lx, my) - conv(ly, mx)))

    roots, valid = real_roots_deg10(n)

    # Recover (x, y) per root: least squares on B(z) [x, y, 1]^T = 0.
    def xy_from_z(z):
        B = jnp.stack([
            jnp.stack([_polyval(kx, z), _polyval(ky, z), _polyval(kc, z)]),
            jnp.stack([_polyval(lx, z), _polyval(ly, z), _polyval(lc, z)]),
            jnp.stack([_polyval(mx, z), _polyval(my, z), _polyval(mc, z)]),
        ])  # (3, 3)
        Bxy = B[:, :2]
        rhs = -B[:, 2]
        G = Bxy.T @ Bxy + 1e-20 * jnp.eye(2, dtype=dtype)
        sol = jnp.linalg.solve(G, Bxy.T @ rhs)
        return sol[0], sol[1]

    xs, ys = jax.vmap(xy_from_z)(roots)

    # Gauss-Newton polish of each (x, y, z) against the 10 cubic
    # constraints: cleans the accumulated f32 noise of the elimination and
    # root extraction (measured: worst-case epipolar residual on
    # extra correspondences drops ~100x). 10 residuals, 3 unknowns.
    def constraints(p):
        x, y, z = p[0], p[1], p[2]
        one = jnp.ones_like(x)
        xp = [one, x, x * x, x * x * x]
        yp = [one, y, y * y, y * y * y]
        zp = [one, z, z * z, z * z * z]
        mono = jnp.stack(
            [xp[i] * yp[j] * zp[k] for (i, j, k) in _LEAD + _TAIL]
        )  # (20,)
        return M @ mono  # (10,)

    jac_c = jax.jacfwd(constraints)

    def polish(p, _):
        r = constraints(p)
        J = jac_c(p)  # (10, 3)
        G = J.T @ J + 1e-12 * jnp.eye(3, dtype=dtype)
        cand = p - jnp.linalg.solve(G, J.T @ r)
        better = jnp.sum(constraints(cand) ** 2) < jnp.sum(r * r)
        return jnp.where(better, cand, p), None

    def polish_root(x, y, z):
        p0 = jnp.stack([x, y, z])
        p, _ = jax.lax.scan(polish, p0, None, length=6)
        return p

    ps = jax.vmap(polish_root)(xs, ys, roots)
    xs, ys, roots = ps[:, 0], ps[:, 1], ps[:, 2]

    # Gate validity on the actual constraint residual (normalized by the
    # monomial magnitude): rejects local-minimum candidates that were not
    # merged roots, and any bracket the polish could not rescue.
    def resid(p):
        mono_norm = (1.0 + p[0] ** 2 + p[1] ** 2 + p[2] ** 2) ** 1.5
        return jnp.linalg.norm(constraints(p)) / mono_norm

    valid = valid & (jax.vmap(resid)(ps) < 1e-4)

    Es = (xs[:, None, None] * E1 + ys[:, None, None] * E2
          + roots[:, None, None] * E3 + E4)
    # Project each onto the essential manifold (sv -> (1, 1, 0)).
    U, _, Vh = jnp.linalg.svd(Es)
    diag = jnp.array([1.0, 1.0, 0.0], dtype=dtype)
    Es = (U * diag[None, None, :]) @ Vh
    return Es, valid
