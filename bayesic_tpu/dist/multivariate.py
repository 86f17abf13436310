"""Multivariate families: MultivariateNormal, Dirichlet, LKJCholesky.

Blueprint: SURVEY.md C1 — MVN (full-rank via Cholesky) backs the full-rank
Gaussian guide (C6); Dirichlet/LKJ back mixture weights and hierarchical
correlation priors.  All linear algebra is Cholesky-based (triangular solves,
no explicit inverses) so XLA lowers it to batched triangular ops.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import gammaln

from . import constraints
from .distribution import Distribution

__all__ = ["MultivariateNormal", "MultivariateStudentT", "MatrixNormal",
           "Wishart", "InverseWishart", "Dirichlet", "LKJCholesky"]

_LOG_2PI = math.log(2.0 * math.pi)


class MultivariateNormal(Distribution):
    """MVN parameterized by ``loc`` and lower-Cholesky ``scale_tril``
    (or ``covariance_matrix``, factorized once at construction)."""

    _params = ("loc", "scale_tril")
    support = constraints.real_vector

    def __init__(self, loc, scale_tril=None, covariance_matrix=None):
        if (scale_tril is None) == (covariance_matrix is None):
            raise ValueError("pass exactly one of scale_tril/covariance_matrix")
        if scale_tril is None:
            scale_tril = jnp.linalg.cholesky(covariance_matrix)
        self.loc = jnp.asarray(loc)
        self.scale_tril = jnp.asarray(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = jax.lax.broadcast_shapes(
            self.loc.shape[:-1], self.scale_tril.shape[:-2]
        )
        super().__init__(batch, (d,))

    _param_event_ndims = {"loc": 1, "scale_tril": 2}

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = jax.random.normal(key, shape, jnp.result_type(float))
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, eps)

    def log_prob(self, x):
        diff = x - self.loc
        # Solve L z = diff (jax's solve_triangular does not broadcast batch
        # dims, so broadcast explicitly first)
        batch = jax.lax.broadcast_shapes(
            diff.shape[:-1], self.scale_tril.shape[:-2]
        )
        tril = jnp.broadcast_to(
            self.scale_tril, batch + self.scale_tril.shape[-2:]
        )
        diff = jnp.broadcast_to(diff, batch + diff.shape[-1:])
        z = solve_triangular(tril, diff[..., None], lower=True)[..., 0]
        half_log_det = jnp.sum(
            jnp.log(jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1)), -1
        )
        d = self.event_shape[0]
        return (
            -0.5 * jnp.sum(z * z, -1) - half_log_det - 0.5 * d * _LOG_2PI
        )

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape + self.event_shape)

    @property
    def covariance(self):
        return jnp.einsum(
            "...ij,...kj->...ik", self.scale_tril, self.scale_tril
        )

    @property
    def variance(self):
        return jnp.sum(jnp.square(self.scale_tril), axis=-1)

    def entropy(self):
        d = self.event_shape[0]
        half_log_det = jnp.sum(
            jnp.log(jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1)), -1
        )
        return 0.5 * d * (1.0 + _LOG_2PI) + half_log_det


class Dirichlet(Distribution):
    _params = ("concentration",)
    support = constraints.simplex

    def __init__(self, concentration):
        self.concentration = jnp.asarray(concentration)
        super().__init__(
            self.concentration.shape[:-1], self.concentration.shape[-1:]
        )

    _param_event_ndims = {"concentration": 1}

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        conc = jnp.broadcast_to(
            self.concentration, shape + self.event_shape
        )
        return jax.random.dirichlet(key, conc, dtype=jnp.result_type(float))

    def log_prob(self, x):
        a = self.concentration
        return (
            jnp.sum((a - 1.0) * jnp.log(x), -1)
            + gammaln(jnp.sum(a, -1))
            - jnp.sum(gammaln(a), -1)
        )

    @property
    def mean(self):
        return self.concentration / jnp.sum(
            self.concentration, -1, keepdims=True
        )

    @property
    def variance(self):
        a = self.concentration
        a0 = jnp.sum(a, -1, keepdims=True)
        m = a / a0
        return m * (1.0 - m) / (a0 + 1.0)


class LKJCholesky(Distribution):
    """LKJ prior over Cholesky factors of correlation matrices.

    Density over the strict-lower-triangular coordinates of ``L``:
    ``p(L) ∝ prod_{i=2..d} L_ii^(d - i + 2*eta - 2)`` with the standard
    closed-form normalizer; samples drawn by the (vectorized) onion method.
    """

    _params = ("concentration",)
    support = constraints.corr_cholesky
    reparametrized = False

    def __init__(self, dimension, concentration=1.0):
        self.dimension = int(dimension)
        self.concentration = jnp.asarray(concentration)
        super().__init__(
            self.concentration.shape, (self.dimension, self.dimension)
        )

    def sample(self, key, sample_shape=()):
        d = self.dimension
        shape = tuple(sample_shape) + self.batch_shape
        eta = jnp.broadcast_to(self.concentration, shape)
        key_z, key_y = jax.random.split(key)
        ftype = jnp.result_type(float)

        # Row directions: normalize strict-lower gaussian rows.
        z = jax.random.normal(key_z, shape + (d, d), ftype)
        tril_mask = jnp.tril(jnp.ones((d, d), bool), -1)
        z = jnp.where(tril_mask, z, 0.0)
        norm = jnp.sqrt(jnp.sum(z * z, -1, keepdims=True))
        u = jnp.where(tril_mask, z / jnp.clip(norm, 1e-30), 0.0)

        # Squared radii y_k ~ Beta(k/2, eta + (d-1-k)/2) for rows k=1..d-1.
        k = jnp.arange(1, d, dtype=ftype)
        a = 0.5 * k
        b = eta[..., None] + 0.5 * (d - 1 - k)
        y = jax.random.beta(
            key_y, jnp.broadcast_to(a, shape + (d - 1,)),
            jnp.broadcast_to(b, shape + (d - 1,)), dtype=ftype,
        )

        rows = jnp.concatenate(
            [jnp.zeros(shape + (1,), ftype), y], axis=-1
        )  # row 0 has radius 0 (identity row)
        lower = u * jnp.sqrt(rows)[..., None]
        diag = jnp.sqrt(1.0 - rows)
        rng = jnp.arange(d)
        return lower.at[..., rng, rng].set(diag)

    def log_prob(self, x):
        d = self.dimension
        eta = self.concentration
        diag = jnp.diagonal(x, axis1=-2, axis2=-1)[..., 1:]
        order = jnp.arange(2, d + 1, dtype=jnp.result_type(float))
        unnorm = jnp.sum((d - order + 2.0 * eta[..., None] - 2.0)
                         * jnp.log(diag), -1)
        # log normalizer of the LKJ density over R, with the L->R Jacobian
        # folded in (the exponent above already absorbs it).
        k = jnp.arange(1, d, dtype=jnp.result_type(float))
        log_c = jnp.sum(
            0.5 * k * math.log(math.pi)
            + gammaln(eta[..., None] + 0.5 * (d - 1 - k))
            - gammaln(eta[..., None] + 0.5 * (d - 1)),
            -1,
        )
        return unnorm - log_c


class MultivariateStudentT(Distribution):
    """Multivariate Student-t with ``df`` degrees of freedom, location
    ``loc`` and lower-Cholesky ``scale_tril`` (SURVEY.md C1 — the
    heavy-tailed companion of MultivariateNormal for robust regression
    priors/likelihoods).  Sampling is the Gaussian scale-mixture
    ``x = loc + L z / sqrt(g/df)``, ``g ~ chi2(df)`` — reparameterized end
    to end because jax's gamma sampler carries implicit gradients."""

    _params = ("df", "loc", "scale_tril")
    support = constraints.real_vector

    def __init__(self, df, loc, scale_tril):
        self.df = jnp.asarray(df)
        self.loc = jnp.asarray(loc)
        self.scale_tril = jnp.asarray(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = jax.lax.broadcast_shapes(
            self.df.shape, self.loc.shape[:-1], self.scale_tril.shape[:-2]
        )
        super().__init__(batch, (d,))

    _param_event_ndims = {"df": 0, "loc": 1, "scale_tril": 2}

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        ftype = jnp.result_type(float)
        kz, kg = jax.random.split(key)
        z = jax.random.normal(kz, shape + self.event_shape, ftype)
        df = jnp.broadcast_to(self.df, shape).astype(ftype)
        g = 2.0 * jax.random.gamma(kg, 0.5 * df, dtype=ftype)  # chi2(df)
        y = jnp.einsum("...ij,...j->...i", self.scale_tril, z)
        return self.loc + y * jnp.sqrt(df / g)[..., None]

    def log_prob(self, x):
        d = self.event_shape[0]
        diff = x - self.loc
        batch = jax.lax.broadcast_shapes(
            diff.shape[:-1], self.scale_tril.shape[:-2]
        )
        tril = jnp.broadcast_to(
            self.scale_tril, batch + self.scale_tril.shape[-2:]
        )
        diff = jnp.broadcast_to(diff, batch + diff.shape[-1:])
        z = solve_triangular(tril, diff[..., None], lower=True)[..., 0]
        quad = jnp.sum(z * z, -1)
        half_log_det = jnp.sum(
            jnp.log(jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1)), -1
        )
        df = self.df
        return (
            gammaln(0.5 * (df + d)) - gammaln(0.5 * df)
            - 0.5 * d * (jnp.log(df) + math.log(math.pi)) - half_log_det
            - 0.5 * (df + d) * jnp.log1p(quad / df)
        )

    @property
    def mean(self):
        # defined for df > 1
        return jnp.broadcast_to(self.loc, self.batch_shape + self.event_shape)

    @property
    def variance(self):
        # defined for df > 2
        fac = (self.df / (self.df - 2.0))[..., None]
        return fac * jnp.sum(jnp.square(self.scale_tril), axis=-1)


class MatrixNormal(Distribution):
    """Matrix-variate normal MN(loc, U, V) with row covariance
    ``U = R R^T`` (``scale_tril_row``) and column covariance ``V = C C^T``
    (``scale_tril_column``).  ``log_prob`` needs only two batched
    triangular solves (no Kronecker materialization):
    ``tr(V^-1 D^T U^-1 D) = ||R^-1 D C^-T||_F^2``."""

    _params = ("loc", "scale_tril_row", "scale_tril_column")
    support = constraints.real_matrix

    def __init__(self, loc, scale_tril_row, scale_tril_column):
        self.loc = jnp.asarray(loc)
        self.scale_tril_row = jnp.asarray(scale_tril_row)
        self.scale_tril_column = jnp.asarray(scale_tril_column)
        n = self.scale_tril_row.shape[-1]
        p = self.scale_tril_column.shape[-1]
        batch = jax.lax.broadcast_shapes(
            self.loc.shape[:-2], self.scale_tril_row.shape[:-2],
            self.scale_tril_column.shape[:-2],
        )
        super().__init__(batch, (n, p))

    _param_event_ndims = {"loc": 2, "scale_tril_row": 2,
                          "scale_tril_column": 2}

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        z = jax.random.normal(key, shape, jnp.result_type(float))
        return self.loc + jnp.einsum(
            "...ij,...jk,...lk->...il", self.scale_tril_row, z,
            self.scale_tril_column,
        )

    def log_prob(self, x):
        n, p = self.event_shape
        diff = x - self.loc
        batch = jax.lax.broadcast_shapes(
            diff.shape[:-2], self.scale_tril_row.shape[:-2],
            self.scale_tril_column.shape[:-2],
        )
        r = jnp.broadcast_to(self.scale_tril_row, batch + (n, n))
        c = jnp.broadcast_to(self.scale_tril_column, batch + (p, p))
        diff = jnp.broadcast_to(diff, batch + (n, p))
        e = solve_triangular(r, diff, lower=True)            # R^-1 D
        f = solve_triangular(c, jnp.swapaxes(e, -1, -2), lower=True)
        quad = jnp.sum(f * f, (-2, -1))
        hld_r = jnp.sum(jnp.log(jnp.diagonal(r, axis1=-2, axis2=-1)), -1)
        hld_c = jnp.sum(jnp.log(jnp.diagonal(c, axis1=-2, axis2=-1)), -1)
        return (
            -0.5 * quad - p * hld_r - n * hld_c
            - 0.5 * n * p * _LOG_2PI
        )

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape + self.event_shape)

    @property
    def variance(self):
        u_diag = jnp.sum(jnp.square(self.scale_tril_row), -1)
        v_diag = jnp.sum(jnp.square(self.scale_tril_column), -1)
        return u_diag[..., :, None] * v_diag[..., None, :]


def _bartlett(key, df, scale_tril, d, shape, ftype):
    """Lower-triangular Bartlett factor B with W = B B^T ~ Wishart(df, S),
    S = scale_tril scale_tril^T: B = L A, A lower-tri with
    A_ii = sqrt(chi2(df - i)), A_ij ~ N(0,1) (i>j)."""
    kn, kg = jax.random.split(key)
    z = jax.random.normal(kn, shape + (d, d), ftype)
    a = jnp.where(jnp.tril(jnp.ones((d, d), bool), -1), z, 0.0)
    i = jnp.arange(d, dtype=ftype)
    half_df = 0.5 * (df[..., None] - i)          # chi2(df - i) / 2
    diag = jnp.sqrt(2.0 * jax.random.gamma(kg, half_df, dtype=ftype))
    rng = jnp.arange(d)
    a = a.at[..., rng, rng].set(diag)
    return jnp.einsum("...ij,...jk->...ik", scale_tril, a)


class Wishart(Distribution):
    """Wishart(df, S) over symmetric positive-definite matrices,
    parameterized by the lower-Cholesky factor ``scale_tril`` of the scale
    matrix S.  Sampling uses the Bartlett decomposition (one triangular
    matmul; gamma draws carry implicit-diff gradients, so
    the sampler is reparameterized); ``log_prob`` is Cholesky-only:
    ``tr(S^-1 W) = ||L_s^-1 L_w||_F^2``."""

    _params = ("df", "scale_tril")
    support = constraints.positive_definite

    def __init__(self, df, scale_tril):
        self.df = jnp.asarray(df)
        self.scale_tril = jnp.asarray(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = jax.lax.broadcast_shapes(
            self.df.shape, self.scale_tril.shape[:-2]
        )
        super().__init__(batch, (d, d))

    _param_event_ndims = {"df": 0, "scale_tril": 2}

    def sample(self, key, sample_shape=()):
        d = self.event_shape[0]
        shape = tuple(sample_shape) + self.batch_shape
        ftype = jnp.result_type(float)
        df = jnp.broadcast_to(self.df, shape).astype(ftype)
        tril = jnp.broadcast_to(self.scale_tril, shape + (d, d))
        b = _bartlett(key, df, tril, d, shape, ftype)
        return jnp.einsum("...ij,...kj->...ik", b, b)

    def log_prob(self, x):
        from jax.scipy.special import multigammaln

        d = self.event_shape[0]
        df = self.df
        batch = jax.lax.broadcast_shapes(
            x.shape[:-2], self.scale_tril.shape[:-2], df.shape
        )
        tril = jnp.broadcast_to(self.scale_tril, batch + (d, d))
        xw = jnp.broadcast_to(x, batch + (d, d))
        lw = jnp.linalg.cholesky(xw)
        m = solve_triangular(tril, lw, lower=True)
        trace = jnp.sum(m * m, (-2, -1))
        logdet_w = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(lw, axis1=-2, axis2=-1)), -1
        )
        logdet_s = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(tril, axis1=-2, axis2=-1)), -1
        )
        return (
            0.5 * (df - d - 1.0) * logdet_w - 0.5 * trace
            - 0.5 * df * (d * math.log(2.0) + logdet_s)
            - multigammaln(0.5 * df, d)
        )

    @property
    def mean(self):
        s = jnp.einsum(
            "...ij,...kj->...ik", self.scale_tril, self.scale_tril
        )
        return self.df[..., None, None] * s

    @property
    def variance(self):
        s = jnp.einsum(
            "...ij,...kj->...ik", self.scale_tril, self.scale_tril
        )
        diag = jnp.diagonal(s, axis1=-2, axis2=-1)
        return self.df[..., None, None] * (
            s * s + diag[..., :, None] * diag[..., None, :]
        )


class InverseWishart(Distribution):
    """InverseWishart(df, Psi) over SPD matrices, parameterized by the
    lower-Cholesky factor ``scale_tril`` of Psi.  Sampling inverts a
    Bartlett factor of Wishart(df, Psi^-1) without ever forming Psi^-1:
    ``W = L A^-T A^-1 L^T`` with A the identity-scale Bartlett factor."""

    _params = ("df", "scale_tril")
    support = constraints.positive_definite

    def __init__(self, df, scale_tril):
        self.df = jnp.asarray(df)
        self.scale_tril = jnp.asarray(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = jax.lax.broadcast_shapes(
            self.df.shape, self.scale_tril.shape[:-2]
        )
        super().__init__(batch, (d, d))

    _param_event_ndims = {"df": 0, "scale_tril": 2}

    def sample(self, key, sample_shape=()):
        d = self.event_shape[0]
        shape = tuple(sample_shape) + self.batch_shape
        ftype = jnp.result_type(float)
        df = jnp.broadcast_to(self.df, shape).astype(ftype)
        eye = jnp.broadcast_to(jnp.eye(d, dtype=ftype), shape + (d, d))
        a = _bartlett(key, df, eye, d, shape, ftype)
        # B = L A^-T  (B^T = A^-1 L^T: solve A B^T = L^T);  W = B B^T
        tril = jnp.broadcast_to(self.scale_tril, shape + (d, d)).astype(ftype)
        bt = solve_triangular(a, jnp.swapaxes(tril, -1, -2), lower=True)
        b = jnp.swapaxes(bt, -1, -2)
        return jnp.einsum("...ij,...kj->...ik", b, b)

    def log_prob(self, x):
        from jax.scipy.special import multigammaln

        d = self.event_shape[0]
        df = self.df
        batch = jax.lax.broadcast_shapes(
            x.shape[:-2], self.scale_tril.shape[:-2], df.shape
        )
        tril = jnp.broadcast_to(self.scale_tril, batch + (d, d))
        xw = jnp.broadcast_to(x, batch + (d, d))
        lw = jnp.linalg.cholesky(xw)
        # tr(Psi W^-1) = ||L_w^-1 L_psi||_F^2
        m = solve_triangular(lw, tril, lower=True)
        trace = jnp.sum(m * m, (-2, -1))
        logdet_w = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(lw, axis1=-2, axis2=-1)), -1
        )
        logdet_psi = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(tril, axis1=-2, axis2=-1)), -1
        )
        return (
            0.5 * df * logdet_psi - 0.5 * trace
            - 0.5 * (df + d + 1.0) * logdet_w
            - 0.5 * df * d * math.log(2.0)
            - multigammaln(0.5 * df, d)
        )

    @property
    def mean(self):
        # defined for df > d + 1
        d = self.event_shape[0]
        psi = jnp.einsum(
            "...ij,...kj->...ik", self.scale_tril, self.scale_tril
        )
        return psi / (self.df - d - 1.0)[..., None, None]

    @property
    def variance(self):
        # defined for df > d + 3 (standard IW marginal variances)
        d = self.event_shape[0]
        psi = jnp.einsum(
            "...ij,...kj->...ik", self.scale_tril, self.scale_tril
        )
        df = self.df[..., None, None]
        diag = jnp.diagonal(psi, axis1=-2, axis2=-1)
        num = (df - d + 1.0) * psi * psi \
            + (df - d - 1.0) * diag[..., :, None] * diag[..., None, :]
        den = (df - d) * (df - d - 1.0) ** 2 * (df - d - 3.0)
        return num / den
