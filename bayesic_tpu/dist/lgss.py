"""Linear-Gaussian state-space model — marginal likelihood via the Kalman
filter, with a TEMPORALLY PARALLEL filter/smoother built on
``lax.associative_scan``.

Blueprint: SURVEY.md C1/C4 — the continuous-state counterpart of
:class:`~bayesic_tpu.dist.hmm.HiddenMarkovModel`: the Gaussian state path
is marginalised *inside* ``log_prob`` (prediction-error decomposition), so
models with linear-Gaussian dynamics need no latent path in the inference
state and the marginal density is exact.

Design: a sequential Kalman scan is a T-long dependency chain of tiny
(D, D) ops — the worst shape for an accelerator (no large matmuls, serial
latency bound).  Instead the filter and the RTS smoother are phrased as
ASSOCIATIVE operators (Särkkä & García-Fernández, "Temporal
Parallelization of Bayesian Smoothers", IEEE TAC 2021) and run through
``lax.associative_scan``: log2(T) parallel rounds of batched (D, D)
matmuls — XLA batches the per-time-step algebra into single fused GEMMs,
so a T=10^4 filter costs ~14 rounds of well-shaped matmul work instead of
10^4 serial steps.  The sequential scan is kept as the small-T path and as
the parity oracle (``tests/test_lgss.py``).

Model (time-invariant):

    z_0 ~ N(initial_mean, initial_cov)
    z_t = F z_{t-1} + eps_t,   eps_t ~ N(0, Q)       t = 1..T-1
    x_t = H z_t     + nu_t,    nu_t  ~ N(0, R)       t = 0..T-1

Event shape is ``(num_steps, obs_dim)``.  Extras beyond
``log_prob``/``sample``: ``filter`` (forward marginals), ``smooth``
(RTS marginals), ``posterior_sample`` (exact joint backward sampling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import constraints
from .distribution import Distribution

__all__ = ["LinearGaussianStateSpace"]


def _mvn_logpdf(x, mean, cov):
    """N(x; mean, cov) log-density with a Cholesky solve; x/mean (..., E)."""
    d = x.shape[-1]
    chol = jnp.linalg.cholesky(cov)
    diff = x - mean
    w = jax.scipy.linalg.solve_triangular(chol, diff[..., None],
                                          lower=True)[..., 0]
    return (-0.5 * jnp.sum(w * w, axis=-1)
            - jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)),
                      axis=-1)
            - 0.5 * d * jnp.log(2.0 * jnp.pi))


def _sym(a):
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


class LinearGaussianStateSpace(Distribution):
    """``LinearGaussianStateSpace(initial_mean (D,), initial_cov (D, D),
    transition_matrix F (D, D), transition_cov Q (D, D),
    observation_matrix H (E, D), observation_cov R (E, E), num_steps)``.

    ``method``: ``"parallel"`` (associative scan), ``"sequential"``, or
    ``"auto"`` (parallel for ``num_steps >= 16``).  Batch LGSSMs: construct
    per-instance and ``vmap`` (same convention as ``HiddenMarkovModel``);
    ``log_prob`` does accept leading batch dims on ``x`` for iid copies of
    the same chain."""

    _params = ("initial_mean", "initial_cov", "transition_matrix",
               "transition_cov", "observation_matrix", "observation_cov",
               "observed_mask")
    reparametrized = True
    support = constraints.real_vector

    def __init__(self, initial_mean, initial_cov, transition_matrix,
                 transition_cov, observation_matrix, observation_cov,
                 num_steps, method="auto", observed_mask=None):
        m0 = jnp.asarray(initial_mean)
        if m0.ndim != 1:
            raise ValueError(
                "batched LGSSMs are not supported directly; vmap over "
                "per-instance constructions instead"
            )
        d = m0.shape[0]
        f = jnp.asarray(transition_matrix)
        h = jnp.asarray(observation_matrix)
        e = h.shape[0]
        for name, arr, want in (
            ("initial_cov", jnp.asarray(initial_cov), (d, d)),
            ("transition_matrix", f, (d, d)),
            ("transition_cov", jnp.asarray(transition_cov), (d, d)),
            ("observation_matrix", h, (e, d)),
            ("observation_cov", jnp.asarray(observation_cov), (e, e)),
        ):
            if arr.shape != want:
                raise ValueError(f"{name} must have shape {want}, got "
                                 f"{arr.shape}")
        if method not in ("auto", "parallel", "sequential"):
            raise ValueError(f"method must be 'auto', 'parallel' or "
                             f"'sequential', got {method!r}")
        self.initial_mean = m0
        self.initial_cov = jnp.asarray(initial_cov)
        self.transition_matrix = f
        self.transition_cov = jnp.asarray(transition_cov)
        self.observation_matrix = h
        self.observation_cov = jnp.asarray(observation_cov)
        self.num_steps = int(num_steps)
        self.method = method
        # per-time observation mask (missing data): False rows contribute
        # no update in the filter and no term in log_prob; values at
        # masked positions are ignored (and zeroed before use, so NaN
        # placeholders are safe under grad)
        if observed_mask is None:
            observed_mask = jnp.ones((self.num_steps,), bool)
        observed_mask = jnp.asarray(observed_mask, bool)
        if observed_mask.shape != (self.num_steps,):
            raise ValueError(f"observed_mask must have shape "
                             f"({self.num_steps},), got "
                             f"{observed_mask.shape}")
        self.observed_mask = observed_mask
        super().__init__((), (self.num_steps, e))

    # ------------------------------------------------------------------
    @property
    def state_dim(self):
        return self.initial_mean.shape[0]

    @property
    def obs_dim(self):
        return self.observation_matrix.shape[0]

    def _parallel(self):
        return (self.method == "parallel"
                or (self.method == "auto" and self.num_steps >= 16))

    def expand(self, batch_shape):
        """iid batch of the SAME chain (params shared, not broadcast)."""
        batch_shape = jax.lax.broadcast_shapes(self.batch_shape,
                                               tuple(batch_shape))
        new = object.__new__(type(self))
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, v)
        object.__setattr__(new, "_batch_shape", batch_shape)
        return new

    def _x_safe(self, x):
        """Zero masked rows so NaN placeholders never reach the algebra."""
        return jnp.where(self.observed_mask[:, None], x, 0.0)

    # -- filtering -----------------------------------------------------
    def _filter_seq(self, x):
        """Sequential Kalman filter: x (T, E) ->
        (filtered means (T, D), filtered covs (T, D, D))."""
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov

        x = self._x_safe(x)
        mask = self.observed_mask

        def update(mp, pp, y, obs):
            s = h @ pp @ h.T + r
            k = jnp.linalg.solve(s, h @ pp).T          # pp H^T s^-1
            m = mp + k @ (y - h @ mp)
            p = _sym(pp - k @ s @ k.T)
            # missing observation: the filtered marginal IS the predictive
            return (jnp.where(obs, m, mp), jnp.where(obs, p, pp))

        m0, p0 = update(self.initial_mean, self.initial_cov, x[0], mask[0])

        def step(carry, inp):
            y, obs = inp
            m_prev, p_prev = carry
            mp = f @ m_prev
            pp = _sym(f @ p_prev @ f.T + q)
            m, p = update(mp, pp, y, obs)
            return (m, p), (m, p)

        _, (ms, ps) = lax.scan(step, (m0, p0), (x[1:], mask[1:]))
        return (jnp.concatenate([m0[None], ms], axis=0),
                jnp.concatenate([p0[None], ps], axis=0))

    def _filter_par(self, x):
        """Parallel Kalman filter (Särkkä & García-Fernández 2021, §III):
        per-step five-tuples (A, b, C, eta, J) combined associatively —
        the prefix composite at t has b = filtered mean, C = filtered cov."""
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        d = self.state_dim
        t_len = x.shape[0]
        x = self._x_safe(x)
        mask = self.observed_mask

        # generic element (t >= 1): transition by F/Q then observe y_t
        s = h @ q @ h.T + r                            # (E, E)
        k = jnp.linalg.solve(s, h @ q).T               # Q H^T S^-1 (D, E)
        ikh = jnp.eye(d) - k @ h
        a_g = ikh @ f                                  # (D, D)
        c_g = _sym(ikh @ q)                            # (D, D)
        fthsi = jnp.linalg.solve(s, h @ f).T           # F^T H^T S^-1 (D, E)
        j_g = fthsi @ (h @ f)                          # (D, D)

        bs = x[1:] @ k.T                               # (T-1, D)
        etas = x[1:] @ fthsi.T                         # (T-1, D)

        # first element: prior N(m0, P0) updated by y_0 (no transition)
        s0 = h @ self.initial_cov @ h.T + r
        k0 = jnp.linalg.solve(s0, h @ self.initial_cov).T
        b0 = self.initial_mean + k0 @ (x[0] - h @ self.initial_mean)
        c0 = _sym(self.initial_cov - k0 @ s0 @ k0.T)

        # missing observations (Sarkka & Garcia-Fernandez 2021 remark:
        # the element of an unobserved step is the pure transition):
        # generic t: (A, b, C, eta, J) = (F, 0, Q, 0, 0); b/eta are
        # already 0 because masked x rows are zeroed — select A, C, J.
        # t = 0: the composite must reduce to the prior, so b = m0,
        # C = P0 (A, eta, J already 0).
        m_g = mask[1:, None, None]
        b0 = jnp.where(mask[0], b0, self.initial_mean)
        c0 = jnp.where(mask[0], c0, self.initial_cov)

        zero_d = jnp.zeros((d, d))
        a_el = jnp.concatenate([zero_d[None],
                                jnp.where(m_g, a_g, f)])
        b_el = jnp.concatenate([b0[None], bs])
        c_el = jnp.concatenate([c0[None],
                                jnp.where(m_g, c_g, q)])
        eta_el = jnp.concatenate([jnp.zeros((1, d)), etas])
        j_el = jnp.concatenate([zero_d[None],
                                jnp.where(m_g, j_g, zero_d)])

        eye = jnp.eye(d)

        def combine(u, v):
            a_i, b_i, c_i, eta_i, j_i = u
            a_j, b_j, c_j, eta_j, j_j = v
            # A_j (I + C_i J_j)^{-1} = solve((I + C_i J_j)^T, A_j^T)^T, and
            # (I + C_i J_j)^T = I + J_j C_i because C, J are symmetric
            inv1 = jnp.linalg.solve(eye + j_j @ c_i,
                                    jnp.swapaxes(a_j, -1, -2))
            aji = jnp.swapaxes(inv1, -1, -2)           # A_j (I + C_i J_j)^-1
            a = aji @ a_i
            b = (aji @ (b_i[..., None]
                        + c_i @ eta_j[..., None]))[..., 0] + b_j
            c = _sym(aji @ c_i @ jnp.swapaxes(a_j, -1, -2) + c_j)
            it = jnp.linalg.solve(eye + j_j @ c_i,
                                  (eta_j - (j_j @ b_i[..., None])[..., 0]
                                   )[..., None])
            eta = (jnp.swapaxes(a_i, -1, -2) @ it)[..., 0] + eta_i
            j = _sym(jnp.swapaxes(a_i, -1, -2)
                     @ jnp.linalg.solve(eye + j_j @ c_i, j_j @ a_i) + j_i)
            return a, b, c, eta, j

        _, ms, ps, _, _ = lax.associative_scan(
            combine, (a_el, b_el, c_el, eta_el, j_el))
        return ms, ps

    def filter(self, x):
        """Filtered marginals p(z_t | x_{0:t}): x (T, E) ->
        (means (T, D), covs (T, D, D))."""
        x = jnp.asarray(x)
        if x.shape != self.event_shape:
            raise ValueError(f"filter expects a single path shaped "
                             f"{self.event_shape}, got {x.shape}")
        return (self._filter_par(x) if self._parallel()
                else self._filter_seq(x))

    # -- densities -------------------------------------------------------
    def _log_prob_one(self, x):
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        x = self._x_safe(x)
        ms, ps = (self._filter_par(x) if self._parallel()
                  else self._filter_seq(x))
        # prediction-error decomposition, elementwise from the prefix
        # filter outputs: step t's predictive uses filtered t-1
        mp = jnp.concatenate([self.initial_mean[None],
                              ms[:-1] @ f.T], axis=0)          # (T, D)
        pp = jnp.concatenate(
            [self.initial_cov[None],
             jnp.einsum("ij,tjk,lk->til", f, ps[:-1], f) + q], axis=0)
        s = jnp.einsum("ij,tjk,lk->til", h, pp, h) + r          # (T, E, E)
        terms = _mvn_logpdf(x, mp @ h.T, s)
        return jnp.sum(jnp.where(self.observed_mask, terms, 0.0), axis=0)

    def log_prob(self, x):
        x = jnp.asarray(x)
        batch = x.shape[:-2]
        if x.shape[-2:] != self.event_shape:
            raise ValueError(f"event shape mismatch: expected trailing "
                             f"{self.event_shape}, got {x.shape}")
        flat = x.reshape((-1,) + self.event_shape)
        lp = jax.vmap(self._log_prob_one)(flat)
        return lp.reshape(batch)

    # -- sampling --------------------------------------------------------
    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        n = 1
        for s_ in shape:
            n *= s_
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        k_z, k_x = jax.random.split(key)
        lq = jnp.linalg.cholesky(q)
        lr = jnp.linalg.cholesky(r)
        l0 = jnp.linalg.cholesky(self.initial_cov)
        eps = jax.random.normal(
            k_z, (self.num_steps, n, self.state_dim))
        nus = jax.random.normal(k_x, (self.num_steps, n, self.obs_dim))

        z0 = self.initial_mean + eps[0] @ l0.T

        def step(z, e):
            z = z @ f.T + e @ lq.T
            return z, z

        _, zs = lax.scan(step, z0, eps[1:])
        z = jnp.concatenate([z0[None], zs], axis=0)    # (T, n, D)
        x = z @ h.T + nus @ lr.T                       # (T, n, E)
        x = jnp.moveaxis(x, 0, 1)                      # (n, T, E)
        return x.reshape(shape + self.event_shape)

    # -- posterior inference ----------------------------------------------
    def smooth(self, x):
        """RTS-smoothed marginals p(z_t | x_{0:T-1}): x (T, E) ->
        (means (T, D), covs (T, D, D)).  Parallel path: associative
        composition of the backward conditionals z_t | z_{t+1} ~
        N(E_t z_{t+1} + g_t, L_t) (Särkkä & García-Fernández 2021, §IV)."""
        x = jnp.asarray(x)
        ms, ps = self.filter(x)
        f, q = self.transition_matrix, self.transition_cov

        pp = jnp.einsum("ij,tjk,lk->til", f, ps[:-1], f) + q   # (T-1, D, D)
        # G_t = P_t F^T Pp_{t+1}^{-1}: solve Pp^T u = F P_t^T then transpose
        gs = jnp.swapaxes(
            jnp.linalg.solve(jnp.swapaxes(pp, -1, -2),
                             f @ jnp.swapaxes(ps[:-1], -1, -2)), -1, -2)
        e_el = gs                                               # (T-1, D, D)
        g_el = ms[:-1] - jnp.einsum("tij,tj->ti", gs, ms[:-1] @ f.T)
        l_el = _sym(ps[:-1]
                    - jnp.einsum("tij,tjk,tlk->til", gs, pp, gs))

        if not self._parallel():
            def step(carry, el):
                msn, psn = carry
                e_t, g_t, l_t = el
                m = e_t @ msn + g_t
                p = _sym(e_t @ psn @ e_t.T + l_t)
                return (m, p), (m, p)

            _, (sm, sp) = lax.scan(step, (ms[-1], ps[-1]),
                                   (e_el, g_el, l_el), reverse=True)
            return (jnp.concatenate([sm, ms[-1][None]], axis=0),
                    jnp.concatenate([sp, ps[-1][None]], axis=0))

        # terminal element is the degenerate conditional = the filtered
        # marginal at T-1, so the suffix composite at t IS the smoothed
        # marginal
        e_all = jnp.concatenate(
            [e_el, jnp.zeros((1, self.state_dim, self.state_dim))])
        g_all = jnp.concatenate([g_el, ms[-1][None]])
        l_all = jnp.concatenate([l_el, ps[-1][None]])

        def combine(u, v):
            # reverse=True feeds the LATER element as the left operand
            # (empirically: out[t] = elems[n-1] * ... * elems[t]), so u is
            # the suffix composite and v the earlier conditional; the
            # composition wanted is v then u: z_t | z_suffix-root
            e_j, g_j, l_j = u                  # suffix composite (later)
            e_i, g_i, l_i = v                  # earlier conditional
            e = e_i @ e_j
            g = (e_i @ g_j[..., None])[..., 0] + g_i
            l_ = _sym(e_i @ l_j @ jnp.swapaxes(e_i, -1, -2) + l_i)
            return e, g, l_

        _, sm, sp = lax.associative_scan(combine, (e_all, g_all, l_all),
                                         reverse=True)
        return sm, sp

    def posterior_sample(self, key, x, sample_shape=()):
        """Exact joint posterior draws of the state path given x (T, E):
        forward filter, backward sample; returns (*sample_shape, T, D)."""
        x = jnp.asarray(x)
        ms, ps = self.filter(x)
        f, q = self.transition_matrix, self.transition_cov
        shape = tuple(sample_shape)
        n = 1
        for s_ in shape:
            n *= s_
        eps = jax.random.normal(
            key, (self.num_steps, n, self.state_dim))

        z_last = ms[-1] + eps[-1] @ jnp.linalg.cholesky(ps[-1]).T

        pp = jnp.einsum("ij,tjk,lk->til", f, ps[:-1], f) + q
        gs = jnp.swapaxes(
            jnp.linalg.solve(jnp.swapaxes(pp, -1, -2),
                             f @ jnp.swapaxes(ps[:-1], -1, -2)), -1, -2)
        covs = _sym(ps[:-1] - jnp.einsum("tij,tjk,tlk->til", gs, pp, gs))
        jitter = 1e-9 * jnp.eye(self.state_dim)
        chols = jnp.linalg.cholesky(covs + jitter)

        def step(z_next, inp):
            m_t, g_t, ch_t, e_t = inp
            mean = m_t + (z_next - m_t @ f.T) @ g_t.T
            z = mean + e_t @ ch_t.T
            return z, z

        _, zs = lax.scan(step, z_last, (ms[:-1], gs, chols, eps[:-1]),
                         reverse=True)
        z = jnp.concatenate([zs, z_last[None]], axis=0)    # (T, n, D)
        z = jnp.moveaxis(z, 0, 1).reshape(
            shape + (self.num_steps, self.state_dim))
        return z

    @property
    def mean(self):
        """Marginal observation means (T, E)."""
        def step(m, _):
            m = self.transition_matrix @ m
            return m, m

        _, ms = lax.scan(step, self.initial_mean,
                         jnp.arange(self.num_steps - 1))
        ms = jnp.concatenate([self.initial_mean[None], ms], axis=0)
        return jnp.broadcast_to(ms @ self.observation_matrix.T,
                                self.batch_shape + self.event_shape)
