"""Pathfinder: quasi-Newton variational inference (Zhang, Carpenter,
Gelman & Vehtari 2022) — SURVEY.md C5/C6-adjacent fast-approximation
backend, and the standard cheap initializer for MCMC.

The idea: run L-BFGS on the negative unconstrained log-joint; every point
along the optimization path, paired with the local L-BFGS inverse-Hessian
estimate, defines a Gaussian ``N(theta_k - H_k g_k, H_k)``.  Evaluate a
Monte-Carlo ELBO for each, keep the best, and importance-resample pooled
draws from several independent paths with Pareto-smoothed weights
(multi-path Pathfinder).  Cost is a few hundred gradient evaluations —
orders of magnitude below NUTS — and unlike plain MAP+Laplace it does not
need the mode or a dense Hessian.

Reliability contract: on strongly non-Gaussian posteriors (e.g. the
8-schools funnel) the single-Gaussian approximation is biased and
``pareto_k`` exceeds 0.7 — in that regime use the draws to SEED MCMC
(init_params / step-size scale), not as the posterior.

Compiled shape: the whole path is one ``lax.scan`` over L-BFGS steps (optax's
zoom line search, compiled); the per-iterate inverse-Hessian is built by
the masked two-loop recursion applied to the identity (O(J·dim²) batched
matmuls), and paths/ELBO draws vectorize with ``vmap``.  Dense (dim, dim)
covariances are deliberate: Pathfinder targets the moderate-dim regime
(the paper's benchmarks are ≤ a few hundred dims), where a dense Cholesky
is one small matmul tile.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.logjoint import build_logjoint, init_to_uniform

__all__ = ["pathfinder", "PathfinderResult"]


class PathfinderResult(NamedTuple):
    samples: dict        # site -> (num_samples, *event) constrained draws
    logq: jax.Array      # (num_samples,) proposal log-density of each draw
    logp: jax.Array      # (num_samples,) joint log-density of each draw
    pareto_k: float      # PSIS tail diagnostic of the importance weights
    elbo: jax.Array      # (num_paths,) best per-path ELBO estimate
    best_iter: jax.Array  # (num_paths,) argmax iterate index per path
    unconstrained: jax.Array = None  # (num_samples, dim) flat draws —
    #   feed the first num_chains rows to MCMC(init_params=...) to warm
    #   start NUTS from the pathfinder approximation


def _two_loop_dense(s_win, y_win, valid, dim):
    """Dense inverse-Hessian from a window of (s, y) pairs via the masked
    two-loop recursion applied to identity columns.  Invalid pairs have
    rho = 0 and drop out as exact no-ops."""
    sy = jnp.sum(s_win * y_win, -1)                       # (J,)
    yy = jnp.sum(y_win * y_win, -1)
    ss = jnp.sum(s_win * s_win, -1)
    curv_ok = sy > 1e-10 * jnp.sqrt(ss * yy) + 1e-30
    ok = valid & curv_ok
    rho = jnp.where(ok, 1.0 / jnp.where(ok, sy, 1.0), 0.0)  # (J,)
    # gamma from the most recent valid pair
    idx = jnp.arange(sy.shape[0])
    last = jnp.argmax(jnp.where(ok, idx, -1))
    any_ok = jnp.any(ok)
    gamma = jnp.where(any_ok, sy[last] / jnp.maximum(yy[last], 1e-30), 1.0)

    def hv(v):
        def bwd(q, j):
            a = rho[j] * jnp.dot(s_win[j], q)
            return q - a * y_win[j], a

        q, alphas = jax.lax.scan(bwd, v,
                                 jnp.arange(sy.shape[0] - 1, -1, -1))
        r = gamma * q

        def fwd(r, j_and_a):
            j, a = j_and_a
            b = rho[j] * jnp.dot(y_win[j], r)
            return r + s_win[j] * (a - b), None

        r, _ = jax.lax.scan(
            fwd, r, (jnp.arange(sy.shape[0] - 1, -1, -1)[::-1],
                     alphas[::-1]))
        return r

    h = jax.vmap(hv)(jnp.eye(dim))        # rows H e_i -> H^T == H
    return 0.5 * (h + h.T), gamma


_LOG_2PI = float(np.log(2.0 * np.pi))


def _mvn_sample_logq(key, mean, chol, n):
    dim = mean.shape[-1]
    eps = jax.random.normal(key, (n, dim), mean.dtype)
    xs = mean + eps @ chol.T
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
    logq = -0.5 * jnp.sum(eps * eps, -1) - half_logdet \
        - 0.5 * dim * _LOG_2PI
    return xs, logq


def pathfinder(model, key, *, num_paths=4, maxiter=60, history=6,
               num_elbo_draws=32, num_samples=1000, init_radius=2.0,
               model_args=(), model_kwargs=None, psis=True):
    """Multi-path Pathfinder over ``model``'s unconstrained posterior.

    Returns :class:`PathfinderResult` with ``num_samples`` constrained
    draws, importance-resampled (with PSIS smoothing when ``psis=True``)
    from the pooled best-per-path Gaussians; ``pareto_k`` > 0.7 flags an
    unreliable approximation (same diagnostic contract as
    ``utils.compare.psis_loo``)."""
    info, logdensity, constrain_fn, _ = build_logjoint(
        model, *model_args, **(model_kwargs or {})
    )
    from .svi.guides import unraveler

    dim, unravel, ravel = unraveler(info)

    def neg_logp(q):
        return -logdensity(unravel(q))

    value_and_grad = jax.value_and_grad(neg_logp)
    opt = optax.lbfgs(memory_size=history)

    def one_path(path_key):
        k_init, k_elbo, k_draw = jax.random.split(path_key, 3)
        q0 = ravel(init_to_uniform(info, k_init, radius=init_radius))

        def step(carry, _):
            q, state = carry
            value, grad = value_and_grad(q)
            updates, state = opt.update(
                grad, state, q, value=value, grad=grad, value_fn=neg_logp)
            q_new = optax.apply_updates(q, updates)
            # guard: a NaN line search must not poison later iterates
            bad = ~jnp.all(jnp.isfinite(q_new))
            q_new = jnp.where(bad, q, q_new)
            return (q_new, state), (q, grad)

        (_, _), (thetas, grads) = jax.lax.scan(
            step, (q0, opt.init(q0)), None, length=maxiter + 1)
        # thetas[k] is the PRE-update iterate of step k; s/y pairs between
        # consecutive iterates
        s_all = thetas[1:] - thetas[:-1]              # (L, dim)
        y_all = grads[1:] - grads[:-1]

        pad_s = jnp.concatenate([jnp.zeros((history, dim)), s_all])
        pad_y = jnp.concatenate([jnp.zeros((history, dim)), y_all])

        def elbo_at(k):
            """Gaussian from the last `history` pairs before iterate k."""
            s_win = jax.lax.dynamic_slice(pad_s, (k, 0), (history, dim))
            y_win = jax.lax.dynamic_slice(pad_y, (k, 0), (history, dim))
            valid = jnp.arange(history) >= (history - k)
            h, _ = _two_loop_dense(s_win, y_win, valid, dim)
            theta = thetas[k]
            grad = grads[k]
            mean = theta - h @ grad
            chol = jnp.linalg.cholesky(h)
            ok = jnp.all(jnp.isfinite(chol)) & jnp.all(jnp.isfinite(mean))
            chol_safe = jnp.where(ok, chol, jnp.eye(dim))
            mean_safe = jnp.where(ok, mean, jnp.zeros(dim))
            xs, logq = _mvn_sample_logq(k_elbo, mean_safe, chol_safe,
                                        num_elbo_draws)
            logp = jax.vmap(lambda x: -neg_logp(x))(xs)
            elbo = jnp.mean(logp - logq)
            elbo = jnp.where(ok & jnp.isfinite(elbo), elbo, -jnp.inf)
            return elbo, mean_safe, chol_safe

        ks = jnp.arange(1, maxiter + 1)
        elbos, means, chols = jax.lax.map(elbo_at, ks)
        best = jnp.argmax(elbos)
        mean_b, chol_b = means[best], chols[best]
        n_local = num_samples  # per-path draws before pooling/resampling
        xs, logq = _mvn_sample_logq(k_draw, mean_b, chol_b, n_local)
        logp = jax.vmap(lambda x: -neg_logp(x))(xs)
        return xs, logq, logp, elbos[best], ks[best]

    keys = jax.random.split(key, num_paths + 1)
    xs, logq, logp, best_elbo, best_iter = jax.jit(jax.vmap(one_path))(
        keys[:num_paths])
    xs = xs.reshape(-1, dim)
    # the pooled proposal is the MIXTURE of the per-path Gaussians drawn
    # equally; using the per-path logq as the proposal density is the
    # paper's (slightly conservative) per-path weighting
    logq = logq.reshape(-1)
    logp = logp.reshape(-1)

    lw = np.asarray(logp - logq, dtype=np.float64)
    finite = np.isfinite(lw)
    if not np.any(finite):
        raise ValueError(
            "pathfinder: all paths failed — every pooled draw has a "
            "non-finite importance log-weight (the L-BFGS paths diverged "
            "or the target density is non-finite at every draw).  Check "
            "the model/initialization, or increase num_paths/maxiter.")
    lw = np.where(finite, lw, -np.inf)
    if psis:
        from ..utils.compare import _psis_smooth_one

        lw_s, k_hat = _psis_smooth_one(lw.copy())
    else:
        lw_s = lw - (np.max(lw) + np.log(np.sum(np.exp(lw - np.max(lw)))))
        k_hat = float("nan")
    w = np.exp(lw_s - lw_s.max())
    w = w / w.sum()
    rng = np.random.default_rng(
        int(jax.random.randint(keys[-1], (), 0, 2**31 - 1)))
    # importance resampling WITHOUT replacement when the positive-weight
    # pool allows it: the first num_chains rows of `unconstrained` seed
    # MCMC chains (MCMC(init_params=...)), and duplicate seed points
    # weaken between-chain diagnostics; with-replacement draws are kept
    # only as the degenerate-weight fallback.
    n_pos = int(np.count_nonzero(w))
    idx = rng.choice(lw.shape[0], size=num_samples,
                     replace=n_pos < num_samples, p=w)
    chosen = jnp.asarray(np.asarray(xs)[idx])
    cons = jax.vmap(lambda q: constrain_fn(unravel(q)))(chosen)
    return PathfinderResult(
        samples=cons,
        logq=jnp.asarray(np.asarray(logq)[idx]),
        logp=jnp.asarray(np.asarray(logp)[idx]),
        pareto_k=float(k_hat),
        elbo=best_elbo,
        best_iter=best_iter,
        unconstrained=chosen,
    )
