"""MAP estimation and the Laplace (quadratic) posterior approximation.

Blueprint: SURVEY.md §2.2 periphery — the cheap deterministic baseline a
reference-class PPL offers next to SVI/NUTS/SMC: optimize the unconstrained
log-joint (MAP), then Gaussianize at the mode.  Because the unconstrained
density already carries the change-of-variable Jacobians (SURVEY.md C4),
the Laplace evidence estimate and covariance are computed in the right
space for free, and are EXACT on linear-Gaussian models — which is what
the tests exploit as an oracle.

Shape notes: the optimization loop is one fused ``lax.scan`` over optax
updates (same shape as the SVI driver, SURVEY.md §3.1); the Hessian is one
``jax.hessian`` call — dense (d, d), fine for the d ≲ 10^3 regime this is
meant for (use SVI/NUTS beyond that).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

from ..core.logjoint import Potential, build_logjoint, init_to_prior

__all__ = ["MAPResult", "map_estimate", "Laplace"]


class MAPResult(NamedTuple):
    uparams: Any           # unconstrained MAP point (site dict)
    params: Any            # constrained MAP point (site dict)
    log_joint: jax.Array   # log-density at the mode (unconstrained space)
    losses: jax.Array      # per-step negative log-joint trace


def _setup(model, model_args, model_kwargs, key, init):
    model_kwargs = model_kwargs or {}
    info, logdensity, constrain, _ = build_logjoint(
        model, *model_args, **model_kwargs)
    if init is None:
        init = init_to_prior(model, info, *model_args, rng_key=key,
                             **model_kwargs)
    pot = Potential(logdensity, init)
    return info, pot, constrain


def map_estimate(model, model_args=(), model_kwargs=None, optimizer=None,
                 num_steps=1000, key=None, init=None) -> MAPResult:
    """Maximum-a-posteriori point in unconstrained space via one fused
    optax scan.  ``init`` (site dict, unconstrained) defaults to a prior
    draw."""
    key = jax.random.PRNGKey(0) if key is None else key
    optimizer = optax.adam(0.05) if optimizer is None else optimizer
    info, pot, constrain = _setup(model, model_args, model_kwargs, key, init)
    q0 = pot.example_flat

    def run(q0):
        opt_state = optimizer.init(q0)

        def step(carry, _):
            q, opt_state = carry
            loss, g = jax.value_and_grad(pot)(q)
            updates, opt_state = optimizer.update(g, opt_state, q)
            return (optax.apply_updates(q, updates), opt_state), loss

        (q, _), losses = jax.lax.scan(step, (q0, opt_state), None,
                                      length=num_steps)
        return q, losses

    q, losses = jax.jit(run)(q0)
    uparams = pot.unravel(q)
    return MAPResult(uparams=uparams, params=constrain(uparams),
                     log_joint=-pot(q), losses=losses)


class Laplace:
    """Laplace approximation: N(q_map, H^{-1}) in unconstrained space,
    where H is the Hessian of the negative log-joint at the mode.

    ``fit`` returns self with:
      * ``log_evidence`` — log p(q*) + (d/2)·log 2π − ½·log det H
        (exact on linear-Gaussian models);
      * ``mean`` / ``cov`` — unconstrained moments (flat vector view);
      * ``sample_posterior(key, n)`` — constrained-space draws.
    """

    def __init__(self, model, model_args=(), model_kwargs=None):
        self.model = model
        self._args = model_args
        self._kwargs = model_kwargs or {}
        self._fitted = False

    def fit(self, key=None, optimizer=None, num_steps=1000, init=None):
        key = jax.random.PRNGKey(0) if key is None else key
        res = map_estimate(self.model, self._args, self._kwargs,
                           optimizer=optimizer, num_steps=num_steps,
                           key=key, init=init)
        info, pot, constrain = _setup(self.model, self._args, self._kwargs,
                                      key, res.uparams)
        self._pot, self._constrain = pot, constrain
        q, _ = ravel_pytree(res.uparams)
        h = jax.jit(jax.hessian(pot))(q)
        # guard tiny asymmetry from autodiff
        h = 0.5 * (h + h.T)
        chol_h = jnp.linalg.cholesky(h)
        d = q.shape[0]
        half_logdet_h = jnp.sum(jnp.log(jnp.diagonal(chol_h)))
        self.map_result = res
        self.mean = q
        self._chol_h = chol_h
        self.log_evidence = float(
            res.log_joint + 0.5 * d * jnp.log(2.0 * jnp.pi) - half_logdet_h
        )
        self._fitted = True
        return self

    @property
    def cov(self):
        """Unconstrained posterior covariance H^{-1} (dense)."""
        eye = jnp.eye(self.mean.shape[0], dtype=self.mean.dtype)
        inv_l = jax.scipy.linalg.solve_triangular(self._chol_h, eye,
                                                  lower=True)
        return inv_l.T @ inv_l

    def sample_unconstrained(self, key, num_samples=1000):
        z = jax.random.normal(key, (num_samples, self.mean.shape[0]),
                              self.mean.dtype)
        # cov = L^{-T} L^{-1}  =>  draws = mean + L^{-T} z
        dq = jax.scipy.linalg.solve_triangular(
            self._chol_h.T, z.T, lower=False).T
        return self.mean[None, :] + dq

    def sample_posterior(self, key, num_samples=1000):
        """Constrained-space posterior draws (dict of sites, leading
        sample dimension) — same contract as ``svi.sample_posterior``."""
        if not self._fitted:
            raise RuntimeError("call fit() first")
        qs = self.sample_unconstrained(key, num_samples)
        return jax.vmap(lambda q: self._constrain(self._pot.unravel(q)))(qs)
