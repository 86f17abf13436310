"""Elliptical slice sampling (Murray, Adams & MacKay 2010).

Blueprint: SURVEY.md C8 periphery — the tuning-free sampler for models with
a Gaussian prior and arbitrary likelihood (GP regression/classification,
random-walk state-space models, any latent field): proposals move on the
ellipse through the current state and a prior draw, and the slice shrinkage
accepts exactly; no step size, no mass matrix, every proposal accepted.

Compiled shape: the reference algorithm's inner while-loop (shrink the
bracket until accept) is data-dependent; here it runs as a FIXED number of
shrink iterations under ``lax.scan`` with a done-mask (the loop contracts
the bracket geometrically, so 30 iterations bound the miss probability
below ~1e-9 for any continuous target), keeping every chain in lockstep for
``vmap`` and the whole run one XLA program.

The Gaussian prior is factored out of the model automatically:
``logdensity_parts`` (SURVEY.md C4) splits log prior + log lik, and the
prior must be standard-normal in unconstrained space — exactly what
whitened/non-centered parameterizations give.  For site-specific Gaussian
priors with nontrivial scales, apply ``LocScaleReparam`` first (the
``reparam`` handler makes the site's unconstrained prior N(0,1)).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...core.logjoint import build_logjoint, init_to_uniform
from ...core.precision import exact

__all__ = ["EllipticalSlice", "ESSResult"]

_SHRINK_ITERS = 30


class ESSResult(NamedTuple):
    samples: dict              # site -> (chains, num_samples, *event)
    unconstrained: jax.Array   # (chains, num_samples, dim)
    extra: dict                # shrink-iteration counts


class EllipticalSlice:
    """``EllipticalSlice(model, num_samples=1000, num_chains=8)``.

    Requires every latent site's unconstrained prior to be (iid) standard
    normal — the whitened form; the likelihood part may be anything.
    Verified at build time by probing ``logdensity_parts`` against the
    analytic N(0, I) log-density at random points."""

    def __init__(self, model=None, *, num_samples=1000, num_burnin=200,
                 num_chains=8, model_args=(), model_kwargs=None,
                 chain_sharding=None, _check_prior=True):
        self.num_samples = int(num_samples)
        self.num_burnin = int(num_burnin)
        self.num_chains = int(num_chains)
        self.chain_sharding = chain_sharding

        info, logdensity, constrain_fn, _ = build_logjoint(
            model, *model_args, **(model_kwargs or {})
        )
        from ..svi.guides import unraveler
        dim, unravel_fn, ravel_fn = unraveler(info)
        self.info = info
        self.dim = dim
        self._ravel = ravel_fn
        self._constrain = lambda q: constrain_fn(unravel_fn(q))
        parts = logdensity.parts

        def loglik(q):
            _, ll = parts(unravel_fn(q))
            return ll

        def logprior(q):
            lp, _ = parts(unravel_fn(q))
            return lp

        self._loglik = loglik

        if _check_prior:
            key = jax.random.PRNGKey(0)
            for i in range(3):
                q = jax.random.normal(jax.random.fold_in(key, i), (dim,))
                got = float(logprior(q))
                want = float(jnp.sum(-0.5 * q * q
                                     - 0.5 * np.log(2 * np.pi)))
                if abs(got - want) > 1e-3 * max(1.0, abs(want)):
                    raise ValueError(
                        "EllipticalSlice requires a standard-normal "
                        "unconstrained prior on every site (whitened / "
                        "non-centered form; see LocScaleReparam). "
                        f"log-prior at a probe point was {got:.4f}, "
                        f"expected {want:.4f}."
                    )

    # ------------------------------------------------------------------
    def _transition(self, key, q, ll):
        """One ESS update for a single chain: returns (q', ll', iters)."""
        k_nu, k_u, k_theta, k_shrink = jax.random.split(key, 4)
        nu = jax.random.normal(k_nu, q.shape)
        log_y = ll + jnp.log(jax.random.uniform(k_u))
        theta = jax.random.uniform(k_theta, (), minval=0.0,
                                   maxval=2.0 * np.pi)
        lo, hi = theta - 2.0 * np.pi, theta

        def body(carry, kr):
            q_cur, ll_cur, lo, hi, theta, done, iters = carry
            prop = q * jnp.cos(theta) + nu * jnp.sin(theta)
            ll_prop = self._loglik(prop)
            accept = (ll_prop > log_y) & ~done
            q_cur = jnp.where(accept, prop, q_cur)
            ll_cur = jnp.where(accept, ll_prop, ll_cur)
            done = done | accept
            # shrink toward 0 on miss
            lo = jnp.where(~done & (theta < 0), theta, lo)
            hi = jnp.where(~done & (theta >= 0), theta, hi)
            theta_new = jax.random.uniform(kr, (), minval=lo, maxval=hi)
            theta = jnp.where(done, theta, theta_new)
            iters = iters + jnp.where(done, 0, 1)
            return (q_cur, ll_cur, lo, hi, theta, done, iters), None

        keys = jax.random.split(k_shrink, _SHRINK_ITERS)
        (q1, ll1, *_, iters), _ = lax.scan(
            body, (q, ll, lo, hi, theta, jnp.asarray(False),
                   jnp.asarray(0)), keys)
        return q1, ll1, iters

    # ------------------------------------------------------------------
    def run(self, key) -> ESSResult:
        key_init, key_run = jax.random.split(key)

        def init_one(c):
            k = jax.random.fold_in(key_init, c)
            return self._ravel(init_to_uniform(self.info, k))

        q0 = jax.vmap(init_one)(jnp.arange(self.num_chains))
        if self.chain_sharding is not None:
            q0 = jax.device_put(q0, self.chain_sharding)

        if not hasattr(self, "_run_fn"):
            def run_all(kr, q0):
                # kr must thread through the scans as a traced value: a
                # closed-over key would be baked into the cached compiled
                # program, silently freezing the randomness of every later
                # run() on this instance
                def sweep(carry, t):
                    q, ll = carry
                    keys = jax.vmap(
                        lambda c: jax.random.fold_in(
                            jax.random.fold_in(kr, t), c)
                    )(jnp.arange(self.num_chains))
                    q, ll, iters = jax.vmap(self._transition)(keys, q, ll)
                    return (q, ll), (q, iters)

                ll0 = jax.vmap(self._loglik)(q0)
                carry, _ = lax.scan(sweep, (q0, ll0),
                                    jnp.arange(self.num_burnin))
                _, (qs, iters) = lax.scan(
                    sweep, carry,
                    jnp.arange(self.num_burnin,
                               self.num_burnin + self.num_samples))
                return qs, iters

            # the slice thresholds compare likelihoods: pinned
            # (core/precision.py)
            self._run_fn = jax.jit(exact(run_all))

        qs, iters = self._run_fn(key_run, q0)
        qs = jnp.swapaxes(qs, 0, 1)            # (chains, samples, dim)
        flat = qs.reshape(-1, self.dim)
        cons = jax.vmap(self._constrain)(flat)
        samples = {name: val.reshape(qs.shape[:2] + val.shape[1:])
                   for name, val in cons.items()}
        return ESSResult(samples, qs,
                         {"shrink_iters": jnp.swapaxes(iters, 0, 1)})
