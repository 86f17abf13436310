"""Stein variational gradient descent (Liu & Wang 2016).

Blueprint: SURVEY.md §2.2 periphery — the particle-based deterministic
complement to SVI (C5-C7) and MCMC (C8): N interacting particles descend
the KL to the posterior along

    phi(x_i) = (1/N) sum_j [ k(x_j, x_i) grad_j log p(x_j)
                             + grad_j k(x_j, x_i) ]

with an RBF kernel and the median-pairwise-distance bandwidth heuristic.

Compiled shape: the whole update is two (N, N) x (N, D) matmuls plus an
(N, N) pairwise-distance matrix — pure matmul work with no sequential
structure; the full run is ONE lax.scan program with optax updates.
Subsampled plates ride the same draw_subsample + N/B scaling machinery as
the ELBO (SURVEY.md C4/C5).  The median is computed per step inside the
scan (a sort over N^2/static values — cheap for particle counts that fit
one chip; shard over the mesh's particle axis if N grows past that).
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax import lax

from ..core.logjoint import build_logjoint, init_to_uniform

__all__ = ["SVGD", "SVGDResult"]


class SVGDResult(NamedTuple):
    samples: dict              # site -> (num_particles, *event), constrained
    unconstrained: jax.Array   # (num_particles, dim)
    extra: dict                # phi_norm trace, final bandwidth


def _rbf(x):
    """Kernel matrix + the repulsion term sum_j grad_{x_j} k(x_j, x_i).

    For k = exp(-||xi-xj||^2 / h):  grad_j k(x_j, x_i) = 2/h (x_i - x_j) k,
    so the summed repulsion is (2/h) (x_i sum_j K_ij - (K x)_i)."""
    n = x.shape[0]
    sq = jnp.sum(x * x, -1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d2 = jnp.maximum(d2, 0.0)
    med = jnp.median(d2)
    h = jnp.maximum(med / jnp.log(n + 1.0), 1e-8)
    k = jnp.exp(-d2 / h)
    rep = (2.0 / h) * (x * jnp.sum(k, 1, keepdims=True) - k @ x)
    return k, rep, h


class SVGD:
    """``SVGD(model, num_particles=64, optimizer=optax.adam(1e-2))``."""

    def __init__(self, model=None, *, num_particles=64, optimizer=None,
                 num_steps=1000, model_args=(), model_kwargs=None):
        self.num_particles = int(num_particles)
        self.num_steps = int(num_steps)
        self.optimizer = optimizer or optax.adam(1e-2)

        info, logdensity, constrain_fn, _ = build_logjoint(
            model, *model_args, **(model_kwargs or {})
        )
        from .svi.elbo import draw_subsample
        from .svi.guides import unraveler
        dim, unravel_fn, ravel_fn = unraveler(info)
        self.info = info
        self.dim = dim
        self._ravel = ravel_fn
        self._constrain = lambda q: constrain_fn(unravel_fn(q))

        def grad_logp(q, key_b):
            sub = (draw_subsample(info, key_b)
                   if info.has_subsample else None)
            return jax.grad(
                lambda qq: logdensity(unravel_fn(qq), subsample=sub))(q)

        self._grad_logp = grad_logp

    def run(self, key) -> SVGDResult:
        key_init, key_run = jax.random.split(key)

        def init_one(i):
            return self._ravel(init_to_uniform(
                self.info, jax.random.fold_in(key_init, i)))

        x0 = jax.vmap(init_one)(jnp.arange(self.num_particles))
        opt0 = self.optimizer.init(x0)

        if not hasattr(self, "_run_fn"):
            def step(kr, carry, t):
                # kr threads as a traced value (a closed-over key would be
                # baked into the cached compiled program)
                x, opt = carry
                kb = jax.random.fold_in(kr, t)
                grads = jax.vmap(
                    lambda q, i: self._grad_logp(
                        q, jax.random.fold_in(kb, i))
                )(x, jnp.arange(self.num_particles))
                k, rep, h = _rbf(x)
                phi = (k @ grads + rep) / self.num_particles
                # optax minimises: pass -phi to ASCEND the Stein direction
                updates, opt = self.optimizer.update(-phi, opt, x)
                x = optax.apply_updates(x, updates)
                return (x, opt), (jnp.sqrt(jnp.mean(phi * phi)), h)

            def run_all(kr, x0, opt0):
                (x, _), (phin, hs) = lax.scan(
                    functools.partial(step, kr), (x0, opt0),
                    jnp.arange(self.num_steps))
                return x, phin, hs

            self._run_fn = jax.jit(run_all)

        x, phin, hs = self._run_fn(key_run, x0, opt0)
        cons = jax.vmap(self._constrain)(x)
        return SVGDResult(cons, x, {"phi_norm": phin,
                                    "bandwidth": hs[-1]})
