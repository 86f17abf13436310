"""NUTS-within-Gibbs for models with enumerable discrete latents
(SURVEY.md C8 extension; NumPyro's ``DiscreteHMCGibbs`` analogue).

Plain NUTS on an enumerated model marginalises the discrete sites inside
EVERY leapfrog step — each gradient evaluation pays the full enumeration
broadcast (support size K per site).  This driver alternates instead:

  1. ``z ~ p(z | u, data)`` — one exact joint conditional draw of all
     enumerated sites via the log-joint compiler's ``sample_enum``
     (variable elimination, one enumeration per TRANSITION);
  2. one NUTS transition on the CONDITIONAL density ``p(u, z, data)``
     with z fixed — every leapfrog step is a plain replay, no
     enumeration broadcast.

Both moves leave the joint ``p(u, z | data)`` invariant, so the scan is a
valid systematic Gibbs composition.  The win over marginal NUTS grows with
support size and tree depth (enumeration cost moves from O(leapfrogs) to
O(1) per transition); marginal NUTS remains preferable when K is small —
Rao-Blackwellised gradients mix better.

Compiled shape: the whole run is the same two fused ``lax.scan`` programs as
``MCMC`` (warmup, sampling), chains vectorized by ``vmap`` and shardable
over a mesh axis by logical chain index (SURVEY.md C13a).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ...core.logjoint import build_logjoint, init_to_uniform
from ...core.precision import exact
from .adapt import (
    build_schedule,
    da_init,
    da_update,
    welford_finalize,
    welford_init,
    welford_update,
)
from .integrators import IntegratorState
from .nuts import make_nuts_kernel

__all__ = ["DiscreteGibbs", "GibbsResult"]


class GibbsResult(NamedTuple):
    samples: dict             # continuous (constrained) AND discrete sites
    extra: dict               # diverging, accept_prob, step_size, inv_mass
    unconstrained: jax.Array  # (chains, samples, dim) continuous part


class _GibbsCarry(NamedTuple):
    state: IntegratorState    # batched over chains (continuous part)
    z: Any                    # dict enum-site -> (chains, *site shape) int
    da: Any
    wf: Any
    inv_mass: jax.Array
    step_size: jax.Array


class DiscreteGibbs:
    """NUTS-within-Gibbs driver over a model whose discrete latents are
    marked ``infer={"enumerate": True}`` (same contract as marginal NUTS /
    ``infer_discrete``; subsample-free models only, because conditionals
    under minibatch scaling are not the true conditionals)."""

    def __init__(self, model, *, num_warmup=1000, num_samples=1000,
                 num_chains=4, max_depth=8, target_accept=0.8,
                 init_step_size=0.1, model_args=(), model_kwargs=None,
                 chain_sharding=None):
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.max_depth = int(max_depth)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.chain_sharding = chain_sharding

        info, logdensity, constrain_fn, _ = build_logjoint(
            model, *model_args, **(model_kwargs or {})
        )
        if not info.enum_sites:
            raise ValueError(
                "DiscreteGibbs needs enumerated discrete sites "
                "(infer={'enumerate': True}); for fully continuous models "
                "use MCMC."
            )
        if info.subsample_sites:
            raise ValueError(
                "DiscreteGibbs requires a subsample-free model (exact "
                "conditionals need full plates)."
            )
        self.info = info
        self._logdensity = logdensity
        from ..svi.guides import unraveler

        dim, unravel, ravel = unraveler(info)
        self.dim = dim
        self._unravel = unravel
        self._ravel = ravel
        self._constrain = lambda q: constrain_fn(unravel(q))

    # -- per-chain moves -------------------------------------------------
    def _pag(self, z):
        unravel = self._unravel
        given = self._logdensity.given_enum

        def pag(q):
            return jax.value_and_grad(
                lambda qq: -given(unravel(qq), z)
            )(q)

        return pag

    # the sweep and the init compute every energy: pinned whole
    # (core/precision.py)
    @exact
    def _chain_step(self, key, state, z, eps, inv_mass):
        """One Gibbs sweep for one chain: exact z | u draw, then one NUTS
        transition on p(u | z)."""
        kz, kh = jax.random.split(key)
        z_new = self._logdensity.sample_enum(self._unravel(state.q), kz)
        pag = self._pag(z_new)
        # z changed -> the cached potential/grad are stale; refresh
        pe, grad = pag(state.q)
        state = IntegratorState(state.q, state.p, pe, grad)
        kernel = make_nuts_kernel(pag, max_depth=self.max_depth)
        state, nfo = kernel(kh, state, eps, inv_mass)
        return state, z_new, nfo

    # -- init --------------------------------------------------------------
    @exact
    def _initial_carry(self, key):
        def one(i):
            k = jax.random.fold_in(key, i)
            ku, kz = jax.random.split(k)
            u = init_to_uniform(self.info, ku)
            q = self._ravel(u)
            z = self._logdensity.sample_enum(u, kz)
            pe, grad = self._pag(z)(q)
            return IntegratorState(q, jnp.zeros_like(q), pe, grad), z

        states, z = jax.vmap(one)(jnp.arange(self.num_chains))
        if self.chain_sharding is not None:
            states = jax.device_put(states, self.chain_sharding)
            z = jax.device_put(z, self.chain_sharding)
        da0 = jax.vmap(
            lambda _: da_init(jnp.asarray(self.init_step_size))
        )(jnp.arange(self.num_chains))
        wf0 = jax.vmap(lambda _: welford_init(self.dim))(
            jnp.arange(self.num_chains))
        inv_mass0 = jnp.ones((self.num_chains, self.dim))
        step0 = jnp.full((self.num_chains,), self.init_step_size)
        return _GibbsCarry(states, z, da0, wf0, inv_mass0, step0)

    # -- fused run -----------------------------------------------------------
    def run(self, key, jit=True) -> GibbsResult:
        key_init, key_warm, key_samp = jax.random.split(key, 3)
        carry0 = self._initial_carry(key_init)

        in_slow, window_end = build_schedule(self.num_warmup)
        in_slow = jnp.asarray(in_slow)
        window_end = jnp.asarray(window_end)
        target = self.target_accept

        def keys_at(base, t):
            return jax.vmap(
                lambda c: jax.random.fold_in(jax.random.fold_in(base, t), c)
            )(jnp.arange(self.num_chains))

        def warm_step(key_warm, carry, t):
            keys = keys_at(key_warm, t)
            eps = jnp.exp(carry.da.log_step)
            state, z, nfo = jax.vmap(self._chain_step)(
                keys, carry.state, carry.z, eps, carry.inv_mass)
            da = jax.vmap(
                lambda d, a: da_update(d, a, target=target)
            )(carry.da, nfo.accept_prob)
            wf_new = jax.vmap(welford_update)(carry.wf, state.q)
            wf = jax.tree_util.tree_map(
                lambda new, old: jnp.where(in_slow[t], new, old),
                wf_new, carry.wf,
            )
            new_inv = jax.vmap(welford_finalize)(wf)
            inv_mass = jnp.where(window_end[t], new_inv, carry.inv_mass)
            wf_reset = jax.vmap(lambda _: welford_init(self.dim))(
                jnp.arange(self.num_chains))
            da_reset = jax.vmap(da_init)(jnp.exp(da.log_step))
            wf = jax.tree_util.tree_map(
                lambda r, k: jnp.where(window_end[t], r, k), wf_reset, wf)
            da = jax.tree_util.tree_map(
                lambda r, k: jnp.where(window_end[t], r, k), da_reset, da)
            return _GibbsCarry(state, z, da, wf, inv_mass,
                               jnp.exp(da.log_step)), None

        def sample_step(key_samp, carry, t):
            state, z, step_size, inv_mass = carry
            keys = keys_at(key_samp, t)
            state, z, nfo = jax.vmap(self._chain_step)(
                keys, state, z, step_size, inv_mass)
            return (state, z, step_size, inv_mass), (
                state.q, z, nfo.diverging, nfo.accept_prob)

        def run_all(kw, ks, c0):
            carry, _ = lax.scan(
                lambda c, t: warm_step(kw, c, t), c0,
                jnp.arange(self.num_warmup))
            step_size = jnp.exp(carry.da.log_step_avg)
            samp0 = (carry.state, carry.z, step_size, carry.inv_mass)
            _, coll = lax.scan(
                lambda c, t: sample_step(ks, c, t), samp0,
                jnp.arange(self.num_samples))
            return coll + (step_size, carry.inv_mass)

        if jit:
            if not hasattr(self, "_run_fn"):
                self._run_fn = jax.jit(run_all)
            qs, zs, divs, accs, step_size, inv_mass = self._run_fn(
                key_warm, key_samp, carry0)
        else:
            qs, zs, divs, accs, step_size, inv_mass = run_all(
                key_warm, key_samp, carry0)

        # qs: (samples, chains, dim) -> (chains, samples, dim)
        qs = jnp.swapaxes(qs, 0, 1)
        flat = qs.reshape(-1, self.dim)
        cons = jax.vmap(self._constrain)(flat)
        samples = {
            name: v.reshape(qs.shape[:2] + v.shape[1:])
            for name, v in cons.items()
        }
        for name, v in zs.items():
            samples[name] = jnp.swapaxes(v, 0, 1)
        extra = {
            "diverging": jnp.swapaxes(divs, 0, 1),
            "accept_prob": jnp.swapaxes(accs, 0, 1),
            "step_size": step_size,
            "inv_mass": inv_mass,
        }
        return GibbsResult(samples, extra, qs)
