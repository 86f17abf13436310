"""Parallel tempering (replica exchange) MCMC.

Blueprint: SURVEY.md C8/C9 periphery — the multimodal-posterior capability
the tempered-SMC backend (C9) covers in one direction (annealing 0 -> 1)
made available as a stationary MCMC method: K replicas target
``prior * lik^beta_k`` on a ladder ``1 = beta_0 > ... > beta_{K-1}``, each
moves by HMC, and adjacent rungs exchange states with the standard
Metropolis swap rule ``log a = (beta_i - beta_j)(ll_j - ll_i)`` (the joint
product density is invariant).  Hot rungs cross energy barriers; swaps
transport their discoveries to the cold rung, whose marginal is exactly the
posterior.

Design choices:
  * replicas and chains are plain array axes — one vmapped lockstep HMC
    transition over (chains, K); a swap is an elementwise ``where`` select
    on the replica axis (no gathers, no host control flow, no collectives);
  * deterministic even–odd pairing alternates per step (Okabe et al. 2001):
    step t proposes swaps on pairs starting at parity t % 2, so every
    adjacent pair is tried every other step — fully parallel and
    reproducible, unlike random-pair schemes;
  * static-trajectory HMC keeps work uniform across rungs (NUTS's variable
    tree depth would make the lockstep vmap pay the max depth everywhere);
  * swaps move only ``q`` and the cached ``(log_prior, log_lik)`` scalars;
    each transition re-derives (pe, grad) at its own beta from a fresh
    evaluation at trajectory start — one extra gradient per transition
    (~1/num_steps overhead) buys cache-free correctness after any swap;
  * per-rung dual-averaging step size + diagonal Welford mass during
    warmup, pooled across chains within a rung (hot rungs need larger
    steps; SURVEY.md C8 adaptation machinery reused verbatim).

``chain_sharding`` shards the chain axis over a mesh exactly like MCMC
(SURVEY.md C13a); the replica axis stays on-device so swaps never cross
chips.
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...core.logjoint import build_logjoint, init_to_uniform
from ...core.precision import exact
from .adapt import (
    build_schedule,
    da_init,
    da_update,
    welford_finalize,
    welford_init,
    welford_update_batch,
)

__all__ = ["ParallelTempering", "PTResult", "geometric_ladder"]


class PTResult(NamedTuple):
    samples: dict         # site -> (chains, num_samples, *event)  [beta=1]
    extra: dict           # swap_accept (K-1,), step_size (K,), ladder ...
    unconstrained: jax.Array   # (chains, num_samples, dim) cold rung


class _PTState(NamedTuple):
    q: jax.Array          # (C, K, dim)
    lp: jax.Array         # (C, K) log prior (+ Jacobians)
    ll: jax.Array         # (C, K) log likelihood


def _ti_evidence(betas, lls):
    """Thermodynamic integration: log Z = int_0^1 E_beta[loglik] d beta,
    trapezoid over the ladder (ascending).  lls: (S, C, K).  Covers only
    [min(betas), 1] — pass a ladder that reaches beta=0 (e.g.
    ``betas=jnp.concatenate([geometric_ladder(K-1), jnp.zeros(1)])``) for
    an unbiased marginal-likelihood estimate."""
    mean_ll = jnp.mean(lls, axis=(0, 1))              # (K,) per rung
    order = jnp.argsort(betas)
    b = betas[order]
    m = mean_ll[order]
    return jnp.sum(0.5 * (m[1:] + m[:-1]) * (b[1:] - b[:-1]))


def _stepping_stone(betas, lls):
    """Stepping-stone (Xie et al. 2011): log Z = sum_k log
    E_{beta_k}[exp((beta_{k+1}-beta_k) ll)], adjacent rungs ascending,
    each expectation estimated from the LOWER rung's draws (logsumexp over
    S*C samples).  Same ladder-coverage caveat as TI."""
    order = jnp.argsort(betas)
    b = betas[order]
    ll_sorted = lls[:, :, order].reshape(-1, betas.shape[0])   # (S*C, K)
    n = ll_sorted.shape[0]
    delta = b[1:] - b[:-1]                             # (K-1,)
    terms = jax.scipy.special.logsumexp(
        delta[None, :] * ll_sorted[:, :-1], axis=0) - jnp.log(n)
    return jnp.sum(terms)


def geometric_ladder(num_replicas, beta_min=0.05):
    """beta_k = beta_min^(k/(K-1)); the standard default for lik-tempering."""
    if num_replicas == 1:
        return jnp.ones((1,))
    k = np.arange(num_replicas) / (num_replicas - 1)
    return jnp.asarray(beta_min ** k, jnp.float32)


class ParallelTempering:
    def __init__(self, model=None, *, num_replicas=8, betas=None,
                 beta_min=0.05, num_warmup=500, num_samples=1000,
                 num_chains=8, num_leapfrog=16, target_accept=0.8,
                 init_step_size=0.1, model_args=(), model_kwargs=None,
                 chain_sharding=None):
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.num_leapfrog = int(num_leapfrog)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.chain_sharding = chain_sharding
        self.betas = (jnp.asarray(betas, jnp.float32) if betas is not None
                      else geometric_ladder(num_replicas, beta_min))
        self.K = int(self.betas.shape[0])
        if betas is not None:
            b = np.asarray(self.betas)
            # samples come from replica index 0: the ladder must be
            # NON-INCREASING from the cold rung beta=1 (an ascending
            # ladder would silently return near-prior draws as
            # "posterior"; a flat all-1 ladder is legal for testing)
            if abs(float(b[0]) - 1.0) > 1e-6 or np.any(np.diff(b) > 0):
                raise ValueError(
                    "betas must descend from 1.0 (cold rung first), e.g. "
                    "concatenate([geometric_ladder(K-1), zeros(1)]); got "
                    f"{b.tolist()}"
                )

        info, logdensity, constrain_fn, _ = build_logjoint(
            model, *model_args, **(model_kwargs or {})
        )
        parts = logdensity.parts
        from ..svi.guides import unraveler
        dim, unravel_fn, _ = unraveler(info)
        self.info = info
        self.dim = dim
        self._constrain = lambda q: constrain_fn(unravel_fn(q))

        def parts_q(q):
            lp, ll = parts(unravel_fn(q))
            return lp, ll

        self._parts = parts_q

        def pe_grad(q, beta):
            def f(qq):
                lp, ll = parts_q(qq)
                return -(lp + beta * ll)

            return jax.value_and_grad(f)(q)

        self._pe_grad = pe_grad

    # ------------------------------------------------------------------
    def _hmc_transition(self, key, q0, beta, eps, inv_mass):
        """One static-trajectory HMC transition on U = -(lp + beta*ll),
        recomputing (pe, grad) at the start (q0 may have been swapped in).
        Returns (q1, accept_prob)."""
        key_mom, key_acc = jax.random.split(key)
        pe0, grad0 = self._pe_grad(q0, beta)
        p0 = jax.random.normal(key_mom, q0.shape) / jnp.sqrt(inv_mass)
        h0 = pe0 + 0.5 * jnp.sum(inv_mass * p0 * p0)

        def leap(carry, _):
            q, p, grad = carry
            p_half = p - 0.5 * eps * grad
            q_new = q + eps * inv_mass * p_half
            pe_new, grad_new = self._pe_grad(q_new, beta)
            p_new = p_half - 0.5 * eps * grad_new
            return (q_new, p_new, grad_new), pe_new

        (q1, p1, _), pes = lax.scan(
            leap, (q0, p0, grad0), None, length=self.num_leapfrog)
        h1 = pes[-1] + 0.5 * jnp.sum(inv_mass * p1 * p1)
        delta = jnp.where(jnp.isnan(h1 - h0), jnp.inf, h1 - h0)
        accept_prob = jnp.minimum(1.0, jnp.exp(-delta))
        accept = jax.random.uniform(key_acc) < accept_prob
        return jnp.where(accept, q1, q0), accept_prob

    # the transitions and the init compute every energy: pinned whole
    # (core/precision.py)
    @exact
    def _transition_all(self, key, state: _PTState, eps_k, inv_mass_k):
        """Vmapped lockstep transition over (chains, K) + parts refresh."""
        kc = jax.vmap(
            lambda c: jax.vmap(
                lambda k: jax.random.fold_in(jax.random.fold_in(key, c), k)
            )(jnp.arange(self.K))
        )(jnp.arange(self.num_chains))

        q1, acc = jax.vmap(
            jax.vmap(self._hmc_transition,
                     in_axes=(0, 0, 0, 0, 0)),
            in_axes=(0, 0, None, None, None),
        )(kc, state.q, self.betas, eps_k, inv_mass_k)
        lp, ll = jax.vmap(jax.vmap(self._parts))(q1)
        return _PTState(q1, lp, ll), acc

    def _swap(self, key, state: _PTState, parity):
        """Even–odd adjacent swaps at the given parity (0 or 1): pair
        (k, k+1) for k = parity, parity+2, ...  Pure where-selects."""
        k_idx = jnp.arange(self.K)
        # partner of rung k at this parity (identity at the boundary)
        down = jnp.where((k_idx % 2) == parity, k_idx + 1, k_idx - 1)
        partner = jnp.clip(down, 0, self.K - 1)
        valid = partner != k_idx

        ll_p = state.ll[:, partner]                       # (C, K)
        beta = self.betas[None, :]
        beta_p = self.betas[partner][None, :]
        # log alpha for the PAIR (computed identically from both sides)
        log_a = (beta - beta_p) * (ll_p - state.ll)
        u = jax.random.uniform(key, (self.num_chains, self.K // 2 + 1))
        # one uniform per pair, shared by both members: index pairs by
        # min(k, partner) // 2
        pair_id = jnp.minimum(k_idx, partner) // 2
        u_k = u[:, pair_id]                               # (C, K)
        do_swap = valid[None, :] & (jnp.log(u_k) < log_a)

        def sel(a):
            a_p = a[:, partner]
            return jnp.where(
                do_swap[(...,) + (None,) * (a.ndim - 2)], a_p, a)

        swapped = _PTState(sel(state.q), sel(state.lp), sel(state.ll))
        # per-pair accept indicator for the rate diagnostic: count at the
        # lower rung of each pair
        lower = valid & (k_idx < partner)
        pair_acc = jnp.where(lower[None, :], do_swap, 0.0)
        return swapped, pair_acc

    # ------------------------------------------------------------------
    @exact
    def _init_state(self, key):
        def one(c, k):
            kk = jax.random.fold_in(jax.random.fold_in(key, c), k)
            u = init_to_uniform(self.info, kk)
            from ..svi.guides import unraveler
            _, _, ravel = unraveler(self.info)
            return ravel(u)

        q = jax.vmap(
            lambda c: jax.vmap(lambda k: one(c, k))(jnp.arange(self.K))
        )(jnp.arange(self.num_chains))
        lp, ll = jax.vmap(jax.vmap(self._parts))(q)
        st = _PTState(q, lp, ll)
        if self.chain_sharding is not None:
            st = jax.device_put(st, self.chain_sharding)
        return st

    def run(self, key) -> PTResult:
        """Warmup (per-rung step-size/mass adaptation + swaps) then
        sampling; one compiled program each, cached on the instance."""
        key_init, key_run = jax.random.split(key)
        state0 = self._init_state(key_init)

        if not hasattr(self, "_run_fn"):
            in_slow, window_end = build_schedule(self.num_warmup)
            in_slow = jnp.asarray(in_slow)
            window_end = jnp.asarray(window_end)

            def warm_step(kr, carry, t):
                # kr threads in as a traced value — a closed-over key
                # would be baked into the cached compiled program,
                # freezing later runs' randomness
                state, da, wf, inv_mass = carry
                kt = jax.random.fold_in(jax.random.fold_in(kr, 0), t)
                k_hmc, k_swap = jax.random.split(kt)
                eps_k = jnp.exp(da.log_step)              # (K,)
                state, acc = self._transition_all(
                    k_hmc, state, eps_k, inv_mass)
                state, _ = self._swap(k_swap, state, t % 2)
                da = jax.vmap(
                    lambda d, a: da_update(d, a, target=self.target_accept)
                )(da, jnp.mean(acc, axis=0))
                # per-rung Welford over chains (batch update)
                wf_new = jax.vmap(welford_update_batch, in_axes=(0, 1))(
                    wf, state.q)
                wf = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(in_slow[t], new, old),
                    wf_new, wf)
                new_inv = jax.vmap(welford_finalize)(wf)
                inv_mass = jnp.where(window_end[t], new_inv, inv_mass)
                wf_reset = jax.vmap(
                    lambda _: welford_init(self.dim, dense=False)
                )(jnp.arange(self.K))
                wf = jax.tree_util.tree_map(
                    lambda r, kk: jnp.where(window_end[t], r, kk),
                    wf_reset, wf)
                da_reset = jax.vmap(da_init)(jnp.exp(da.log_step))
                da = jax.tree_util.tree_map(
                    lambda r, kk: jnp.where(window_end[t], r, kk),
                    da_reset, da)
                return (state, da, wf, inv_mass), None

            def sample_step(kr, carry, t):
                state, eps_k, inv_mass = carry
                kt = jax.random.fold_in(jax.random.fold_in(kr, 1), t)
                k_hmc, k_swap = jax.random.split(kt)
                state, acc = self._transition_all(
                    k_hmc, state, eps_k, inv_mass)
                state, pair_acc = self._swap(k_swap, state, t % 2)
                return ((state, eps_k, inv_mass),
                        (state.q[:, 0, :], jnp.mean(acc, 0),
                         jnp.mean(pair_acc, 0), state.ll))

            def run_all(kr, s0):
                da0 = jax.vmap(
                    lambda _: da_init(jnp.asarray(self.init_step_size))
                )(jnp.arange(self.K))
                wf0 = jax.vmap(
                    lambda _: welford_init(self.dim, dense=False)
                )(jnp.arange(self.K))
                inv0 = jnp.ones((self.K, self.dim))
                (state, da, _, inv_mass), _ = lax.scan(
                    functools.partial(warm_step, kr),
                    (s0, da0, wf0, inv0), jnp.arange(self.num_warmup))
                eps_k = jnp.exp(da.log_step_avg)
                _, (qs, accs, swaps, lls) = lax.scan(
                    functools.partial(sample_step, kr),
                    (state, eps_k, inv_mass),
                    jnp.arange(self.num_samples))
                return qs, accs, swaps, lls, eps_k

            self._run_fn = jax.jit(run_all)

        qs, accs, swaps, lls, eps_k = self._run_fn(key_run, state0)
        # qs: (S, C, dim) -> (C, S, dim)
        qs = jnp.swapaxes(qs, 0, 1)
        flat = qs.reshape(-1, self.dim)
        cons = jax.vmap(self._constrain)(flat)
        samples = {name: val.reshape(qs.shape[:2] + val.shape[1:])
                   for name, val in cons.items()}
        # each pair is proposed every other step -> rate = 2 * mean
        k_idx = np.arange(self.K)
        swap_rate = 2.0 * jnp.mean(swaps, axis=0)[k_idx[:-1]]
        extra = {
            "accept_prob": jnp.mean(accs, axis=0),
            "swap_accept": swap_rate,
            "step_size": eps_k,
            "betas": self.betas,
            # lls: (S, C, K) likelihood draws per rung
            "log_evidence_ti": _ti_evidence(self.betas, lls),
            "log_evidence_ss": _stepping_stone(self.betas, lls),
        }
        return PTResult(samples, extra, qs)
