"""MCMC driver: warmup + sampling as two compiled XLA programs, chains
vectorized with vmap and shardable over a mesh axis.

Blueprint: SURVEY.md C8 + §3.2 call stack: "warmup: jit(scan over warmup
steps) ... sampling: jit(scan over num_samples); thinned states written to
sharded output buffer; zero per-step collectives during sampling".  Chain
parallelism (SURVEY.md C13a): every per-chain quantity is keyed by *logical*
chain index (fold_in), never by device, so any sharding of the chain axis
starts from the same states and draws the same random numbers (§7
hard-part 3): bit-identical samples on the CPU; on a GPU a reduction's
order may follow the per-device batch, so chains agree to float32 rounding
per step and in distribution over a long run.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...core.logjoint import build_logjoint, init_to_uniform
from ...core.precision import exact
from ...utils import diagnostics as diag
from .adapt import (
    build_schedule,
    da_init,
    da_update,
    welford_finalize,
    welford_init,
    welford_update,
    welford_update_batch,
)
from .hmc import make_hmc_kernel
from .integrators import IntegratorState
from .nuts import make_nuts_kernel

__all__ = ["MCMC", "MCMCResult"]


class MCMCResult(NamedTuple):
    samples: dict            # site -> (chains, samples, *event) constrained
    extra: dict              # divergences, accept_prob, depth, step_size, inv_mass
    unconstrained: jax.Array  # (chains, samples, dim)


class _WarmupCarry(NamedTuple):
    state: IntegratorState   # batched over chains
    da: Any
    wf: Any
    inv_mass: jax.Array
    step_size: jax.Array


class MCMC:
    """NUTS/HMC driver.

    Parameters mirror the capability surface in SURVEY.md C8: multinomial
    NUTS with dual-averaging step size + windowed Welford (diag or dense)
    mass adaptation, divergence accounting, many vectorized chains.
    """

    def __init__(self, model=None, *, potential_and_grad=None, example_q=None,
                 unravel=None, constrain=None,
                 kernel="nuts", num_warmup=1000, num_samples=1000,
                 num_chains=4, max_depth=10, target_accept=0.8,
                 dense_mass=False, init_step_size=0.1, thin=1,
                 hmc_num_steps=32, model_args=(), model_kwargs=None,
                 chain_sharding=None, shared_adapt=False, init_params=None):
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thin = int(thin)
        self.target_accept = float(target_accept)
        self.dense_mass = bool(dense_mass)
        self.init_step_size = float(init_step_size)
        self.chain_sharding = chain_sharding
        # pooled cross-chain adaptation (one step size / mass matrix fed by
        # every chain's statistics) — the right regime for 100s-1000s of
        # chains (SURVEY.md C13a; configs[4] 1024-chain NUTS)
        self.shared_adapt = bool(shared_adapt)
        # optional (num_chains, dim) unconstrained chain inits — e.g.
        # pathfinder draws (infer/pathfinder.py), the standard cheap
        # warm start for NUTS
        self.init_params = (
            None if init_params is None else jnp.asarray(init_params)
        )

        if model is not None:
            info, logdensity, constrain_fn, _ = build_logjoint(
                model, *model_args, **(model_kwargs or {})
            )
            from ..svi.guides import unraveler
            dim, unravel_fn, _ = unraveler(info)
            self.info = info
            self.dim = dim
            self._unravel = unravel_fn

            def pag(q):
                return jax.value_and_grad(
                    lambda qq: -logdensity(unravel_fn(qq))
                )(q)

            self._potential_and_grad = pag
            self._constrain = lambda q: constrain_fn(unravel_fn(q))
        else:
            if potential_and_grad is None or example_q is None:
                raise ValueError(
                    "pass either model= or (potential_and_grad=, example_q=)"
                )
            self.info = None
            self.dim = int(np.prod(jnp.shape(example_q)))
            self._potential_and_grad = potential_and_grad
            self._unravel = unravel or (lambda q: q)
            self._constrain = constrain or (lambda q: {"q": q})

        if self.init_params is not None and (
            self.init_params.ndim != 2
            or self.init_params.shape != (self.num_chains, self.dim)
        ):
            raise ValueError(
                f"init_params must be (num_chains, dim) = "
                f"({self.num_chains}, {self.dim}); got "
                f"{tuple(self.init_params.shape)}.  Rows must be "
                "UNCONSTRAINED-space points (e.g. "
                "PathfinderResult.unconstrained rows), one per chain."
            )

        if kernel == "nuts":
            self._kernel = make_nuts_kernel(
                self._potential_and_grad, max_depth=max_depth
            )
        elif kernel == "hmc":
            self._kernel = make_hmc_kernel(
                self._potential_and_grad, num_steps=hmc_num_steps
            )
        else:
            raise ValueError(f"unknown kernel {kernel!r}")

    # ------------------------------------------------------------------
    # Every product an acceptance decision reads (potential, kinetic
    # energy, U-turn checks) is computed inside _init_states or the steps
    # of _build_steps: both are pinned whole (core/precision.py).
    @exact
    def _init_states(self, key, init_params=None):
        def one(i):
            k = jax.random.fold_in(key, i)
            if init_params is not None:
                q = init_params[i]
            elif self.info is not None:
                u = init_to_uniform(self.info, k)
                from ..svi.guides import unraveler
                _, _, ravel = unraveler(self.info)
                q = ravel(u)
            else:
                q = jax.random.uniform(k, (self.dim,), minval=-2.0,
                                       maxval=2.0)
            pe, grad = self._potential_and_grad(q)
            return IntegratorState(q, jnp.zeros_like(q), pe, grad)

        states = jax.vmap(one)(jnp.arange(self.num_chains))
        if self.chain_sharding is not None:
            states = jax.device_put(states, self.chain_sharding)
        return states

    def _initial_mass(self):
        if self.dense_mass:
            return jnp.eye(self.dim)
        return jnp.ones(self.dim)

    # ------------------------------------------------------------------
    def _initial_carry(self, key_init):
        states = self._init_states(key_init, init_params=self.init_params)
        if self.shared_adapt:
            inv_mass0 = self._initial_mass()
            da0 = da_init(jnp.asarray(self.init_step_size))
            wf0 = welford_init(self.dim, dense=self.dense_mass)
        else:
            inv_mass0 = jnp.broadcast_to(
                self._initial_mass(),
                (self.num_chains,) + self._initial_mass().shape,
            )
            da0 = jax.vmap(
                lambda _: da_init(jnp.asarray(self.init_step_size))
            )(jnp.arange(self.num_chains))
            wf0 = jax.vmap(
                lambda _: welford_init(self.dim, dense=self.dense_mass)
            )(jnp.arange(self.num_chains))
        step0 = (
            jnp.asarray(self.init_step_size) if self.shared_adapt
            else jnp.full((self.num_chains,), self.init_step_size)
        )
        return _WarmupCarry(states, da0, wf0, inv_mass0, step0)

    def _build_steps(self):
        """Key-independent step builders shared by all run modes: returns
        ``(warm_step, sample_step)``, each taking ``(key, carry, t)`` with t
        the *absolute* step — so any chunking of the scans reproduces the
        monolithic run exactly, and the PRNG keys stay traced arguments
        (fresh keys never trigger a recompile)."""
        in_slow, window_end = build_schedule(self.num_warmup)
        in_slow = jnp.asarray(in_slow)
        window_end = jnp.asarray(window_end)

        kernel = self._kernel
        target = self.target_accept

        def run_chains(keys, state, eps, inv_mass):
            """One transition over all chains sharing one step size and
            inverse mass."""
            return jax.vmap(
                kernel, in_axes=(0, 0, None, None)
            )(keys, state, eps, inv_mass)

        def warm_step(key_warm, carry: _WarmupCarry, t):
            keys = jax.vmap(
                lambda c: jax.random.fold_in(jax.random.fold_in(key_warm, t),
                                             c)
            )(jnp.arange(self.num_chains))
            eps = jnp.exp(carry.da.log_step)
            if self.shared_adapt:
                state, info = run_chains(
                    keys, carry.state, eps, carry.inv_mass)
                da = da_update(carry.da, jnp.mean(info.accept_prob),
                               target=target)
                wf_new = welford_update_batch(carry.wf, state.q)
                wf = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(in_slow[t], new, old),
                    wf_new, carry.wf,
                )
                new_inv_mass = welford_finalize(wf)
                inv_mass = jnp.where(
                    window_end[t], new_inv_mass, carry.inv_mass
                )
                wf_reset = welford_init(self.dim, dense=self.dense_mass)
                da_reset = da_init(jnp.exp(da.log_step))
            else:
                state, info = jax.vmap(kernel)(keys, carry.state, eps,
                                               carry.inv_mass)
                da = jax.vmap(
                    lambda d, a: da_update(d, a, target=target)
                )(carry.da, info.accept_prob)
                wf_new = jax.vmap(welford_update)(carry.wf, state.q)
                wf = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(in_slow[t], new, old),
                    wf_new, carry.wf,
                )
                new_inv_mass = jax.vmap(welford_finalize)(wf)
                inv_mass = jnp.where(
                    window_end[t], new_inv_mass, carry.inv_mass
                )
                wf_reset = jax.vmap(
                    lambda _: welford_init(self.dim, dense=self.dense_mass)
                )(jnp.arange(self.num_chains))
                da_reset = jax.vmap(da_init)(jnp.exp(da.log_step))
            wf = jax.tree_util.tree_map(
                lambda r, k: jnp.where(window_end[t], r, k), wf_reset, wf
            )
            da = jax.tree_util.tree_map(
                lambda r, k: jnp.where(window_end[t], r, k), da_reset, da
            )
            new_carry = _WarmupCarry(
                state, da, wf, inv_mass, jnp.exp(da.log_step)
            )
            return new_carry, info.accept_prob

        def one_transition(key_samp, state, step_size, inv_mass, t):
            keys = jax.vmap(
                lambda c: jax.random.fold_in(jax.random.fold_in(key_samp, t),
                                             c)
            )(jnp.arange(self.num_chains))
            if self.shared_adapt:
                return run_chains(keys, state, step_size, inv_mass)
            return jax.vmap(kernel)(keys, state, step_size, inv_mass)

        def sample_step(key_samp, carry, t):
            # in-scan thinning: `thin` transitions per collected sample, so
            # the output buffer holds only kept draws (memory matters at
            # 1024 chains, SURVEY.md §3.2 "thinned states written to sharded
            # output buffer")
            state, step_size, inv_mass = carry

            def inner(i, st):
                st, _ = one_transition(key_samp, st, step_size, inv_mass,
                                       t * self.thin + i)
                return st

            if self.thin > 1:
                state = lax.fori_loop(0, self.thin - 1, inner, state)
            state, info = one_transition(key_samp, state, step_size, inv_mass,
                                         t * self.thin + self.thin - 1)
            collect = (
                state.q, info.diverging, info.accept_prob,
                getattr(info, "depth", jnp.zeros_like(info.diverging,
                                                      jnp.int32)),
                info.num_steps,
            )
            return (state, step_size, inv_mass), collect

        return exact(warm_step), exact(sample_step)

    def warmup_and_sample(self, key, with_states=False):
        """Build the full (jit-able) warmup+sampling computation.

        With ``with_states=True`` returns ``(run_all, carry0)`` where
        ``run_all(carry0)`` takes the (possibly chain-sharded) initial
        carry as a traced jit argument — required for cross-process
        shardings (a multi-host array cannot be a closure constant).  The
        default zero-arg form is kept for single-process callers."""
        key_init, key_warm, key_samp = jax.random.split(key, 3)
        carry0 = self._initial_carry(key_init)
        warm_step, sample_step = self._build_steps()

        def run_all(c0):
            carry, _ = lax.scan(
                lambda c, t: warm_step(key_warm, c, t), c0,
                jnp.arange(self.num_warmup)
            )
            step_size = jnp.exp(carry.da.log_step_avg)
            samp0 = (carry.state, step_size, carry.inv_mass)
            _, collected = lax.scan(
                lambda c, t: sample_step(key_samp, c, t), samp0,
                jnp.arange(self.num_samples)
            )
            qs, divs, accs, depths, nsteps = collected
            return qs, divs, accs, depths, nsteps, step_size, carry.inv_mass

        if with_states:
            return run_all, carry0
        return lambda: run_all(carry0)

    def run(self, key, jit=True) -> MCMCResult:
        key_init, key_warm, key_samp = jax.random.split(key, 3)
        carry0 = self._initial_carry(key_init)
        # cache the compiled program on the instance with the PRNG keys as
        # traced arguments: repeated run() calls with fresh keys never
        # re-trace
        if jit:
            if not hasattr(self, "_run_fn"):
                warm_step, sample_step = self._build_steps()

                def run_all(kw, ks, c0):
                    carry, _ = lax.scan(
                        lambda c, t: warm_step(kw, c, t), c0,
                        jnp.arange(self.num_warmup)
                    )
                    step_size = jnp.exp(carry.da.log_step_avg)
                    samp0 = (carry.state, step_size, carry.inv_mass)
                    _, collected = lax.scan(
                        lambda c, t: sample_step(ks, c, t), samp0,
                        jnp.arange(self.num_samples)
                    )
                    qs, divs, accs, depths, nsteps = collected
                    return (qs, divs, accs, depths, nsteps, step_size,
                            carry.inv_mass)

                self._run_fn = jax.jit(run_all)
            out = self._run_fn(key_warm, key_samp, carry0)
        else:
            run_all, c0 = self.warmup_and_sample(key, with_states=True)
            out = run_all(c0)
        return self._package(*out)

    def run_segmented(self, key, warmup_chunk=100, sample_chunk=100,
                      fence=None) -> MCMCResult:
        """Warmup+sampling as a sequence of shorter XLA programs with a
        host fence between segments, numerically identical to :meth:`run`
        (both index schedule and PRNG stream by absolute step).

        This is the long-adaptation path: each segment is a bounded
        program, state threads through the host fence, and collected
        samples land on the host per chunk (bounding device memory at many
        chains).  ``fence`` defaults
        to a ``device_get`` of a value that data-depends on the whole
        segment.  Compiled segment programs are cached on the instance and
        keyed only by segment length — PRNG keys ride as traced arguments,
        so repeated runs with fresh keys never recompile."""
        key_init, key_warm, key_samp = jax.random.split(key, 3)
        carry = self._initial_carry(key_init)
        warm_step, sample_step = self._build_steps()
        if fence is None:
            def fence(leaf):
                return np.asarray(jax.device_get(leaf))

        if not hasattr(self, "_seg_fns"):
            self._seg_fns = {}

        def warm_fn(length):
            k = ("warm", length)
            if k not in self._seg_fns:
                self._seg_fns[k] = jax.jit(lambda kw, c, lo: lax.scan(
                    lambda cc, t: warm_step(kw, cc, t), c,
                    lo + jnp.arange(length))[0])
            return self._seg_fns[k]

        def samp_fn(length):
            k = ("samp", length)
            if k not in self._seg_fns:
                self._seg_fns[k] = jax.jit(lambda ks, c, lo: lax.scan(
                    lambda cc, t: sample_step(ks, cc, t), c,
                    lo + jnp.arange(length)))
            return self._seg_fns[k]

        for lo in range(0, self.num_warmup, warmup_chunk):
            n = min(warmup_chunk, self.num_warmup - lo)
            carry = warm_fn(n)(key_warm, carry, jnp.asarray(lo, jnp.int32))
            fence(carry.step_size)

        step_size = jnp.exp(carry.da.log_step_avg)
        samp = (carry.state, step_size, carry.inv_mass)
        chunks = []
        for lo in range(0, self.num_samples, sample_chunk):
            n = min(sample_chunk, self.num_samples - lo)
            samp, coll = samp_fn(n)(key_samp, samp,
                                    jnp.asarray(lo, jnp.int32))
            chunks.append([np.asarray(jax.device_get(a)) for a in coll])

        cat = [jnp.asarray(np.concatenate([c[i] for c in chunks]))
               for i in range(5)]
        qs, divs, accs, depths, nsteps = cat
        return self._package(qs, divs, accs, depths, nsteps, step_size,
                             carry.inv_mass)

    def _package(self, qs, divs, accs, depths, nsteps, step_size,
                 inv_mass) -> MCMCResult:
        # qs: (num_samples, chains, dim) -> (chains, num_samples, dim)
        qs = jnp.swapaxes(qs, 0, 1)
        flat = qs.reshape(-1, self.dim)
        cons = jax.vmap(self._constrain)(flat)
        samples = {
            name: v.reshape(qs.shape[:2] + v.shape[1:])
            for name, v in cons.items()
        }
        extra = {
            "diverging": jnp.swapaxes(divs, 0, 1),
            "accept_prob": jnp.swapaxes(accs, 0, 1),
            "tree_depth": jnp.swapaxes(depths, 0, 1),
            "num_steps": jnp.swapaxes(nsteps, 0, 1),
            "step_size": step_size,
            "inv_mass": inv_mass,
        }
        return MCMCResult(samples, extra, qs)

    # ------------------------------------------------------------------
    @staticmethod
    def summary(result: MCMCResult):
        return diag.summary(result.samples)
