"""Adaptive tempered SMC with systematic resampling and HMC mutation.

Blueprint: SURVEY.md C9 + §3.3 call stack (BASELINE.json north_star: "SMC
... sharded particles ... systematic resampling driven by cross-host
collectives"; configs[3] GMM-via-SMC).

Algorithm (one jit-compiled ``while_loop`` over tempering stages):

1. adapt Δβ by bisection so the *conditional* ESS (Zhou–Johansen–Aston;
   incremental-weight degradation against the carried weights) hits
   ``ess_target·N`` (fixed 26-iteration bisection — no dynamic control
   flow);
2. reweight  log w += Δβ · loglik(particle);
3. resample (systematic, shared stratified offset) when ESS < threshold —
   computed unconditionally and selected by ``where`` so the collective
   pattern is identical on every shard (SURVEY.md §5 collective-symmetry
   rule);
4. mutate with K HMC steps targeting p_β ∝ prior · lik^β, with
   acceptance-driven step-size adaptation.

Particles are a flat (N, dim) array in unconstrained space; shard the leading
axis over the mesh's ``particle`` axis and jit — XLA inserts the psum/gather
collectives (C13b).  Log-evidence is accumulated per stage
(logΣ W_i·lik_i^Δβ), giving the marginal-likelihood estimate tested against
conjugate models (SURVEY.md §4.3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

from ...core.logjoint import build_logjoint, init_to_prior
from ...core.precision import exact
from ...parallel.resample import (
    effective_sample_size,
    normalize_log_weights,
    systematic_ancestors,
)
from ..svi.guides import unraveler

__all__ = ["SMC", "SMCResult"]


class SMCResult(NamedTuple):
    particles: dict          # constrained, (N, *event)
    log_weights: jax.Array   # final normalized log weights (N,)
    log_evidence: jax.Array  # marginal likelihood estimate
    num_stages: jax.Array
    accept_rate: jax.Array   # final-stage mutation acceptance
    unconstrained: jax.Array  # (N, dim)


class _SMCCarry(NamedTuple):
    q: jax.Array             # (N, dim)
    log_w: jax.Array         # (N,) unnormalized within stage
    beta: jax.Array
    log_evidence: jax.Array
    stage: jax.Array
    step_size: jax.Array
    accept: jax.Array


class SMC:
    """See module docstring. After ``run``, use :meth:`equal_weight_samples`
    for plain posterior draws."""

    @staticmethod
    def equal_weight_samples(result: "SMCResult", key, num_samples=None):
        """Resample the final weighted particle population down to
        equally-weighted posterior draws (systematic, low variance)."""
        from ...parallel.resample import systematic_ancestors

        idx = systematic_ancestors(key, result.log_weights, num_samples)
        return jax.tree_util.tree_map(
            lambda a: jnp.take(a, idx, axis=0), result.particles
        )

    def __init__(self, model, num_particles=1024, ess_target=0.5,
                 resample_threshold=0.5, mutation_steps=5,
                 hmc_leapfrog_steps=5, max_stages=100, init_step_size=0.2,
                 target_accept=0.65, model_args=(), model_kwargs=None,
                 particle_sharding=None, batched_loglik=None,
                 batched_loglik_grad=None, precondition=False,
                 step_adapt="da"):
        self.model = model
        self.n = int(num_particles)
        self.ess_target = float(ess_target)
        self.resample_threshold = float(resample_threshold)
        self.mutation_steps = int(mutation_steps)
        self.leapfrog_steps = int(hmc_leapfrog_steps)
        self.max_stages = int(max_stages)
        self.init_step_size = float(init_step_size)
        self.target_accept = float(target_accept)
        self.particle_sharding = particle_sharding
        # Diagonal mass preconditioning from the weighted particle variance
        # (VERDICT r1: accept-nudged identity-mass mutation is weak on
        # ill-scaled targets).  Off by default: on multimodal targets the
        # cross-mode variance inflates the per-dimension scale.
        self.precondition = bool(precondition)
        # Mutation step-size control (VERDICT r2 item 8):
        #   "da"    — per-stage dual averaging: a fresh DA run inside each
        #             stage's K transitions (shrinkage target mu = the
        #             carried step, not Stan's 10x — we are tracking a
        #             slowly-moving tempered target, not exploring), with
        #             the Polyak average carried to the next stage.  Can
        #             move the step orders of magnitude within one stage.
        #   "nudge" — legacy once-per-stage multiplicative update
        #             exp(0.5*(accept-target)); at most e^{+-0.5} per
        #             stage, so it collapses on targets whose posterior
        #             scale is far from init_step_size (kept for
        #             comparison; tests/test_smc.py demonstrates).
        if step_adapt not in ("da", "nudge"):
            raise ValueError(f"step_adapt must be 'da' or 'nudge', got "
                             f"{step_adapt!r}")
        self.step_adapt = step_adapt
        self._model_args = model_args
        self._model_kwargs = model_kwargs or {}

        self.info, self.logdensity, self._constrain, _ = build_logjoint(
            model, *model_args, **self._model_kwargs
        )
        self.dim, self._unravel, self._ravel = unraveler(self.info)
        parts = self.logdensity.parts

        def logprior_flat(q):
            lp, _ = parts(self._unravel(q))
            return lp

        def loglik_flat(q):
            _, ll = parts(self._unravel(q))
            return ll

        def parts_flat(q):
            # ONE replay for both parts — the default HMC potential below
            # would otherwise trace two full model replays per evaluation
            # (r2 review finding)
            return parts(self._unravel(q))

        self._parts_batched = jax.vmap(parts_flat)
        self._logprior = jax.vmap(logprior_flat)
        # value+grad of the prior for the hand-fused mutation path
        self._logprior_vg = jax.vmap(jax.value_and_grad(logprior_flat))
        if batched_loglik is not None:
            # Hand-fused batched likelihood (e.g. the gmm_loglik kernel,
            # SURVEY.md C14b): qs (P, dim) -> (P,), bypassing
            # vmap-of-replay on the data-heavy term.
            self._loglik = batched_loglik
        else:
            def _ll_only(qs):
                return self._parts_batched(qs)[1]

            _ll_only._is_default = True
            self._loglik = _ll_only
        # Hand-fused value+gradient (SURVEY.md C14a, e.g. gmm_loglik_grad):
        # qs (P, dim) -> ((P,), (P, dim)) — one kernel launch per leapfrog
        # gradient instead of a traced fwd+bwd pair.
        self._loglik_vg = batched_loglik_grad

    # ------------------------------------------------------------------
    def _init_particles(self, key):
        def one(i):
            k = jax.random.fold_in(key, i)
            u = init_to_prior(
                self.model, self.info, *self._model_args,
                rng_key=k, **self._model_kwargs,
            )
            return self._ravel(u)

        q = jax.vmap(one)(jnp.arange(self.n))
        if self.particle_sharding is not None:
            q = jax.device_put(q, self.particle_sharding)
        return q

    def _next_beta(self, beta, loglik, log_w):
        """Bisection: largest Δβ keeping the *conditional* ESS at
        ess_target·N.

        CESS(Δβ) = N · (Σ W_i v_i)² / Σ W_i v_i²  with v_i = lik_i^Δβ and W
        the carried normalized weights (Zhou, Johansen & Aston 2016): it
        measures the incremental weight degradation *relative to the carried
        weights* — so the criterion reflects the real post-reweight weights
        (ADVICE r1: Δβ·loglik alone ignores log_w) without stalling when the
        carried ESS already sits near the target (CESS(0) = N always).
        """
        target = self.ess_target * self.n
        logw_n = normalize_log_weights(log_w)
        log_n = jnp.log(jnp.asarray(float(self.n)))

        def ess_at(delta):
            num = 2.0 * logsumexp(logw_n + delta * loglik)
            den = logsumexp(logw_n + 2.0 * delta * loglik)
            return jnp.exp(log_n + num - den)

        def body(_, bounds):
            lo, hi = bounds
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo0 = jnp.zeros_like(beta)
        hi0 = 1.0 - beta
        # accept full jump if even beta=1 keeps ESS above target
        full_ok = ess_at(hi0) >= target
        lo, hi = lax.fori_loop(0, 26, body, (lo0, hi0))
        delta = jnp.where(full_ok, hi0, lo)
        return jnp.minimum(beta + delta, 1.0)

    def _mutate(self, key, q, beta, step_size, m_inv=None):
        """K HMC transitions targeting p_beta, computed on the whole
        particle batch at once (so hand-fused batched densities — Pallas
        kernels — apply).  ``m_inv`` is the diagonal inverse mass (per-dim
        scale², e.g. the weighted particle variance).  The step size
        adapts ACROSS the K transitions per ``self.step_adapt`` (see
        __init__).  Returns (q, mean accept, next-stage step size)."""
        from ..mcmc.adapt import DualAveragingState, da_update

        if m_inv is None:
            m_inv = jnp.ones((self.dim,), q.dtype)
        sqrt_m = 1.0 / jnp.sqrt(m_inv)

        def pe_and_grad(qs, b):
            if self._loglik_vg is not None:
                # C14a fused path: one kernel launch yields the likelihood
                # value AND gradient; the (cheap, elementwise) prior part
                # comes from vmapped value_and_grad and fuses in XLA.
                lp, glp = self._logprior_vg(qs)
                ll, gll = self._loglik_vg(qs)
                return -(lp + b * ll), -(glp + b * gll)
            if not getattr(self._loglik, "_is_default", False):
                # hand-fused batched likelihood present: keep the split
                pe, vjp = jax.vjp(
                    lambda x: -(self._logprior(x) + b * self._loglik(x)),
                    qs,
                )
            else:
                def neg_tempered(x):
                    lp, ll = self._parts_batched(x)
                    return -(lp + b * ll)

                pe, vjp = jax.vjp(neg_tempered, qs)
            (g,) = vjp(jnp.ones_like(pe))
            return pe, g

        def one_hmc(carry, t):
            qs, acc_sum, da = carry
            step_size = jnp.exp(da.log_step)
            key_t = jax.random.fold_in(key, t)
            k_mom, k_acc = jax.random.split(key_t)
            p0 = jax.random.normal(k_mom, qs.shape, qs.dtype) * sqrt_m
            pe0, g0 = pe_and_grad(qs, beta)
            h0 = pe0 + 0.5 * jnp.sum(p0 * p0 * m_inv, -1)

            def leap(_, s):
                qq, pp, gg, _pe = s
                pp = pp - 0.5 * step_size * gg          # half kick
                qq = qq + step_size * m_inv * pp        # drift
                pe_new, gg = pe_and_grad(qq, beta)
                pp = pp - 0.5 * step_size * gg          # half kick
                return qq, pp, gg, pe_new

            # the last leap iteration already evaluated the potential at
            # qe — carry it instead of a redundant extra evaluation per
            # transition (r2 review finding: ~17% of the mutation's
            # density evaluations at leapfrog_steps=5)
            qe, pe_, _, pe1 = lax.fori_loop(
                0, self.leapfrog_steps, leap, (qs, p0, g0, pe0)
            )
            h1 = pe1 + 0.5 * jnp.sum(pe_ * pe_ * m_inv, -1)
            delta = jnp.where(jnp.isnan(h1 - h0), jnp.inf, h1 - h0)
            a = jnp.minimum(1.0, jnp.exp(-delta))                 # (P,)
            take = jax.random.uniform(k_acc, a.shape) < a
            qs = jnp.where(take[:, None], qe, qs)
            if self.step_adapt == "da":
                da = da_update(da, jnp.mean(a),
                               target=self.target_accept, t0=2.0)
            return (qs, acc_sum + jnp.mean(a), da), None

        log_eps0 = jnp.log(step_size)
        zero = jnp.zeros_like(log_eps0)
        # mu = log(carried step): shrink toward where the last stage
        # settled (tracking, not exploration)
        da0 = DualAveragingState(log_eps0, log_eps0, zero, zero, log_eps0)
        (q_new, acc_sum, da), _ = lax.scan(
            one_hmc, (q, jnp.zeros(()), da0),
            jnp.arange(self.mutation_steps)
        )
        accept = acc_sum / self.mutation_steps
        if self.step_adapt == "da":
            next_step = jnp.exp(da.log_step_avg)
        else:
            next_step = step_size * jnp.exp(
                0.5 * (accept - self.target_accept))
        return q_new, accept, jnp.clip(next_step, 1e-5, 2.0)

    # ------------------------------------------------------------------
    def run(self, key, jit=True, stage_chunk=8) -> SMCResult:
        """Run the tempering loop as CHUNKS of ``stage_chunk`` stages, each
        a fixed-length ``lax.scan`` (finished stages pass through a no-op
        ``lax.cond``), with a host fetch of β between chunks.

        Chunked scans keep one compiled program reused across chunks,
        bound the wasted no-op work to < stage_chunk stages, and cost one
        small host fetch per chunk.  The β predicate is replicated, so
        every process takes the same branch (collective-safe in
        multi-host runs).

        The compiled init/chunk programs are cached on the instance and the
        PRNG keys ride as traced arguments, so repeated ``run`` calls (and
        fresh benchmark keys) never re-trace."""
        key_init, key_loop = jax.random.split(key)
        init, chunk = self._run_programs(jit, int(stage_chunk))

        out = init(key_init)
        while True:
            out = chunk(out, key_loop)
            # one fetch for both loop predicates
            beta, stage = jax.device_get((out.beta, out.stage))
            if float(beta) >= 1.0 or int(stage) >= self.max_stages:
                break

        cons = jax.vmap(lambda q: self._constrain(self._unravel(q)))(out.q)
        return SMCResult(
            cons, normalize_log_weights(out.log_w), out.log_evidence,
            out.stage, out.accept, out.q,
        )

    def _run_programs(self, jit, stage_chunk):
        cache_key = (bool(jit), stage_chunk)
        if not hasattr(self, "_prog_cache"):
            self._prog_cache = {}
        if cache_key in self._prog_cache:
            return self._prog_cache[cache_key]

        def init(key_init):
            q0 = self._init_particles(key_init)
            return _SMCCarry(
                q0, jnp.zeros(self.n), jnp.zeros(()), jnp.zeros(()),
                jnp.zeros((), jnp.int32),
                jnp.asarray(self.init_step_size), jnp.ones(()),
            )

        def body(c: _SMCCarry, key_loop):
            k_stage = jax.random.fold_in(key_loop, c.stage)
            k_res, k_mut = jax.random.split(k_stage)

            ll = self._loglik(c.q)
            new_beta = self._next_beta(c.beta, ll, c.log_w)
            delta = new_beta - c.beta

            # evidence increment: log sum_i W_i lik_i^delta
            logw_norm = normalize_log_weights(c.log_w)
            log_ev_inc = logsumexp(logw_norm + delta * ll)
            log_w = c.log_w + delta * ll

            # systematic resampling, collective-symmetric
            ess = effective_sample_size(log_w)
            do_resample = ess < self.resample_threshold * self.n
            anc = systematic_ancestors(k_res, log_w)
            q_res = jnp.take(c.q, anc, axis=0)
            q = jnp.where(do_resample, q_res, c.q)
            log_w = jnp.where(do_resample, jnp.zeros_like(log_w), log_w)

            # HMC mutation at the new temperature
            if self.precondition:
                w_n = jnp.exp(normalize_log_weights(log_w))   # (N,)
                mean = jnp.sum(w_n[:, None] * q, axis=0)
                var = jnp.sum(w_n[:, None] * jnp.square(q - mean),
                              axis=0)
                m_inv = jnp.clip(var, 1e-8, 1e8)
            else:
                m_inv = None
            q, accept, step_size = self._mutate(k_mut, q, new_beta,
                                                c.step_size, m_inv)

            return _SMCCarry(
                q, log_w, new_beta, c.log_evidence + log_ev_inc,
                c.stage + 1, step_size, accept,
            )

        def chunk(c0, key_loop):
            def step(c, _):
                done = jnp.logical_or(c.beta >= 1.0,
                                      c.stage >= self.max_stages)
                return lax.cond(done, lambda cc: cc,
                                lambda cc: body(cc, key_loop), c), None

            return lax.scan(step, c0, None, length=stage_chunk)[0]

        # every energy (log-weights, log-evidence, MH ratios) is computed
        # inside these two programs: pinned whole (core/precision.py)
        init, chunk = exact(init), exact(chunk)
        if jit:
            init = jax.jit(init)
            chunk = jax.jit(chunk)
        self._prog_cache[cache_key] = (init, chunk)
        return init, chunk
