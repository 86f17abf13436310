"""SVI driver: optimization loop over the ELBO.

Blueprint: SURVEY.md C7 — "optimization loop (optax Adam), lax.scan-based
step fusion, ELBO logging" (metric: ELBO-steps/s/chip).  The entire
``run`` is ONE compiled XLA program: a ``lax.scan`` whose carry holds guide
params + optimizer state + PRNG key; Python re-enters only when the result is
fetched (SURVEY.md §3.1 call stack).

Data parallelism (SURVEY.md C12) happens *above* this module: shard the data
pytree over the mesh's ``data`` axis, keep params replicated, and jit —
XLA inserts the gradient psum automatically.  When auto partitioning makes a
wrong choice, ``parallel.dp.dp_svi_run`` is the explicit shard_map path with
a hand-placed gradient psum; ``grad_transform`` is a hook for custom
gradient post-processing (clipping, quantization, debugging taps).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from ...core.logjoint import build_logjoint, init_to_prior
from .elbo import draw_subsample, make_elbo
from .guides import Guide

__all__ = ["SVIState", "SVIResult", "SVI"]


class SVIState(NamedTuple):
    params: Any
    opt_state: Any
    key: jax.Array
    step: jax.Array


class SVIResult(NamedTuple):
    params: Any
    losses: jax.Array      # negative ELBO per step
    state: SVIState


class SVI:
    def __init__(self, model, guide, optimizer, model_args=(),
                 model_kwargs=None, num_particles=1, stl=True, iwae=False,
                 dreg=False, grad_transform: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.num_particles = num_particles
        model_kwargs = model_kwargs or {}
        self.info, self.logdensity, self.constrain, self.postprocess = \
            build_logjoint(model, *model_args, **model_kwargs)
        if isinstance(guide, Guide):
            self.guide = guide
        else:
            self.guide = guide(self.info)  # class or factory taking info
        self.elbo = make_elbo(
            self.logdensity, self.guide, num_particles=num_particles,
            stl=stl, info=self.info, iwae=iwae, dreg=dreg,
        )
        self.grad_transform = grad_transform
        self.iwae, self.dreg = bool(iwae), bool(dreg)
        self._model_args = model_args
        self._model_kwargs = model_kwargs

    # -- functional stepping ----------------------------------------------
    @property
    def has_model_params(self):
        return bool(self.info.param_names)

    def init(self, key, init_loc_from_prior=False) -> SVIState:
        key, sub = jax.random.split(key)
        if init_loc_from_prior:
            loc = init_to_prior(
                self.model, self.info, *self._model_args,
                rng_key=sub, **self._model_kwargs,
            )
            guide_params = self.guide.init(sub, loc=loc)
        else:
            guide_params = self.guide.init(sub)
        if self.has_model_params:
            params = {"guide": guide_params,
                      "model": dict(self.info.param_init)}
        else:
            params = guide_params
        opt_state = self.optimizer.init(params)
        return SVIState(params, opt_state, key, jnp.zeros((), jnp.int32))

    def _split_params(self, params):
        if self.has_model_params:
            return params["guide"], params["model"]
        return params, None

    def model_params(self, params):
        """Constrained values of the model's learnable `param` sites."""
        _, mp = self._split_params(params)
        if mp is None:
            return {}
        return {
            n: self.info.param_transforms[n].forward(mp[n])
            for n in self.info.param_names
        }

    def guide_params(self, params):
        gp, _ = self._split_params(params)
        return gp

    def step(self, state: SVIState, model_args=None):
        key, key_q, key_b = jax.random.split(state.key, 3)
        subsample = (
            draw_subsample(self.info, key_b)
            if self.info.has_subsample else None
        )

        def loss_fn(params):
            gp, mp = self._split_params(params)
            return -self.elbo(gp, key_q, subsample=subsample,
                              model_args=model_args, model_params=mp)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        return SVIState(params, opt_state, key, state.step + 1), loss

    # -- fused run ---------------------------------------------------------
    def run(self, key, num_steps, jit=True, model_args=None,
            state=None) -> SVIResult:
        """Run ``num_steps`` fused steps.  Pass the (possibly sharded) data
        pytree as ``model_args`` to make it a traced jit input — the
        data-parallel path (SURVEY.md C12): shard it over the mesh's
        ``data`` axis, keep params replicated, and XLA emits the grad psum.
        """
        if state is None:
            state = self.init(key)

        # compiled programs are cached on the instance (keyed by step count)
        # so repeated run() calls never re-trace
        if not hasattr(self, "_run_cache"):
            self._run_cache = {}
        cache_key = (int(num_steps), bool(jit))
        full = self._run_cache.get(cache_key)
        if full is None:
            def full(state, margs):
                def scan_step(carry, _):
                    new_state, loss = self.step(carry, model_args=margs)
                    return new_state, loss

                return jax.lax.scan(scan_step, state, None, length=num_steps)

            if jit:
                full = jax.jit(full)
            self._run_cache[cache_key] = full
        state, losses = full(state, model_args)
        return SVIResult(state.params, losses, state)

    # -- posterior access ---------------------------------------------------
    def posterior_stats(self, params):
        """Unconstrained-space posterior mean/std per latent site."""
        return self.guide.stats(self.guide_params(params))

    def sample_posterior(self, params, key, num_samples=1000):
        uparams, _ = self.guide.sample_and_log_prob(
            self.guide_params(params), key, (num_samples,)
        )
        return jax.vmap(self.constrain)(uparams)
