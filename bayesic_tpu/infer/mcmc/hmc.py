"""Static-trajectory HMC kernel (SURVEY.md C8).

Used directly (``kernel="hmc"``), and as the mutation move inside SMC
(SURVEY.md C9) where a fixed, small number of leapfrog steps per particle is
the accelerator-friendly choice (uniform work across the particle
batch).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .integrators import IntegratorState, make_leapfrog
from .metrics import kinetic_energy, sample_momentum

__all__ = ["HMCInfo", "make_hmc_kernel"]


class HMCInfo(NamedTuple):
    accept_prob: jax.Array
    diverging: jax.Array
    num_steps: jax.Array
    energy: jax.Array
    is_accepted: jax.Array


def make_hmc_kernel(potential_and_grad, num_steps=32,
                    divergence_threshold=1000.0):
    """Returns ``step(key, state, step_size, inv_mass) -> (state, info)``."""

    leapfrog = make_leapfrog(potential_and_grad)

    def step(key, state: IntegratorState, step_size, inv_mass):
        key_mom, key_acc = jax.random.split(key)
        p0 = sample_momentum(key_mom, inv_mass, state.q)
        h0 = state.pe + kinetic_energy(inv_mass, p0)
        start = IntegratorState(state.q, p0, state.pe, state.grad)

        def body(_, s):
            return leapfrog(s, step_size, inv_mass)

        end = lax.fori_loop(0, num_steps, body, start)
        h1 = end.pe + kinetic_energy(inv_mass, end.p)
        delta = h1 - h0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > divergence_threshold
        accept_prob = jnp.minimum(1.0, jnp.exp(-delta))
        accept = jax.random.uniform(key_acc) < accept_prob
        new_state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), end, start
        )
        new_state = IntegratorState(
            new_state.q, jnp.zeros_like(p0), new_state.pe, new_state.grad
        )
        info = HMCInfo(
            accept_prob, diverging,
            jnp.asarray(num_steps, jnp.int32), h0, accept,
        )
        return new_state, info

    return step
