"""The precision pin for energies.

Potentials feed Metropolis-Hastings ratios, NUTS multinomial weights and
SMC log-weights and log-evidence.  On a GPU a float32 matrix product may run
in TF32 (about three decimal digits), and noise of that size on an energy
changes which proposals are accepted: the sampler then no longer targets
the posterior.  So each sampler's programs (init, transition or stage
chunk) are traced whole under ``jax.default_matmul_precision("highest")``:
the potential, its gradient and every other product an acceptance
decision reads, such as a dense metric's kinetic energy.  SVI, Pathfinder
and Laplace keep XLA's default: their gradients only steer an optimizer.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["exact"]


def exact(fn):
    """``fn`` traced with every matrix product at HIGHEST precision."""

    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return pinned
