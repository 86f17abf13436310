"""Simulation-based calibration (Talts et al. 2018).

Blueprint: SURVEY.md C24 periphery — the self-validation tool for any
sampler in the library: draw (theta, y) ~ p(theta) p(y | theta), run the
sampler on y, and record the rank of theta among the posterior draws.  A
correct sampler yields uniform ranks for EVERY marginal; systematic
deviations localize bias (U-shape = overdispersed posterior, hump =
underdispersed, skew = shifted).

Compiled shape: the replications are embarrassingly parallel — the
caller's ``run_fn`` is invoked per replication with a folded key (vmap is
usually impossible because samplers carry their own jit'd programs; the
loop re-uses ONE cached compiled program across replications, so the cost
is sampler-run wall time, not compile time).

Usage::

    def run_fn(key, data):            # -> dict site -> (draws, *event)
        r = MCMC(model=model_fn(data), ...).run(key)
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in r.samples...}

    res = sbc(prior_predictive_fn, run_fn, num_sims=200, key=key)
    res.ranks      # site -> (num_sims, *event) integer ranks in [0, L]
    res.pvalues    # site -> chi-squared uniformity p-value per coordinate
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sbc", "SBCResult"]


class SBCResult(NamedTuple):
    ranks: dict       # site -> (num_sims, *event) ranks in [0, num_bins-1]
    num_bins: int
    pvalues: dict     # site -> per-coordinate chi^2 uniformity p-value

    def min_pvalue(self):
        return min(float(np.min(v)) for v in self.pvalues.values())


def _chi2_sf(x, df):
    """Survival function of chi^2 via the regularized upper gamma."""
    from scipy.stats import chi2
    return float(chi2.sf(x, df))


def sbc(prior_fn: Callable, run_fn: Callable, *, num_sims=100,
        num_bins=20, thin=1, key=None) -> SBCResult:
    """``prior_fn(key) -> (theta: dict, data)`` draws one joint prior
    sample; ``run_fn(key, data) -> dict site -> (L, *event)`` runs the
    sampler under test and returns (optionally thinned — ranks need
    near-independent draws) posterior draws for the same sites as theta.

    Ranks are binned to ``num_bins`` (draw count L+1 must be divisible is
    NOT required; binning uses floor(rank * num_bins / (L+1)))."""
    key = key if key is not None else jax.random.PRNGKey(0)
    all_ranks = {}
    L = None
    for s in range(int(num_sims)):
        k_prior, k_run = jax.random.split(jax.random.fold_in(key, s))
        theta, data = prior_fn(k_prior)
        draws = run_fn(k_run, data)
        for name, true_val in theta.items():
            d = np.asarray(draws[name])[::thin]
            if L is None:
                L = d.shape[0]
            rank = (d < np.asarray(true_val)[None]).sum(axis=0)
            all_ranks.setdefault(name, []).append(rank)
    ranks = {n: np.stack(v) for n, v in all_ranks.items()}

    binned = {n: np.floor(r * num_bins / (L + 1)).astype(int)
              for n, r in ranks.items()}
    # floor binning gives UNEQUAL bin widths when (L+1) % num_bins != 0;
    # the chi-squared expectation must use each bin's true width or a
    # perfectly calibrated sampler fails the test (r2 review finding)
    widths = np.bincount(
        np.floor(np.arange(L + 1) * num_bins / (L + 1)).astype(int),
        minlength=num_bins)
    expected = num_sims * widths / (L + 1)
    used = expected > 0
    pvalues = {}
    for n, b in binned.items():
        flat = b.reshape(num_sims, -1)
        pv = []
        for c in range(flat.shape[1]):
            counts = np.bincount(flat[:, c], minlength=num_bins)
            stat = float(((counts[used] - expected[used]) ** 2
                          / expected[used]).sum())
            pv.append(_chi2_sf(stat, int(used.sum()) - 1))
        pvalues[n] = np.asarray(pv).reshape(b.shape[1:] or (1,))
    return SBCResult(ranks, num_bins, pvalues)
