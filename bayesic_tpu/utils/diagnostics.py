"""Posterior diagnostics: ESS, split-R-hat, MCSE, summaries.

Blueprint: SURVEY.md C21 — "posterior mean/std, MC standard error, ESS
(autocorrelation-based), split-R̂, divergence counts" (metric "effective
samples/s"; acceptance "within 2 MC-standard-errors", BASELINE.json).

Implementation notes (accelerator-friendly): autocovariances via FFT (one batched
rfft per parameter block), Geyer's initial-monotone-positive-sequence
truncation done with masked cumulative ops (no data-dependent control flow),
so the whole diagnostic stack is jit-able and runs on device over sharded
chains (cross-chain stats ride an all_gather when sharded, SURVEY.md §3.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["autocovariance", "ess", "split_rhat", "mcse", "summary"]


def autocovariance(x, axis=-1):
    """Biased autocovariance along ``axis`` via FFT, normalized by n."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    x = x - jnp.mean(x, -1, keepdims=True)
    # zero-pad to >= 2n for linear (non-circular) correlation
    m = 1 << (2 * n - 1).bit_length()
    f = jnp.fft.rfft(x, m, -1)
    acov = jnp.fft.irfft(f * jnp.conj(f), m, -1)[..., :n] / n
    return jnp.moveaxis(acov, -1, axis)


def ess(x):
    """Effective sample size of ``x`` shaped (n_chains, n_samples, ...)
    using Stan's multi-chain rho_hat with Geyer initial-monotone-positive
    truncation.  Returns ESS with shape ``x.shape[2:]``.

    ESS CAN EXCEED the draw count: an antithetic sampler (NUTS chains
    routinely are — multinomial trajectory sampling induces negative
    lag-1 autocorrelation) has integrated autocorrelation time tau < 1,
    and this estimator (like Stan's) reports it faithfully, flooring tau
    at 1/log10(n) rather than 1.  Validated against the analytic AR(1)
    oracle tau = (1+rho)/(1-rho) for rho < 0 in
    tests/test_diagnostics_ess.py.  Benchmark records additionally carry
    a ``min_ess_capped`` companion (clipped at the draw count) so rate
    comparisons can't be flattered by estimator behavior."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[None]
    m, n = x.shape[0], x.shape[1]
    acov = autocovariance(x, axis=1)              # (m, n, ...)
    mean_acov = jnp.mean(acov, 0)                 # (n, ...)
    chain_var = acov[:, 0] * n / (n - 1.0)        # (m, ...)
    w = jnp.mean(chain_var, 0)
    mean_per_chain = jnp.mean(x, 1)               # (m, ...)
    var_plus = mean_acov[0] * n / (n - 1.0)
    if m > 1:
        b_over_n = jnp.var(mean_per_chain, 0, ddof=1)
        var_plus = w * (n - 1.0) / n + b_over_n
    rho = 1.0 - (w - mean_acov) / var_plus        # (n, ...)
    rho = rho.at[0].set(1.0)

    # Geyer pairs P_t = rho_{2t} + rho_{2t+1}
    n_pairs = n // 2
    p = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]   # (n_pairs, ...)
    # initial positive sequence: keep while all pairs so far > 0
    positive = jnp.cumprod(jnp.where(p > 0, 1.0, 0.0), 0)
    # monotone decreasing envelope
    p_mono = jax.lax.associative_scan(jnp.minimum, jnp.where(positive > 0, p,
                                                             jnp.inf), axis=0)
    p_used = jnp.where(positive > 0, jnp.minimum(p, p_mono), 0.0)
    tau = -1.0 + 2.0 * jnp.sum(p_used, 0)
    tau = jnp.maximum(tau, 1.0 / jnp.log10(jnp.asarray(n, rho.dtype) + 1.0))
    return m * n / tau


def split_rhat(x):
    """Split-R̂ (potential scale reduction) of ``x`` shaped
    (n_chains, n_samples, ...). Values near 1 indicate convergence."""
    x = jnp.asarray(x)
    m, n = x.shape[0], x.shape[1]
    half = n // 2
    halves = jnp.concatenate([x[:, :half], x[:, half:2 * half]], 0)
    mm, nn = 2 * m, half
    mean_c = jnp.mean(halves, 1)
    var_c = jnp.var(halves, 1, ddof=1)
    w = jnp.mean(var_c, 0)
    b = nn * jnp.var(mean_c, 0, ddof=1)
    var_plus = (nn - 1.0) / nn * w + b / nn
    return jnp.sqrt(var_plus / w)


def mcse(x):
    """Monte-Carlo standard error of the posterior mean."""
    x = jnp.asarray(x)
    sd = jnp.std(x, axis=(0, 1), ddof=1)
    return sd / jnp.sqrt(ess(x))


def summary(samples_dict):
    """Per-site posterior summary: mean, std, mcse, ess, split_rhat.
    Input arrays are shaped (n_chains, n_samples, *event)."""
    out = {}
    for name, x in samples_dict.items():
        x = jnp.asarray(x)
        out[name] = {
            "mean": jnp.mean(x, (0, 1)),
            "std": jnp.std(x, (0, 1), ddof=1),
            "mcse": mcse(x),
            "ess": ess(x),
            "rhat": split_rhat(x),
        }
    return out


def print_summary(samples_dict, file=None):
    """Readable per-site posterior table (mean, std, mcse, ess, r-hat)."""
    import sys

    out = file or sys.stdout
    stats = summary(samples_dict)
    header = f"{'site':<16}{'mean':>10}{'std':>10}{'mcse':>10}" \
             f"{'ess':>9}{'rhat':>7}"
    print(header, file=out)
    print("-" * len(header), file=out)
    for name, st in stats.items():
        mean = jnp.atleast_1d(st["mean"]).ravel()
        std = jnp.atleast_1d(st["std"]).ravel()
        mcse_v = jnp.atleast_1d(st["mcse"]).ravel()
        essv = jnp.atleast_1d(st["ess"]).ravel()
        rh = jnp.atleast_1d(st["rhat"]).ravel()
        for i in range(mean.shape[0]):
            label = name if mean.shape[0] == 1 else f"{name}[{i}]"
            print(f"{label:<16}{float(mean[i]):>10.3f}"
                  f"{float(std[i]):>10.3f}{float(mcse_v[i]):>10.4f}"
                  f"{float(essv[i]):>9.0f}{float(rh[i]):>7.3f}", file=out)
    return stats
