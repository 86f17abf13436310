"""Example 7 — Bayesian structural time series (beyond the BASELINE five).

Demonstrates the `dist.LinearGaussianStateSpace` workflow: a local-linear
trend plus dummy seasonality is assembled as a state-space model, the
Gaussian state path is marginalised EXACTLY inside `log_prob` (Kalman
prediction-error decomposition), and NUTS runs over just the four
variance hyperparameters — the T·(2+S−1)-dimensional latent path never
enters the inference state. Afterwards `smooth()` decomposes the series
into trend/seasonal components and `forecast()` propagates the filtered
terminal state h steps ahead with exact Gaussian intervals.

Shape notes: `log_prob` uses the temporally parallel Kalman filter
(`lgss.py` — log₂(T) rounds of batched matmuls via
`lax.associative_scan`), so each NUTS leapfrog step on a T=512 series is
~9 parallel rounds instead of a 512-long serial dependency chain.

Run: ``python -m bayesic_tpu.models.sts --smoke true``
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import dist
from ..core import sample
from ..utils.config import dump_config, parse_config


@dataclasses.dataclass(frozen=True)
class Config:
    t_len: int = 256
    season: int = 7
    sigma_level: float = 0.15
    sigma_slope: float = 0.02
    sigma_seas: float = 0.08
    sigma_obs: float = 0.3
    seed: int = 0
    num_samples: int = 400
    num_warmup: int = 400
    num_chains: int = 4
    horizon: int = 28
    smoke: bool = False


def _system_matrices(season):
    """F, H for local-linear trend + (season-1)-dim dummy seasonal block.

    State z = [level, slope, s_0, s_1, ..., s_{S-2}] where s_0 is the
    current seasonal effect and the block rotates each step with
    s_new = -(s_0 + ... + s_{S-2}) + noise.
    """
    s = season - 1
    d = 2 + s
    f = np.zeros((d, d))
    f[0, 0] = f[0, 1] = f[1, 1] = 1.0          # level += slope; slope AR(1)=1
    f[2, 2:] = -1.0                            # new seasonal = -sum(previous)
    for i in range(1, s):
        f[2 + i, 2 + i - 1] = 1.0              # shift the seasonal history
    h = np.zeros((1, d))
    h[0, 0] = 1.0                              # observe level
    h[0, 2] = 1.0                              # + current seasonal
    return f, h


def make_lgss(cfg: Config, sigma_level, sigma_slope, sigma_seas,
              sigma_obs):
    f_np, h_np = _system_matrices(cfg.season)
    d = f_np.shape[0]
    q = jnp.zeros((d, d))
    q = q.at[0, 0].set(sigma_level**2)
    q = q.at[1, 1].set(sigma_slope**2)
    q = q.at[2, 2].set(sigma_seas**2)
    # tiny diffuse-ish floor keeps Q and the smoother Cholesky full rank
    q = q + 1e-8 * jnp.eye(d)
    p0 = jnp.diag(jnp.asarray([1.0, 0.1] + [0.5] * (d - 2)))
    return dist.LinearGaussianStateSpace(
        jnp.zeros(d), p0, jnp.asarray(f_np), q, jnp.asarray(h_np),
        jnp.asarray([[sigma_obs**2]]), cfg.t_len)


def make_data(cfg: Config):
    lg = make_lgss(cfg, cfg.sigma_level, cfg.sigma_slope, cfg.sigma_seas,
                   cfg.sigma_obs)
    key = jax.random.PRNGKey(cfg.seed)
    return lg.sample(key)                      # (T, 1)


def make_model(x, cfg: Config):
    def model():
        sl = sample("sigma_level", dist.HalfNormal(0.5))
        ss = sample("sigma_slope", dist.HalfNormal(0.1))
        se = sample("sigma_seas", dist.HalfNormal(0.5))
        so = sample("sigma_obs", dist.HalfNormal(1.0))
        sample("x", make_lgss(cfg, sl, ss, se, so), obs=x)

    return model


def decompose(x, cfg: Config, sigma_level, sigma_slope, sigma_seas,
              sigma_obs):
    """Smoothed trend/seasonal components and their marginal stds."""
    lg = make_lgss(cfg, sigma_level, sigma_slope, sigma_seas, sigma_obs)
    sm, sp = lg.smooth(x)
    return {
        "trend": sm[:, 0], "trend_std": jnp.sqrt(sp[:, 0, 0]),
        "seasonal": sm[:, 2], "seasonal_std": jnp.sqrt(sp[:, 2, 2]),
        "slope": sm[:, 1],
    }


def forecast(x, cfg: Config, sigma_level, sigma_slope, sigma_seas,
             sigma_obs, horizon=None):
    """Exact h-step-ahead Gaussian predictive from the filtered terminal
    state: mean (h,) and std (h,) of future observations."""
    horizon = cfg.horizon if horizon is None else horizon
    lg = make_lgss(cfg, sigma_level, sigma_slope, sigma_seas, sigma_obs)
    ms, ps = lg.filter(x)
    f, q = lg.transition_matrix, lg.transition_cov
    h, r = lg.observation_matrix, lg.observation_cov

    def step(carry, _):
        m, p = carry
        m = f @ m
        p = f @ p @ f.T + q
        return (m, p), (h @ m, h @ p @ h.T + r)

    _, (mx, vx) = jax.lax.scan(step, (ms[-1], ps[-1]),
                               jnp.arange(horizon))
    return mx[:, 0], jnp.sqrt(vx[:, 0, 0])


def run(cfg: Config, key=None):
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, t_len=96, num_samples=150,
                                  num_warmup=150, num_chains=2,
                                  horizon=14)
    key = key if key is not None else jax.random.PRNGKey(cfg.seed + 1)
    x = make_data(cfg)

    from ..infer.mcmc import MCMC

    res = MCMC(model=make_model(x, cfg), num_warmup=cfg.num_warmup,
               num_samples=cfg.num_samples,
               num_chains=cfg.num_chains).run(key)
    post = {k: float(np.asarray(v).mean()) for k, v in res.samples.items()}
    comp = decompose(x, cfg, post["sigma_level"], post["sigma_slope"],
                     post["sigma_seas"], post["sigma_obs"])
    mx, sx = forecast(x, cfg, post["sigma_level"], post["sigma_slope"],
                      post["sigma_seas"], post["sigma_obs"])
    return {
        "x": np.asarray(x)[:, 0],
        "posterior_means": post,
        "true": {"sigma_level": cfg.sigma_level,
                 "sigma_slope": cfg.sigma_slope,
                 "sigma_seas": cfg.sigma_seas,
                 "sigma_obs": cfg.sigma_obs},
        "samples": res.samples,
        "trend": np.asarray(comp["trend"]),
        "seasonal": np.asarray(comp["seasonal"]),
        "forecast_mean": np.asarray(mx),
        "forecast_std": np.asarray(sx),
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    dump_config(cfg)
    out = run(cfg)
    print({"posterior_means": out["posterior_means"],
           "true": out["true"]})
    return out


if __name__ == "__main__":
    main()
