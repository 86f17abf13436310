"""Example 6 — Gaussian-process regression (beyond the BASELINE five).

Demonstrates the Gaussian-prior-field workflow the round-2 backends
enable: the latent function rides a WHITENED parameterization
(f = L z, z ~ N(0, I), L = chol(K)) — exactly what
`infer.mcmc.EllipticalSlice` requires and what NUTS mixes best on — and
with Gaussian observation noise the posterior is analytic, giving the
SURVEY.md C24-style oracle for both samplers and the marginal-likelihood
path (`dist.MultivariateNormal` + `map_estimate` for hyperparameters).

Shape notes: the kernel matrix is one (n, n) pairwise op + Cholesky at
trace time (matmul/linalg); every ESS/NUTS step is then a single (n, n) x
(n,) matvec — no per-element work.

Run: ``python -m bayesic_tpu.models.gp --smoke true``
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
    n: int = 256
    noise: float = 0.2
    lengthscale: float = 0.4
    amplitude: float = 1.0
    seed: int = 0
    num_samples: int = 800
    num_burnin: int = 200
    num_chains: int = 8
    smoke: bool = False


def rbf(x1, x2, lengthscale, amplitude):
    d2 = (x1[:, None] - x2[None, :]) ** 2
    return amplitude**2 * jnp.exp(-0.5 * d2 / lengthscale**2)


def make_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    x = np.sort(rng.uniform(-2, 2, cfg.n)).astype(np.float32)
    f = np.sin(3 * x) * np.exp(-0.3 * np.abs(x))
    y = (f + rng.normal(0, cfg.noise, cfg.n)).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(y), jnp.asarray(f)


def chol_K(x, cfg: Config, jitter=1e-6):
    k = rbf(x, x, cfg.lengthscale, cfg.amplitude)
    return jnp.linalg.cholesky(k + jitter * jnp.eye(x.shape[0]))


def make_model(x, y, cfg: Config):
    """Whitened GP: z ~ N(0, I); f = L z; y ~ N(f, noise)."""
    chol = chol_K(x, cfg)

    def model():
        z = sample("z", dist.Normal(0.0, 1.0).expand((x.shape[0],))
                   .to_event(1))
        f = chol @ z
        sample("obs", dist.Normal(f, cfg.noise).to_event(1), obs=y)

    return model, chol


def analytic_posterior(x, y, cfg: Config):
    """Exact GP posterior mean/cov over f at the training inputs."""
    k = np.asarray(rbf(x, x, cfg.lengthscale, cfg.amplitude))
    a = k + cfg.noise**2 * np.eye(x.shape[0])
    kinv_y = np.linalg.solve(a, np.asarray(y))
    mean = k @ kinv_y
    cov = k - k @ np.linalg.solve(a, k)
    return mean, cov


def log_marginal(x, y, lengthscale, amplitude, noise):
    """Exact log marginal likelihood via dist.MultivariateNormal."""
    k = rbf(x, x, lengthscale, amplitude)
    cov = k + noise**2 * jnp.eye(x.shape[0])
    return dist.MultivariateNormal(
        jnp.zeros(x.shape[0]),
        scale_tril=jnp.linalg.cholesky(cov)).log_prob(y)


def run(cfg: Config, key=None, sampler="ess"):
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, n=64, num_samples=200,
                                  num_burnin=100, num_chains=2)
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    x, y, f_true = make_data(cfg)
    model, chol = make_model(x, y, cfg)

    if sampler == "ess":
        from ..infer.mcmc.ess import EllipticalSlice

        res = EllipticalSlice(
            model, num_samples=cfg.num_samples, num_burnin=cfg.num_burnin,
            num_chains=cfg.num_chains).run(key)
    else:
        from ..infer.mcmc import MCMC

        res = MCMC(model=model, num_warmup=cfg.num_burnin,
                   num_samples=cfg.num_samples,
                   num_chains=cfg.num_chains).run(key)

    z = np.asarray(res.samples["z"]).reshape(-1, cfg.n)
    f_draws = z @ np.asarray(chol).T
    mean_ref, cov_ref = analytic_posterior(x, y, cfg)
    return {
        "x": np.asarray(x), "y": np.asarray(y),
        "f_mean": f_draws.mean(0), "f_std": f_draws.std(0),
        "analytic_mean": mean_ref,
        "analytic_std": np.sqrt(np.diag(cov_ref)),
        "max_mean_err": float(np.abs(f_draws.mean(0) - mean_ref).max()),
        "rmse_truth": float(np.sqrt(np.mean(
            (f_draws.mean(0) - np.asarray(f_true)) ** 2))),
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    dump_config(cfg)
    out = run(cfg)
    print({k: out[k] for k in ("max_mean_err", "rmse_truth")})
    return out


if __name__ == "__main__":
    main()
