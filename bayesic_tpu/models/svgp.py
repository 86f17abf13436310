"""Example 8 — sparse variational GP regression (SVGP; beyond the BASELINE
five).

The scalable companion of ``models/gp.py``: instead of an (n, n) Cholesky
per density evaluation, M ≪ n inducing points carry the posterior and the
likelihood streams over mini-batches (Titsias 2009 / Hensman et al. 2013),
written directly in the DSL:

  * whitened inducing latents ``v ~ N(0, I_M)`` (u = L_Z v, the same
    whitening trick as gp.py — mean-field/full-rank guides mix well);
  * per-batch projection ``f = A v`` with ``A = K_xZ L_Z^{-T}`` — one
    (B, M) triangular solve + matvec;
  * the Titsias variance-correction term enters as a ``factor`` site
    inside the subsampled plate, so the plate's N/B scaling makes the
    whole bound an unbiased estimate of the full-data SVGP ELBO.

With Gaussian noise the OPTIMAL q(v) is a closed-form Gaussian
(precision I + AᵀA/σ², mean Λ^{-1} Aᵀ y/σ²), which gives this example an
exact oracle (SURVEY.md C24 style): a FullRankGuide trained by SVI must
recover it — tested in tests/test_svgp.py.

Run: ``python -m bayesic_tpu.models.svgp --smoke true``
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.scipy.linalg import solve_triangular

from .. import dist
from ..core import factor, plate, sample
from ..infer.svi import SVI, FullRankGuide
from ..utils.config import dump_config, parse_config
from .gp import rbf


@dataclasses.dataclass(frozen=True)
class Config:
    n: int = 4096
    num_inducing: int = 32
    batch: int = 512
    noise: float = 0.2
    lengthscale: float = 0.4
    amplitude: float = 1.0
    seed: int = 0
    steps: int = 12000
    lr: float = 0.01
    smoke: bool = False


def make_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    x = np.sort(rng.uniform(-2, 2, cfg.n)).astype(np.float32)
    f = np.sin(3 * x) * np.exp(-0.3 * np.abs(x))
    y = (f + rng.normal(0, cfg.noise, cfg.n)).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(y), jnp.asarray(f)


def inducing_grid(cfg: Config):
    return jnp.linspace(-2.0, 2.0, cfg.num_inducing)


def make_model(x, y, cfg: Config, jitter=1e-6):
    """DSL SVGP: the returned model uses a subsampled plate when
    ``cfg.batch < cfg.n`` and the full data otherwise."""
    z = inducing_grid(cfg)
    kzz = rbf(z, z, cfg.lengthscale, cfg.amplitude)
    lz = jnp.linalg.cholesky(kzz + jitter * jnp.eye(z.shape[0]))
    m = z.shape[0]
    sub = cfg.batch if cfg.batch < cfg.n else None

    def project(xb):
        """A = K_xZ L_Z^{-T}: rows are the whitened predictive weights."""
        kxz = rbf(xb, z, cfg.lengthscale, cfg.amplitude)
        return solve_triangular(lz, kxz.T, lower=True).T

    def model():
        v = sample("v", dist.Normal(0.0, 1.0).expand((m,)).to_event(1))
        with plate("data", cfg.n, subsample_size=sub) as idx:
            xb = x[idx] if sub is not None else x
            yb = y[idx] if sub is not None else y
            a = project(xb)
            f = a @ v
            # Titsias correction: the marginalized GP remainder
            # diag(K_xx - A A^T) enters the Gaussian likelihood bound as
            # -0.5 r / sigma^2 per point (plate scaling keeps it unbiased
            # under subsampling)
            r = jnp.maximum(cfg.amplitude**2 - jnp.sum(a * a, -1), 0.0)
            factor("titsias", -0.5 * r / cfg.noise**2)
            sample("obs", dist.Normal(f, cfg.noise), obs=yb)

    return model, project, lz


def optimal_q(x, y, cfg: Config, project):
    """Closed-form optimal whitened q(v) = N(mu, Sigma) for Gaussian
    noise: precision = I + A^T A / sigma^2, mean = Sigma A^T y / sigma^2."""
    a = np.asarray(project(x))
    lam = np.eye(a.shape[1]) + a.T @ a / cfg.noise**2
    sigma = np.linalg.inv(lam)
    mu = sigma @ (a.T @ np.asarray(y)) / cfg.noise**2
    return mu, sigma


def predict(v_mean, v_cov, project, x_new, cfg: Config):
    """Predictive mean/variance of f at new inputs given q(v)."""
    a = np.asarray(project(jnp.asarray(x_new)))
    mean = a @ v_mean
    var = np.maximum(
        cfg.amplitude**2 - np.sum(a * a, -1), 0.0
    ) + np.einsum("ij,jk,ik->i", a, v_cov, a)
    return mean, var


def run_svi(cfg: Config, key=None):
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    x, y, f_true = make_data(cfg)
    model, project, _ = make_model(x, y, cfg)
    svi = SVI(model, FullRankGuide,
              optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.steps)))
    res = svi.run(key, cfg.steps)
    mean_u, _ = svi.guide.stats(res.params)
    v_mean = np.asarray(mean_u["v"])
    v_cov = np.asarray(svi.guide.covariance(res.params))
    f_mean, f_var = predict(v_mean, v_cov, project, x, cfg)
    return {
        "losses": res.losses,
        "v_mean": v_mean, "v_cov": v_cov,
        "f_mean": f_mean, "f_var": f_var,
        "rmse_truth": float(np.sqrt(np.mean(
            (f_mean - np.asarray(f_true)) ** 2))),
        "project": project, "x": x, "y": y,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, n=512, steps=400, batch=128)
    dump_config(cfg)
    out = run_svi(cfg)
    print({"rmse_truth": out["rmse_truth"],
           "final_loss": float(out["losses"][-1])})
    return out


if __name__ == "__main__":
    main()
