"""Example 1 — Bayesian linear regression, mean-field SVI, full batch.

Blueprint: SURVEY.md C16 (BASELINE.json configs[0]: "Bayesian linear
regression, mean-field Gaussian guide, full-batch SVI (CPU-runnable PR1
ref)").  Known noise, so the posterior over (w, b) is an analytic Gaussian —
the correctness oracle (SURVEY.md C24).

Run: ``python -m bayesic_tpu.models.linreg --smoke true``
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import dist
from ..core import sample
from ..infer.svi import SVI, FullRankGuide, MeanFieldGuide
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps


@dataclasses.dataclass(frozen=True)
class Config:
    n: int = 4096
    dim: int = 16
    noise: float = 0.5
    seed: int = 0
    steps: int = 2000
    lr: float = 0.05
    guide: str = "meanfield"       # meanfield | fullrank
    smoke: bool = False
    bench: bool = False


def make_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    x = rng.normal(0, 1, (cfg.n, cfg.dim)).astype(np.float32)
    w_true = rng.normal(0, 1, cfg.dim).astype(np.float32)
    b_true = np.float32(rng.normal(0, 1))
    y = (x @ w_true + b_true
         + rng.normal(0, cfg.noise, cfg.n)).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(y), w_true, b_true


def model(x, y, noise):
    w = sample("w", dist.Normal(0.0, 1.0).expand((x.shape[1],)).to_event(1))
    b = sample("b", dist.Normal(0.0, 1.0))
    sample("obs", dist.Normal(x @ w + b, noise).to_event(1), obs=y)


def analytic_posterior(x, y, noise, prior_var=1.0):
    """Exact Gaussian posterior over (w, b) with known noise."""
    xn = np.asarray(x)
    phi = np.concatenate([xn, np.ones((xn.shape[0], 1), xn.dtype)], 1)
    prec = phi.T @ phi / noise**2 + np.eye(phi.shape[1]) / prior_var
    cov = np.linalg.inv(prec)
    mean = cov @ (phi.T @ np.asarray(y)) / noise**2
    return mean, cov


def run(cfg: Config, key=None):
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, n=256, dim=4, steps=300)
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    x, y, w_true, b_true = make_data(cfg)
    guide_cls = {"meanfield": MeanFieldGuide, "fullrank": FullRankGuide}[
        cfg.guide
    ]
    svi = SVI(model, guide_cls,
              optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.steps)),
              model_args=(x, y, cfg.noise))

    if cfg.bench:
        state = svi.init(key)
        res, dt = timed_steps(
            lambda s: svi.run(key, cfg.steps, state=s),
            state, warmup_runs=1, timed_runs=1,
        )
        rate = cfg.steps / dt
        bench_line("elbo_steps_per_s", rate, "steps/s",
                   model="linreg", n=cfg.n, dim=cfg.dim)
    else:
        res = svi.run(key, cfg.steps)

    mean_u, std_u = svi.guide.stats(res.params)
    mean_ref, cov_ref = analytic_posterior(x, y, cfg.noise)
    got = np.concatenate([np.asarray(mean_u["w"]).ravel(),
                          [float(mean_u["b"])]])
    err = float(np.abs(got - mean_ref).max())
    return {
        "posterior_mean": got,
        "analytic_mean": mean_ref,
        "analytic_cov": cov_ref,
        "max_abs_err": err,
        "final_elbo": -float(res.losses[-1]),
        "losses": np.asarray(res.losses),
        "svi": svi,
        "result": res,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"max |posterior mean - analytic| = {out['max_abs_err']:.4f}")
    print(f"final ELBO = {out['final_elbo']:.2f}")


if __name__ == "__main__":
    main()

