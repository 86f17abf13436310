"""Example 3 — Bayesian matrix factorization, ~1M ratings, sharded
mini-batch ELBO.

Blueprint: SURVEY.md C18 (BASELINE.json configs[2]: "Bayesian matrix
factorization / latent-factor model, ~1M ratings, sharded mini-batch ELBO").

Latents: user/item factor matrices (TP-shardable over the ``model`` axis,
SURVEY.md C13c), user/item biases, global mean.  Likelihood terms are gathers
+ a batched dot — the hot op the Pallas ``mf_logprob`` kernel (C14b)
accelerates.  Mini-batch indices ride the plate subsampling machinery; the
rating arrays can be sharded over the ``data`` axis (C13d).

Run: ``python -m bayesic_tpu.models.matrix_fact --smoke true``
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import dist
from ..core import plate, sample
from ..infer.svi import SVI, MeanFieldGuide
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps


@dataclasses.dataclass(frozen=True)
class Config:
    num_users: int = 3000
    num_items: int = 1500
    num_factors: int = 16
    num_ratings: int = 1_000_000
    noise: float = 0.5
    seed: int = 0
    steps: int = 2000
    batch_size: int = 8192
    lr: float = 0.02
    smoke: bool = False
    bench: bool = False
    data_file: str = ""   # load ratings via the native mmap loader
                          # (bayesic_tpu.io); generated+written if missing


def make_data(cfg: Config):
    if cfg.data_file:
        return _data_from_file(cfg)
    return _synthetic_data(cfg)


def _data_from_file(cfg: Config):
    """Native-loader path (SURVEY.md C18 "sharded mini-batch ELBO" +
    native-runtime tier): mmap'd columnar file, host-shard reads."""
    import os

    from ..io import RatingsDataset, write_ratings

    if not os.path.exists(cfg.data_file):
        users, items, r, truth = _synthetic_data(cfg)
        write_ratings(cfg.data_file, np.asarray(users), np.asarray(items),
                      np.asarray(r))
    with RatingsDataset(cfg.data_file) as ds:
        import jax as _jax

        n = len(ds)
        nproc = _jax.process_count()
        per = n // nproc
        start = _jax.process_index() * per
        u, i, r = ds.read_shard(start, per)
    return (jnp.asarray(u), jnp.asarray(i), jnp.asarray(r), None)


def _synthetic_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    u_true = rng.normal(0, 0.5, (cfg.num_users, cfg.num_factors)) \
        .astype(np.float32)
    v_true = rng.normal(0, 0.5, (cfg.num_items, cfg.num_factors)) \
        .astype(np.float32)
    bu = rng.normal(0, 0.3, cfg.num_users).astype(np.float32)
    bi = rng.normal(0, 0.3, cfg.num_items).astype(np.float32)
    m = np.float32(3.5)
    users = rng.integers(0, cfg.num_users, cfg.num_ratings).astype(np.int32)
    items = rng.integers(0, cfg.num_items, cfg.num_ratings).astype(np.int32)
    mean = (u_true[users] * v_true[items]).sum(-1) + bu[users] + bi[items] + m
    r = (mean + rng.normal(0, cfg.noise, cfg.num_ratings)).astype(np.float32)
    return (jnp.asarray(users), jnp.asarray(items), jnp.asarray(r),
            dict(u=u_true, v=v_true, bu=bu, bi=bi, m=m))


def make_model(cfg: Config):
    nu, ni, k = cfg.num_users, cfg.num_items, cfg.num_factors
    n = cfg.num_ratings
    noise = cfg.noise

    def model(users, items, ratings):
        u = sample("u", dist.Normal(0.0, 1.0).expand((nu, k)).to_event(2))
        v = sample("v", dist.Normal(0.0, 1.0).expand((ni, k)).to_event(2))
        bu = sample("bu", dist.Normal(0.0, 0.5).expand((nu,)).to_event(1))
        bi = sample("bi", dist.Normal(0.0, 0.5).expand((ni,)).to_event(1))
        m = sample("m", dist.Normal(3.0, 1.0))
        with plate("ratings", n, subsample_size=cfg.batch_size) as idx:
            uid, iid = users[idx], items[idx]
            uu = jnp.take(u, uid, axis=0)
            vv = jnp.take(v, iid, axis=0)
            mean = (jnp.sum(uu * vv, -1) + jnp.take(bu, uid)
                    + jnp.take(bi, iid) + m)
            sample("obs", dist.Normal(mean, noise).to_event(1),
                   obs=ratings[idx])

    return model


# ---------------------------------------------------------------------------
# Dense sufficient-statistics path (a matmul-shaped redesign of configs[2])
#
# The sparse mini-batch ELBO is gather/scatter-bound: each step moves k=16
# floats per gathered row and does almost no arithmetic on them.  But the
# rating grid is DENSE enough for matmuls (1M ratings over 3000x1500 =
# 22% fill), and the Gaussian likelihood depends on the data only through
# per-cell sufficient statistics:
#
#   sum_ratings (r - p_ij)^2  ==  sum_cells [sqsum_ij - 2 p_ij rsum_ij
#                                            + cnt_ij p_ij^2]
#
# so the WHOLE likelihood is three dense matmuls + elementwise — no
# gathers, no subsampling.  Better still, p is bilinear in the latents, so
# under a mean-field Gaussian guide the EXPECTED log-likelihood is closed
# form (only first/second moments of q appear):
#
#   E_q[p_ij]   = mu_u . mu_v + mu_bu + mu_bi + mu_m
#   Var_q[p_ij] = sum_c (E[u^2]E[v^2] - mu_u^2 mu_v^2)
#                 + s_bu^2 + s_bi^2 + s_m^2
#   E_q[(r - p)^2] = (r - E p)^2 + Var p     (per rating)
#
# and the Normal/Normal KL terms are analytic, so the ELBO itself is
# DETERMINISTIC — zero gradient variance, exact full-batch objective, same
# optimum as the MC estimator.  One "step" here does the work of
# num_ratings/batch_size mini-batch steps, exactly.
# ---------------------------------------------------------------------------

def dense_stats(users, items, ratings, num_users, num_items):
    """Per-cell sufficient statistics: (cnt, rsum) dense arrays plus the
    scalar sum of squared ratings and the rating count."""
    u = np.asarray(users)
    i = np.asarray(items)
    r = np.asarray(ratings, np.float64)
    cnt = np.zeros((num_users, num_items), np.float64)
    rsum = np.zeros((num_users, num_items), np.float64)
    np.add.at(cnt, (u, i), 1.0)
    np.add.at(rsum, (u, i), r)
    sqsum = float((r * r).sum())
    return (jnp.asarray(cnt, jnp.float32), jnp.asarray(rsum, jnp.float32),
            sqsum, int(r.shape[0]))


def _kl_normal(loc, ls, loc0, scale0):
    """KL(N(loc, e^ls) || N(loc0, scale0)) summed over all coordinates."""
    var = jnp.exp(2.0 * ls)
    return jnp.sum(jnp.log(scale0) - ls
                   + (var + (loc - loc0) ** 2) / (2.0 * scale0 ** 2) - 0.5)


def dense_init(cfg: Config, key=None, init_scale=0.1):
    """Mean-field guide params {site: (loc, log_scale)} for the dense
    objective — same sites/shapes as MeanFieldGuide on make_model."""
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    ku, kv = jax.random.split(key)
    ils = float(np.log(init_scale))
    k = cfg.num_factors
    return {
        "u": (0.01 * jax.random.normal(ku, (cfg.num_users, k)),
              jnp.full((cfg.num_users, k), ils)),
        "v": (0.01 * jax.random.normal(kv, (cfg.num_items, k)),
              jnp.full((cfg.num_items, k), ils)),
        "bu": (jnp.zeros(cfg.num_users), jnp.full(cfg.num_users, ils)),
        "bi": (jnp.zeros(cfg.num_items), jnp.full(cfg.num_items, ils)),
        "m": (jnp.asarray(3.0), jnp.asarray(ils)),
    }


def expected_loglik(params, cnt, rsum, sqsum, n_ratings, noise):
    """Closed-form E_q[log p(ratings | theta)] under the mean-field guide.

    Exact (no MC): the likelihood is quadratic in p and p is bilinear in
    independent Gaussians, so only q's first/second moments enter."""
    (u_loc, u_ls), (v_loc, v_ls) = params["u"], params["v"]
    (bu_loc, bu_ls), (bi_loc, bi_ls) = params["bu"], params["bi"]
    m_loc, m_ls = params["m"]
    u_var, v_var = jnp.exp(2.0 * u_ls), jnp.exp(2.0 * v_ls)
    f32 = functools.partial(jax.lax.dot_general,
                            preferred_element_type=jnp.float32)
    mm = lambda a, b: f32(a, b, (((1,), (1,)), ((), ())))   # noqa: E731

    mean = (mm(u_loc, v_loc) + bu_loc[:, None] + bi_loc[None, :] + m_loc)
    # Var(sum_c u_c v_c) = sum_c E[u^2]E[v^2] - mu_u^2 mu_v^2
    var = (mm(u_loc ** 2 + u_var, v_loc ** 2 + v_var)
           - mm(u_loc ** 2, v_loc ** 2)
           + jnp.exp(2.0 * bu_ls)[:, None] + jnp.exp(2.0 * bi_ls)[None, :]
           + jnp.exp(2.0 * m_ls))
    # sum_cells cnt*(var + mean^2) - 2 rsum*mean   (+ sqsum, a constant)
    quad = jnp.sum(cnt * (var + mean * mean) - 2.0 * rsum * mean) + sqsum
    return (-0.5 / noise ** 2) * quad \
        - n_ratings * (np.log(noise) + 0.5 * np.log(2.0 * np.pi))


def dense_neg_elbo(params, cnt, rsum, sqsum, n_ratings, noise):
    """-ELBO, fully analytic (expected log-lik + closed-form KLs).  Prior
    scales match make_model: u,v ~ N(0,1); bu,bi ~ N(0,.5); m ~ N(3,1)."""
    ell = expected_loglik(params, cnt, rsum, sqsum, n_ratings, noise)
    kl = (_kl_normal(*params["u"], 0.0, 1.0)
          + _kl_normal(*params["v"], 0.0, 1.0)
          + _kl_normal(*params["bu"], 0.0, 0.5)
          + _kl_normal(*params["bi"], 0.0, 0.5)
          + _kl_normal(*params["m"], 3.0, 1.0))
    return kl - ell


def run_dense(cfg: Config, key=None, data=None):
    """Train the dense analytic-ELBO objective; returns the same stats
    surface as run() plus the loss trace."""
    if cfg.smoke:
        cfg = dataclasses.replace(
            cfg, num_users=50, num_items=30, num_factors=4,
            num_ratings=5000, steps=500,
        )
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    users, items, ratings, truth = data if data is not None \
        else make_data(cfg)
    cnt, rsum, sqsum, n = dense_stats(users, items, ratings,
                                      cfg.num_users, cfg.num_items)
    params = dense_init(cfg, key)
    opt = optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.steps))
    opt_state = opt.init(params)

    loss_fn = functools.partial(dense_neg_elbo, sqsum=sqsum, n_ratings=n,
                                noise=cfg.noise)

    @jax.jit
    def train(params, opt_state, cnt, rsum):
        def body(carry, _):
            p, s = carry
            loss, g = jax.value_and_grad(loss_fn)(p, cnt, rsum)
            upd, s = opt.update(g, s, p)
            return (optax.apply_updates(p, upd), s), loss

        return jax.lax.scan(body, (params, opt_state), None,
                            length=cfg.steps)

    (params, opt_state), losses = train(params, opt_state, cnt, rsum)

    mean_u = {k: v[0] for k, v in params.items()}
    pred = (jnp.sum(mean_u["u"][users] * mean_u["v"][items], -1)
            + mean_u["bu"][users] + mean_u["bi"][items] + mean_u["m"])
    rmse = float(jnp.sqrt(jnp.mean((pred - ratings) ** 2)))
    return {
        "rmse": rmse,
        "noise_floor": cfg.noise,
        "final_elbo": -float(losses[-1]),
        "losses": np.asarray(losses),
        "params": params,
        "mean": mean_u,
        "std": {k: jnp.exp(v[1]) for k, v in params.items()},
    }


# ---------------------------------------------------------------------------
# Mesh-sharded dense path (VERDICT r3 item 5): the (U, I) cell grid is
# embarrassingly additive over item columns, so each device holds one
# item shard of (cnt, rsum) plus the item-side guide params (v, bi) and
# materializes ONLY its (U, I/n_dev) slice of the mean/variance fields —
# the O(U*I) memory wall of the single-chip dense path becomes
# O(U*I/n_dev) per device, with one scalar psum for the loss and the
# replicated-param gradients psum'd by shard_map AD.  Equality vs the
# unsharded objective (loss AND all gradients) is asserted on the
# 8-device CPU mesh in tests/test_mf_dense_sharded.py at a grid 16x the
# benched 4.5M cells.
# ---------------------------------------------------------------------------

_ITEM_SHARDED = ("v", "bi")    # params with a leading num_items dim


def dense_param_specs(mesh, axis_name="items"):
    """PartitionSpec pytree for the dense guide params: item-side entries
    sharded on their leading dim, the rest replicated."""
    from jax.sharding import PartitionSpec as P

    def spec(site):
        if site in _ITEM_SHARDED:
            return (P(axis_name), P(axis_name))
        return (P(), P())

    return {site: spec(site) for site in ("u", "v", "bu", "bi", "m")}


def dense_neg_elbo_sharded(mesh, sqsum, n_ratings, noise,
                           axis_name="items"):
    """Build a shard_map'd drop-in for :func:`dense_neg_elbo`.

    Returns ``loss_fn(params, cnt, rsum)`` where ``cnt``/``rsum`` are
    item-column-sharded (U, I) arrays and ``params`` follow
    :func:`dense_param_specs` (sqsum / n_ratings / noise are static and
    close over).  The local term is the same closed-form expected
    log-lik restricted to the local cells plus the local share of the
    KL; one ``psum`` over ``axis_name`` makes the loss replicated, and
    differentiating THROUGH shard_map yields exact grads (item-side
    grads stay local; replicated-param grads are summed by the psum
    transpose).  num_items must divide by the axis size."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ndev = mesh.shape[axis_name]
    pspecs = dense_param_specs(mesh, axis_name)
    sqsum, n_ratings, noise = float(sqsum), float(n_ratings), float(noise)

    def local_loss(params, cnt_l, rsum_l):
        # item-side entries arrive as the LOCAL shard; u/bu/m replicated
        ell = expected_loglik(params, cnt_l, rsum_l, sqsum / ndev,
                              n_ratings / ndev, noise)
        kl = (_kl_normal(*params["v"], 0.0, 1.0)
              + _kl_normal(*params["bi"], 0.0, 0.5)
              + (_kl_normal(*params["u"], 0.0, 1.0)
                 + _kl_normal(*params["bu"], 0.0, 0.5)
                 + _kl_normal(*params["m"], 3.0, 1.0)) / ndev)
        return jax.lax.psum(kl - ell, axis_name)

    return shard_map(
        local_loss, mesh=mesh,
        in_specs=(pspecs, P(None, axis_name), P(None, axis_name)),
        out_specs=P(),
    )


def run_dense_sharded(cfg: Config, mesh, key=None, data=None,
                      axis_name="items"):
    """:func:`run_dense` over an item-sharded mesh: same optimizer, same
    schedule, same step count — per-device cell memory is 1/n_dev."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    users, items, ratings, truth = data if data is not None \
        else make_data(cfg)
    cnt, rsum, sqsum, n = dense_stats(users, items, ratings,
                                      cfg.num_users, cfg.num_items)
    col = NamedSharding(mesh, P(None, axis_name))
    cnt = jax.device_put(cnt, col)
    rsum = jax.device_put(rsum, col)
    params = jax.tree_util.tree_map(
        lambda leaf, s: jax.device_put(leaf, NamedSharding(mesh, s)),
        dense_init(cfg, key), dense_param_specs(mesh, axis_name),
        is_leaf=lambda x: isinstance(x, jax.Array))
    opt = optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.steps))
    opt_state = opt.init(params)
    loss_fn = dense_neg_elbo_sharded(mesh, sqsum, n, cfg.noise, axis_name)

    @jax.jit
    def train(params, opt_state, cnt, rsum):
        def body(carry, _):
            p, s = carry
            loss, g = jax.value_and_grad(
                lambda p_: loss_fn(p_, cnt, rsum))(p)
            upd, s = opt.update(g, s, p)
            return (optax.apply_updates(p, upd), s), loss

        return jax.lax.scan(body, (params, opt_state), None,
                            length=cfg.steps)

    (params, opt_state), losses = train(params, opt_state, cnt, rsum)
    mean_u = {k: v[0] for k, v in params.items()}
    pred = (jnp.sum(mean_u["u"][users] * mean_u["v"][items], -1)
            + mean_u["bu"][users] + mean_u["bi"][items] + mean_u["m"])
    rmse = float(jnp.sqrt(jnp.mean((pred - ratings) ** 2)))
    return {
        "rmse": rmse,
        "noise_floor": cfg.noise,
        "final_elbo": -float(losses[-1]),
        "losses": np.asarray(losses),
        "params": params,
        "mean": mean_u,
        "std": {k: jnp.exp(v[1]) for k, v in params.items()},
    }


def run(cfg: Config, key=None):
    if cfg.smoke:
        cfg = dataclasses.replace(
            cfg, num_users=50, num_items=30, num_factors=4,
            num_ratings=5000, steps=500, batch_size=512,
        )
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    users, items, ratings, truth = make_data(cfg)
    if int(users.shape[0]) != cfg.num_ratings:
        cfg = dataclasses.replace(cfg, num_ratings=int(users.shape[0]))
    model = make_model(cfg)
    svi = SVI(model, MeanFieldGuide,
              optax.adam(optax.cosine_decay_schedule(cfg.lr, cfg.steps)),
              model_args=(users, items, ratings))

    if cfg.bench:
        state = svi.init(key)
        _, dt = timed_steps(lambda s: svi.run(key, cfg.steps, state=s),
                            state)
        bench_line("elbo_steps_per_s", cfg.steps / dt, "steps/s",
                   model="matrix_fact", ratings=cfg.num_ratings,
                   batch=cfg.batch_size, factors=cfg.num_factors)
    res = svi.run(key, cfg.steps, model_args=(users, items, ratings))

    # predictive check on held-in ratings (RMSE of posterior-mean predictor)
    mean_u, _ = svi.guide.stats(res.params)
    pred = (
        jnp.sum(mean_u["u"][users] * mean_u["v"][items], -1)
        + mean_u["bu"][users] + mean_u["bi"][items] + mean_u["m"]
    )
    rmse = float(jnp.sqrt(jnp.mean((pred - ratings) ** 2)))
    return {
        "rmse": rmse,
        "noise_floor": cfg.noise,
        "final_elbo": -float(res.losses[-1]),
        "losses": np.asarray(res.losses),
        "svi": svi,
        "params": res.params,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"train RMSE = {out['rmse']:.4f} (noise floor {out['noise_floor']})")
    print(f"final ELBO = {out['final_elbo']:.1f}")


if __name__ == "__main__":
    main()
