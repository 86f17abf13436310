"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY.md §4.5).

Golden rule tested explicitly: sharded result == single-device result
(allclose; bit-identical ancestor vectors for the resampler), because all
randomness is keyed by logical index, never by device."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import bayesic_tpu.dist as dist
from bayesic_tpu.core import plate, sample
from bayesic_tpu.infer.mcmc import MCMC
from bayesic_tpu.infer.smc import SMC
from bayesic_tpu.infer.svi import SVI, MeanFieldGuide
from bayesic_tpu.parallel import (
    make_mesh,
    put_sharded,
    systematic_ancestors,
    systematic_resample_shard_map,
)

KEY = jax.random.PRNGKey(0)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


def test_make_mesh_shapes():
    mesh = make_mesh({"data": 2, "model": 4})
    assert mesh.shape == {"data": 2, "model": 4}
    mesh = make_mesh({"chain": -1})
    assert mesh.shape == {"chain": 8}
    with pytest.raises(ValueError):
        make_mesh({"data": 3})


@pytest.mark.parametrize("routing", ["ring", "all_gather"])
def test_sharded_resampler_matches_global(routing):
    """shard_map resampler (both payload routings) == single-device
    resampler, bit-for-bit."""
    n = 64
    mesh = make_mesh({"particle": 8})
    lw = jax.random.normal(jax.random.PRNGKey(1), (n,))
    particles = {"x": jax.random.normal(jax.random.PRNGKey(2), (n, 3)),
                 "y": jax.random.normal(jax.random.PRNGKey(3), (n,))}

    anc_ref = systematic_ancestors(KEY, lw)
    ref = jax.tree_util.tree_map(lambda x: jnp.take(x, anc_ref, 0), particles)

    fn = systematic_resample_shard_map("particle", routing=routing)
    sharded = jax.shard_map(
        lambda k, w, p: fn(k, w, p),
        mesh=mesh,
        in_specs=(P(), P("particle"), P("particle")),
        out_specs=(P("particle"), P("particle")),
    )
    lw_s = jax.device_put(lw, NamedSharding(mesh, P("particle")))
    p_s = put_sharded(particles, mesh, "particle")
    out, anc = sharded(KEY, lw_s, p_s)

    np.testing.assert_array_equal(np.asarray(anc), np.asarray(anc_ref))
    for k in particles:
        # payload rows are exact copies in both routings
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))


def test_ring_resampler_million_particles():
    """2^20 particles over 8 shards with ring routing (VERDICT r1 item 4):
    the all_gather path would hold the full payload on every device; the
    ring holds one shard-chunk.  Checks (a) routing exactness — routing
    each particle's own global index must reproduce the ancestor vector —
    and (b) the systematic floor/ceil guarantee |count_i - N w_i| <= 1,
    which a drifting weight cumsum would break (compensated_cumsum)."""
    n = 2 ** 20
    mesh = make_mesh({"particle": 8})
    lw = 3.0 * jax.random.normal(jax.random.PRNGKey(5), (n,))
    gid = jnp.arange(n, dtype=jnp.int32)

    fn = systematic_resample_shard_map("particle", routing="ring")
    sharded = jax.jit(jax.shard_map(
        lambda k, w, p: fn(k, w, p),
        mesh=mesh,
        in_specs=(P(), P("particle"), P("particle")),
        out_specs=(P("particle"), P("particle")),
    ))
    lw_s = jax.device_put(lw, NamedSharding(mesh, P("particle")))
    gid_s = jax.device_put(gid, NamedSharding(mesh, P("particle")))
    out, anc = sharded(KEY, lw_s, gid_s)

    anc = np.asarray(anc)
    np.testing.assert_array_equal(np.asarray(out), anc)   # (a)

    from bayesic_tpu.parallel import normalize_log_weights

    w = np.exp(np.asarray(normalize_log_weights(lw), dtype=np.float64))
    w = w / w.sum()
    counts = np.bincount(anc, minlength=n)
    assert np.max(np.abs(counts - n * w)) <= 1.0 + 1e-3   # (b)


def test_dp_svi_matches_single_device():
    """Data sharded over 8 devices: same losses and params as unsharded
    (XLA inserts the gradient reduction; params stay replicated)."""
    rng = np.random.default_rng(0)
    n = 256
    x = rng.normal(0, 1, n).astype(np.float32)
    y = (1.2 * x - 0.4 + rng.normal(0, 0.5, n)).astype(np.float32)

    def model(xa, ya):
        w = sample("w", dist.Normal(0.0, 2.0))
        b = sample("b", dist.Normal(0.0, 2.0))
        sample("obs", dist.Normal(w * xa + b, 0.5).to_event(1), obs=ya)

    xj, yj = jnp.asarray(x), jnp.asarray(y)
    svi = SVI(model, MeanFieldGuide, optax.adam(0.05), model_args=(xj, yj))

    res_single = svi.run(KEY, 300, model_args=(xj, yj))

    mesh = make_mesh({"data": 8})
    sh = NamedSharding(mesh, P("data"))
    xs, ys = jax.device_put(xj, sh), jax.device_put(yj, sh)
    res_sharded = svi.run(KEY, 300, model_args=(xs, ys))

    np.testing.assert_allclose(
        np.asarray(res_single.losses), np.asarray(res_sharded.losses),
        rtol=2e-4, atol=2e-4,
    )
    for k in res_single.params:
        np.testing.assert_allclose(
            np.asarray(res_single.params[k]),
            np.asarray(res_sharded.params[k]), rtol=2e-3, atol=2e-3,
        )


def test_explicit_dp_shard_map_matches_single_device():
    """parallel.dp.dp_svi_run (hand-placed psum choreography) == plain
    SVI.run with the same key (VERDICT r1 item 9)."""
    from bayesic_tpu.parallel import dp_svi_run

    rng = np.random.default_rng(7)
    n = 256
    x = rng.normal(0, 1, n).astype(np.float32)
    y = (0.8 * x + 0.3 + rng.normal(0, 0.4, n)).astype(np.float32)

    def model(xa, ya):
        w = sample("w", dist.Normal(0.0, 2.0))
        b = sample("b", dist.Normal(0.0, 2.0))
        sample("obs", dist.Normal(w * xa + b, 0.4).to_event(1), obs=ya)

    xj, yj = jnp.asarray(x), jnp.asarray(y)
    svi = SVI(model, MeanFieldGuide, optax.adam(0.05), model_args=(xj, yj))

    res_ref = svi.run(KEY, 200, model_args=(xj, yj))

    mesh = make_mesh({"data": 8})
    res_dp = dp_svi_run(svi, mesh, KEY, (xj, yj), 200)

    np.testing.assert_allclose(
        np.asarray(res_ref.losses), np.asarray(res_dp.losses),
        rtol=2e-4, atol=2e-4,
    )
    for k in res_ref.params:
        np.testing.assert_allclose(
            np.asarray(res_ref.params[k]), np.asarray(res_dp.params[k]),
            rtol=2e-3, atol=2e-3,
        )


def test_sharded_chains_match_single_device():
    """MCMC with the chain axis sharded over 8 devices == unsharded.

    Two-horizon check: (a) short runs are bit-identical — randomness is
    keyed by logical chain index, so the PRNG streams and logic match
    exactly; (b) long runs agree *distributionally* (posterior mean within
    MC error) — over hundreds of chaotic leapfrog steps, f32 reassociation
    under a different SPMD partitioning legitimately amplifies, so
    trajectory-level equality is not the right invariant there."""
    yv = jnp.asarray(np.random.default_rng(1).normal(0.5, 1.0, 30)
                     .astype(np.float32))

    def model():
        mu = sample("mu", dist.Normal(0.0, 5.0))
        sample("obs", dist.Normal(mu, 1.0).expand((30,)).to_event(1), obs=yv)

    mesh = make_mesh({"chain": 8})
    sh = NamedSharding(mesh, P("chain"))

    def run(n, sharding):
        return MCMC(model=model, num_warmup=n, num_samples=n, num_chains=8,
                    init_step_size=0.5, chain_sharding=sharding).run(KEY)

    # (a) exact over a short horizon
    np.testing.assert_allclose(
        np.asarray(run(5, None).unconstrained),
        np.asarray(run(5, sh).unconstrained), rtol=1e-6, atol=1e-6,
    )

    # (b) long-run distributional agreement
    res_plain, res_shard = run(150, None), run(150, sh)
    post_var = 1.0 / (1.0 / 25.0 + 30.0)
    post_mean = post_var * float(yv.sum())
    for res in (res_plain, res_shard):
        mu_s = np.asarray(res.unconstrained)[:, :, 0]
        assert abs(mu_s.mean() - post_mean) < 4.0 * mu_s.std() / np.sqrt(
            200.0
        ), "posterior mean off under sharding"
    gap = abs(np.asarray(res_plain.unconstrained).mean()
              - np.asarray(res_shard.unconstrained).mean())
    assert gap < 0.05


def test_sharded_smc_matches_single_device():
    yv = jnp.asarray(np.random.default_rng(2).normal(1.0, 1.0, 16)
                     .astype(np.float32))

    def model():
        mu = sample("mu", dist.Normal(0.0, 3.0))
        sample("obs", dist.Normal(mu, 1.0).expand((16,)).to_event(1), obs=yv)

    smc_plain = SMC(model, num_particles=512, mutation_steps=2,
                    hmc_leapfrog_steps=3)
    r1 = smc_plain.run(KEY)

    mesh = make_mesh({"particle": 8})
    smc_shard = SMC(model, num_particles=512, mutation_steps=2,
                    hmc_leapfrog_steps=3,
                    particle_sharding=NamedSharding(mesh, P("particle")))
    r2 = smc_shard.run(KEY)

    np.testing.assert_allclose(float(r1.log_evidence),
                               float(r2.log_evidence), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(r1.unconstrained),
                               np.asarray(r2.unconstrained),
                               rtol=1e-3, atol=1e-3)


def test_observation_sharded_logdensity():
    """C13d: observation-dimension sharding — logdensity equal and grads
    equal with data sharded over 'model' axis."""
    rng = np.random.default_rng(3)
    n = 128
    y = jnp.asarray(rng.normal(0.3, 1.0, n).astype(np.float32))

    def model(ya):
        mu = sample("mu", dist.Normal(0.0, 10.0))
        sample("obs", dist.Normal(mu, 1.0).expand(ya.shape).to_event(1),
               obs=ya)

    from bayesic_tpu.core import build_logjoint
    _, logdensity, _, _ = build_logjoint(model, y)
    u = {"mu": jnp.asarray(0.7)}

    ref = jax.jit(
        lambda uu, d: logdensity(uu, model_args=(d,))
    )(u, y)
    g_ref = jax.grad(lambda uu: logdensity(uu, model_args=(y,)))(u)

    mesh = make_mesh({"model": 8})
    ys = jax.device_put(y, NamedSharding(mesh, P("model")))
    got = jax.jit(
        lambda uu, d: logdensity(uu, model_args=(d,))
    )(u, ys)
    g_got = jax.grad(lambda uu: logdensity(uu, model_args=(ys,)))(u)

    np.testing.assert_allclose(float(ref), float(got), rtol=1e-5)
    np.testing.assert_allclose(float(g_ref["mu"]), float(g_got["mu"]),
                               rtol=1e-5)


def test_tp_dlgm_decoder_matches_replicated():
    """C13c: shard the DLGM decoder weight matrices over the 'model' axis
    (true tensor parallelism on the decoder matmuls) and verify the run matches
    the replicated run AND that the sharding survives compilation (i.e. the
    compute/memory actually stays distributed) — VERDICT r1 item 6."""
    import optax

    from bayesic_tpu.infer.svi import SVI
    from bayesic_tpu.models import dlgm

    cfg = dlgm.Config(num_data=512, data_dim=16, latent_dim=4, hidden=32,
                      batch_size=64, steps=1)
    x = dlgm.make_data(cfg)
    model, guide, dec, enc = dlgm.make_model_and_guide(cfg, x)
    svi = SVI(model, guide, optax.adam(1e-3), model_args=(x,))

    res_ref = svi.run(KEY, 60, model_args=(x,))

    mesh = make_mesh({"model": 8})
    state = svi.init(KEY)

    def shard_decoder(path, leaf):
        if "decoder" in str(path) and leaf.ndim == 2:
            return jax.device_put(leaf, NamedSharding(mesh, P(None, "model")))
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    state = state._replace(params=jax.tree_util.tree_map_with_path(
        shard_decoder, state.params))
    res_tp = svi.run(KEY, 60, model_args=(x,), state=state)

    np.testing.assert_allclose(np.asarray(res_ref.losses),
                               np.asarray(res_tp.losses),
                               rtol=2e-4, atol=2e-4)

    # params equal AND decoder kernels still sharded over 'model'
    ref_leaves = jax.tree_util.tree_leaves_with_path(res_ref.params)
    tp_leaves = dict(
        (jax.tree_util.keystr(p), l)
        for p, l in jax.tree_util.tree_leaves_with_path(res_tp.params)
    )
    n_sharded = 0
    for path, ref_leaf in ref_leaves:
        k = jax.tree_util.keystr(path)
        tp_leaf = tp_leaves[k]
        np.testing.assert_allclose(np.asarray(ref_leaf), np.asarray(tp_leaf),
                                   rtol=5e-3, atol=5e-3, err_msg=k)
        if "decoder" in k and tp_leaf.ndim == 2:
            spec = tp_leaf.sharding.spec
            assert tuple(spec) == (None, "model"), (k, spec)
            n_sharded += 1
    assert n_sharded >= 2   # both decoder Dense kernels stayed distributed


def test_tp_sharded_guide_params_match():
    """C13c: shard the (large) mean-field guide parameter vector of the MF
    model over the 'model' axis; updates must equal the replicated run."""
    import optax

    from bayesic_tpu.models import matrix_fact as mf

    cfg = mf.Config(num_users=64, num_items=32, num_factors=4,
                    num_ratings=4096, batch_size=512, smoke=False)
    users, items, ratings, _ = mf.make_data(cfg)
    model = mf.make_model(cfg)
    from bayesic_tpu.infer.svi import SVI, MeanFieldGuide

    svi = SVI(model, MeanFieldGuide, optax.adam(0.05),
              model_args=(users, items, ratings))

    res_ref = svi.run(KEY, 50, model_args=(users, items, ratings))

    mesh = make_mesh({"model": 8})
    state = svi.init(KEY)
    sh = NamedSharding(mesh, P("model"))
    # guide params are flat (dim,) vectors; dim = 2*(64*4+32*4+64+32+1)
    state = state._replace(params=jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh) if a.ndim == 1 and
        a.shape[0] % 8 == 0 else a, state.params))
    res_tp = svi.run(KEY, 50, model_args=(users, items, ratings),
                     state=state)

    np.testing.assert_allclose(np.asarray(res_ref.losses),
                               np.asarray(res_tp.losses), rtol=2e-4,
                               atol=2e-4)
