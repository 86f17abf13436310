"""The DLGM's plain-JAX MLPs (models/dlgm.py): param shapes, the LeCun-normal
/ zero-bias init, the forward pass, and the param pytree the `decoder`
site and its consumers see."""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bayesic_tpu.infer.svi import SVI
from bayesic_tpu.models import dlgm

DEC = dlgm.Decoder(latent_dim=3, hidden=16, data_dim=8)
ENC = dlgm.Encoder(data_dim=8, hidden=16, latent_dim=3)


def _shapes(params):
    return jax.tree_util.tree_map(lambda a: a.shape, params)


def test_decoder_param_shapes():
    assert _shapes(DEC.init(jax.random.PRNGKey(0))) == {
        "hidden": {"kernel": (3, 16), "bias": (16,)},
        "out": {"kernel": (16, 8), "bias": (8,)},
    }


def test_encoder_param_shapes():
    assert _shapes(ENC.init(jax.random.PRNGKey(0))) == {
        "hidden": {"kernel": (8, 16), "bias": (16,)},
        "mu": {"kernel": (16, 3), "bias": (3,)},
        "log_sigma": {"kernel": (16, 3), "bias": (3,)},
    }


@pytest.mark.parametrize("fan_in,fan_out", [(256, 512), (32, 4096)])
def test_init_is_lecun_normal_with_zero_bias(fan_in, fan_out):
    p = dlgm._dense_init(jax.random.PRNGKey(1), fan_in, fan_out)
    k = np.asarray(p["kernel"])
    assert k.shape == (fan_in, fan_out)
    # variance 1/fan_in; truncated at 2 untruncated standard deviations
    assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.03
    assert abs(k.mean()) < 0.01 / np.sqrt(fan_in) * 10
    assert np.abs(k).max() <= 2.0 / np.sqrt(fan_in) / 0.8796256610 + 1e-6
    assert not np.asarray(p["bias"]).any()


def test_init_is_deterministic_in_the_key():
    a, b = DEC.init(jax.random.PRNGKey(3)), DEC.init(jax.random.PRNGKey(3))
    c = DEC.init(jax.random.PRNGKey(4))
    same = jax.tree_util.tree_map(np.array_equal, a, b)
    assert all(jax.tree_util.tree_leaves(same))
    assert not np.array_equal(a["hidden"]["kernel"], c["hidden"]["kernel"])


def test_decoder_forward_matches_numpy():
    p = DEC.init(jax.random.PRNGKey(2))
    p = jax.tree_util.tree_map(lambda a: a + 0.1, p)   # nonzero biases
    z = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    h = np.tanh(z @ np.asarray(p["hidden"]["kernel"])
                + np.asarray(p["hidden"]["bias"]))
    want = h @ np.asarray(p["out"]["kernel"]) + np.asarray(p["out"]["bias"])
    got = DEC.apply(p, jnp.asarray(z))
    assert got.dtype == jnp.float32 and got.shape == (5, 8)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_encoder_forward_and_clip():
    p = ENC.init(jax.random.PRNGKey(2))
    p["log_sigma"]["bias"] = jnp.asarray([-50.0, 0.0, 50.0])
    x = jnp.ones((4, 8))
    mu, log_sig = ENC.apply(p, x)
    assert mu.shape == log_sig.shape == (4, 3)
    h = jnp.tanh(x @ p["hidden"]["kernel"] + p["hidden"]["bias"])
    np.testing.assert_allclose(np.asarray(mu), np.asarray(
        h @ p["mu"]["kernel"] + p["mu"]["bias"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(log_sig[:, 0]), -6.0)
    np.testing.assert_allclose(np.asarray(log_sig[:, 2]), 3.0)


def test_apply_broadcasts_leading_dims():
    p = DEC.init(jax.random.PRNGKey(5))
    z = jax.random.normal(jax.random.PRNGKey(6), (2, 7, 3))
    got = DEC.apply(p, z)
    assert got.shape == (2, 7, 8)
    np.testing.assert_allclose(np.asarray(got[1]),
                               np.asarray(DEC.apply(p, z[1])), rtol=1e-6)


def test_bfloat16_compute_keeps_float32_params_and_output():
    bf = dlgm.Decoder(3, 16, 8, dtype=jnp.bfloat16)
    p = bf.init(jax.random.PRNGKey(7))
    assert all(a.dtype == jnp.float32 for a in jax.tree_util.tree_leaves(p))
    z = jax.random.normal(jax.random.PRNGKey(8), (6, 3))
    got = bf.apply(p, z)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(DEC.apply(p, z)),
                               rtol=0.05, atol=0.05)


def test_decoder_param_site_feeds_the_model():
    cfg = dlgm.Config(num_data=128, data_dim=8, latent_dim=3, hidden=16,
                      batch_size=32, compute_dtype="bfloat16")
    x = dlgm.make_data(cfg)
    model, guide, dec, enc = dlgm.make_model_and_guide(cfg, x)
    assert dec.dtype == jnp.bfloat16 and enc.dtype == jnp.bfloat16
    svi = SVI(model, guide, optax.adam(1e-3), model_args=(x,))
    state = svi.init(jax.random.PRNGKey(0))
    dec_p = state.params["model"]["decoder"]
    assert _shapes(dec_p) == _shapes(dec.init(jax.random.PRNGKey(0)))
    two_d = [a for a in jax.tree_util.tree_leaves(dec_p) if a.ndim == 2]
    assert len(two_d) == 2
    _, loss = jax.jit(lambda s: svi.step(s, model_args=(x,)))(state)
    assert np.isfinite(float(loss))


def test_dlgm_imports_no_flax():
    tree = ast.parse(inspect.getsource(dlgm))
    names = [a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names] + [n.module or "" for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not any("flax" in n for n in names)
