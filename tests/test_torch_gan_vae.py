"""The port's GAN and VAE against ``paddle_tpu``'s on the CPU.

``ops/prng.normal`` against ``jax.random.normal``, bitwise (XLA:CPU's
``log1p`` and ``erfinv`` repeated step for step, ``ops/prng.py``); each
model's initial weights from the same key; 3 ``train_batch`` steps of each trainer from weights carried
through numpy (``tree_to_numpy`` / ``tree_from_numpy``) and the same keys,
losses within 1e-5; ``sample`` / ``reconstruct`` within 1e-5; and the
model cases of ``tests/test_gan_vae_demos.py`` on the port. Its
demo-script subprocess cases run ``demos/``, which stay the JAX
package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gan as jgan
from paddle_tpu.models import vae as jvae
from paddle_tpu_torch.models import gan as tgan
from paddle_tpu_torch.models import vae as tvae
from paddle_tpu_torch.ops import prng

TOL = 1e-5


@pytest.mark.parametrize("seed,shape", [(0, (1000,)), (7, (64, 20)),
                                        (123, (3, 5, 7)), (2 ** 31 - 1,
                                                           (257,))])
def test_normal_matches_jax(seed, shape):
    j = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                     jnp.float32))
    t = prng.normal(prng.prng_key(seed), shape).numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_erfinv_matches_xla_on_the_uniform_range():
    u = np.linspace(-0.9999999, 0.9999999, 20001, dtype=np.float32)
    j = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u)))
    t = prng.xla_erfinv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(t, j)
    # the w >= 5 tail (|u| > 0.9966) densely: its correctly rounded sqrt
    u = np.linspace(0.9966, 0.99999994, 40001, dtype=np.float32)
    u = np.concatenate([u, -u])
    np.testing.assert_array_equal(
        prng.xla_erfinv(torch.from_numpy(u)).numpy(),
        np.asarray(jax.scipy.special.erfinv(jnp.asarray(u))))
    # log1p on both sides of sqrt(2) - 1: Cephes' rational form below,
    # XLA:CPU's log(1 + x) above
    x = -np.linspace(0.0, 0.999, 40001, dtype=np.float32)
    np.testing.assert_array_equal(
        prng.xla_log1p(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.log1p(jnp.asarray(x))))


def _jax_trainer(mod, cls, cfg, key):
    """The JAX package's trainer with its initial weights drawn under one
    ``jax.jit`` (drawn eagerly, the conv GAN's take seconds on the CPU);
    the draws are the same."""
    from unittest import mock
    with mock.patch.object(mod, "init_params",
                           jax.jit(mod.init_params, static_argnums=1)):
        return cls(cfg, key)


def _carry(tt, jt):
    tt.params = tgan.tree_from_numpy(jax.tree.map(np.asarray, jt.params),
                                     "cpu")


@pytest.mark.parametrize("conv", [False, True])
def test_gan_init_and_steps_match_jax(conv):
    kw = dict(noise_dim=8, sample_dim=784, hidden_dim=32, conv=conv,
              lr=2e-3)
    jt = _jax_trainer(jgan, jgan.GANTrainer, jgan.GANConfig(**kw),
                      jax.random.PRNGKey(0))
    tt = tgan.GANTrainer(tgan.GANConfig(**kw), prng.prng_key(0),
                         device="cpu")
    got = tgan.tree_to_numpy(tt.params)
    for part in got:
        for k, v in got[part].items():
            want = np.asarray(jt.params[part][k])
            assert np.abs(v - want).max() <= 1e-6 * max(
                1.0, np.abs(want).max()), (part, k)
    _carry(tt, jt)
    rng = np.random.RandomState(0)
    for i in range(3):
        real = (0.7 + 0.05 * rng.randn(8, 784)).astype(np.float32)
        a = jt.train_batch(jax.random.PRNGKey(10 + i), real)
        b = tt.train_batch(prng.prng_key(10 + i), real)
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    s = tt.sample(prng.prng_key(9), 5)
    assert tuple(s.shape) == (5, 784)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jt.sample(jax.random.PRNGKey(9), 5)),
        rtol=0, atol=TOL)


def test_vae_init_and_steps_match_jax():
    kw = dict(x_dim=64, hidden_dim=32, z_dim=8, lr=3e-3)
    jt = _jax_trainer(jvae, jvae.VAETrainer, jvae.VAEConfig(**kw),
                      jax.random.PRNGKey(0))
    tt = tvae.VAETrainer(tvae.VAEConfig(**kw), prng.prng_key(0),
                         device="cpu")
    for k, v in tvae.tree_to_numpy(tt.params).items():
        want = np.asarray(jt.params[k])
        assert np.abs(v - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    tt.params = tvae.tree_from_numpy(jax.tree.map(np.asarray, jt.params),
                                     "cpu")
    rng = np.random.RandomState(0)
    for i in range(3):
        x = (rng.rand(16, 64) > 0.5).astype(np.float32)
        a = jt.train_batch(jax.random.PRNGKey(i), x)
        b = tt.train_batch(prng.prng_key(i), x)
        assert abs(a - b) <= TOL * max(1.0, abs(a))
    x = (rng.rand(4, 64) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tt.reconstruct(prng.prng_key(3), x).numpy(),
        np.asarray(jt.reconstruct(jax.random.PRNGKey(3), x)), rtol=0,
        atol=TOL)
    np.testing.assert_allclose(
        tt.sample(prng.prng_key(4), 5).numpy(),
        np.asarray(jt.sample(jax.random.PRNGKey(4), 5)), rtol=0, atol=TOL)


class TestVAE:
    def test_elbo_decreases_and_reconstructs(self, rng):
        cfg = tvae.VAEConfig(x_dim=64, hidden_dim=64, z_dim=8, lr=3e-3)
        tr = tvae.VAETrainer(cfg, prng.prng_key(0), device="cpu")
        protos = (rng.rand(2, 64) > 0.5).astype(np.float32)
        key = prng.prng_key(1)
        losses = []
        for _ in range(60):
            idx = rng.randint(0, 2, 32)
            x = np.clip(protos[idx] + 0.05 * rng.randn(32, 64), 0, 1)
            key, sub = prng.split(key)
            losses.append(tr.train_batch(sub, x.astype(np.float32)))
        assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
        rec = tr.reconstruct(key, protos).numpy()
        assert np.mean((rec > 0.5) == (protos > 0.5)) > 0.8

    def test_sample_shape(self):
        tr = tvae.VAETrainer(tvae.VAEConfig(x_dim=32, hidden_dim=32,
                                            z_dim=4), prng.prng_key(0),
                             device="cpu")
        s = tr.sample(prng.prng_key(1), 5).numpy()
        assert s.shape == (5, 32)
        assert (s >= 0).all() and (s <= 1).all()


class TestGAN:
    def test_mlp_gan_learns_mean(self, rng):
        cfg = tgan.GANConfig(noise_dim=4, sample_dim=8, hidden_dim=32,
                             lr=2e-3)
        tr = tgan.GANTrainer(cfg, prng.prng_key(0), device="cpu")
        target_mean = 0.7
        key = prng.prng_key(1)
        before = float(tr.sample(prng.prng_key(9), 256).mean())
        for _ in range(150):
            real = (target_mean + 0.05 * rng.randn(64, 8)).astype(
                np.float32)
            key, sub = prng.split(key)
            tr.train_batch(sub, real)
        after = float(tr.sample(prng.prng_key(9), 256).mean())
        assert abs(after - target_mean) < abs(before - target_mean), \
            (before, after)
        assert abs(after - target_mean) < 0.3

    def test_conv_gan_shapes(self, rng):
        cfg = tgan.GANConfig(noise_dim=8, sample_dim=784, conv=True)
        tr = tgan.GANTrainer(cfg, prng.prng_key(0), device="cpu")
        real = rng.randn(4, 784).astype(np.float32)
        d_loss, g_loss = tr.train_batch(prng.prng_key(1), real)
        assert np.isfinite(d_loss) and np.isfinite(g_loss)
        assert tuple(tr.sample(prng.prng_key(2), 3).shape) == (3, 784)
