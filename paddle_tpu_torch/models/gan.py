"""GAN (DCGAN-style) — generator/discriminator with alternating training
(counterpart of ``paddle_tpu/models/gan.py``; reference:
v1_api_demo/gan/gan_conf.py + gan_trainer.py — two GradientMachines
trained alternately on uniform noise vs real samples).

Both networks are plain functions over nested parameter dicts of
tensors; the two alternating updates are two eager steps, each taking
its gradients with ``torch.autograd.grad`` and writing the Adam update
into its half of the parameters. Noise and initial weights come from
``ops/prng`` (JAX's threefry), so the same key gives the JAX package's
draws. MLP variant for vector data (gan_conf.py) and a conv variant for
images (gan_conf_image.py) share the same trainer.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from paddle_tpu_torch import optimizer as opt_mod
from paddle_tpu_torch.core import place
from paddle_tpu_torch.ops import conv as ops_conv
from paddle_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class GANConfig:
    noise_dim: int = 10
    sample_dim: int = 784
    hidden_dim: int = 256
    conv: bool = False          # conv G/D for images (28x28 assumed)
    lr: float = 2e-4


def tree_from_numpy(tree, device):
    """A nested dict of arrays (the JAX package's parameters through
    numpy) as fp32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def tree_to_numpy(tree):
    """A nested dict of tensors as numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def init_params(key: torch.Tensor, cfg: GANConfig, device=None):
    """The JAX package's initial weights for ``key`` (an ``ops/prng``
    key), on ``device`` (default: the card)."""
    device = place.resolve_device(device)
    ks = prng.split(key, 8)
    H, Z, X = cfg.hidden_dim, cfg.noise_dim, cfg.sample_dim

    def normal(k, shape):
        return prng.normal(k, shape, device=device)

    def dense(k, i, o):
        return normal(k, (i, o)) / math.sqrt(i)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    if not cfg.conv:
        gen = {"w1": dense(ks[0], Z, H), "b1": zeros(H),
               "w2": dense(ks[1], H, H), "b2": zeros(H),
               "w3": dense(ks[2], H, X), "b3": zeros(X)}
        disc = {"w1": dense(ks[3], X, H), "b1": zeros(H),
                "w2": dense(ks[4], H, H), "b2": zeros(H),
                "w3": dense(ks[5], H, 1), "b3": zeros(1)}
        return {"gen": gen, "disc": disc}
    # conv variant: G projects noise to 7x7x32 then 2x transposed convs;
    # D mirrors with strided convs (gan_conf_image.py shape schedule)
    gen = {"proj": dense(ks[0], Z, 7 * 7 * 32),
           "b0": zeros(7 * 7 * 32),
           "k1": normal(ks[1], (4, 4, 32, 16)) * 0.05,
           "k2": normal(ks[2], (4, 4, 16, 1)) * 0.05}
    disc = {"k1": normal(ks[3], (4, 4, 1, 16)) * 0.05,
            "k2": normal(ks[4], (4, 4, 16, 32)) * 0.05,
            "w": dense(ks[5], 7 * 7 * 32, 1), "b": zeros(1)}
    return {"gen": gen, "disc": disc}


def generator(params, z, cfg: GANConfig):
    g = params["gen"]
    if not cfg.conv:
        h = torch.relu(z @ g["w1"] + g["b1"])
        h = torch.relu(h @ g["w2"] + g["b2"])
        return torch.tanh(h @ g["w3"] + g["b3"])
    h = torch.relu(z @ g["proj"] + g["b0"]).reshape(-1, 7, 7, 32)
    h = torch.relu(ops_conv.conv2d_transpose(h, g["k1"], stride=2))
    x = torch.tanh(ops_conv.conv2d_transpose(h, g["k2"], stride=2))
    return x.reshape(x.shape[0], -1).float()


def discriminator(params, x, cfg: GANConfig):
    d = params["disc"]
    if not cfg.conv:
        h = torch.nn.functional.leaky_relu(x @ d["w1"] + d["b1"], 0.2)
        h = torch.nn.functional.leaky_relu(h @ d["w2"] + d["b2"], 0.2)
        return (h @ d["w3"] + d["b3"])[:, 0]
    img = x.reshape(-1, 28, 28, 1)
    h = torch.nn.functional.leaky_relu(
        ops_conv.conv2d(img, d["k1"], stride=2).float(), 0.2)
    h = torch.nn.functional.leaky_relu(
        ops_conv.conv2d(h, d["k2"], stride=2).float(), 0.2)
    return (h.reshape(h.shape[0], -1) @ d["w"] + d["b"])[:, 0]


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _bce_logits(logits, target):
    # -t*log σ(l) - (1-t)*log(1-σ(l)) in the stable softplus form
    return torch.mean(softplus(logits) - target * logits)


def _leaves(tree):
    """Leaf tensors of ``tree`` that autograd differentiates against,
    sharing storage with it."""
    return {k: v.detach().requires_grad_() for k, v in tree.items()}


class GANTrainer:
    """Alternating D/G updates (the gan_trainer.py loop: train D on
    real+fake, then G through a frozen D), on ``device`` (default: the
    card)."""

    def __init__(self, cfg: GANConfig, key: torch.Tensor, device=None):
        self.cfg = cfg
        self.device = place.resolve_device(device)
        self.params = init_params(key, cfg, self.device)
        self.d_opt = opt_mod.Adam(learning_rate=cfg.lr, beta1=0.5).bind([])
        self.g_opt = opt_mod.Adam(learning_rate=cfg.lr, beta1=0.5).bind([])
        self.d_state = self.d_opt.init_state(self.params["disc"])
        self.g_state = self.g_opt.init_state(self.params["gen"])
        self._step = 0

    def _noise(self, key, n):
        return prng.uniform(key, (n, self.cfg.noise_dim), -1.0, 1.0,
                            device=self.device)

    def _d_step(self, real, z, i):
        cfg = self.cfg
        dp = _leaves(self.params["disc"])
        p = {"gen": self.params["gen"], "disc": dp}
        with torch.no_grad():
            fake = generator(p, z, cfg)
        loss = (_bce_logits(discriminator(p, real, cfg), 1.0)
                + _bce_logits(discriminator(p, fake, cfg), 0.0))
        grads = torch.autograd.grad(loss, list(dp.values()))
        _, self.d_state = self.d_opt.update(
            i, dict(zip(dp, grads)), self.params["disc"], self.d_state)
        return loss.detach()

    def _g_step(self, z, i):
        cfg = self.cfg
        gp = _leaves(self.params["gen"])
        p = {"gen": gp, "disc": self.params["disc"]}
        # non-saturating G loss: fool D into predicting real
        loss = _bce_logits(discriminator(p, generator(p, z, cfg), cfg), 1.0)
        grads = torch.autograd.grad(loss, list(gp.values()))
        _, self.g_state = self.g_opt.update(
            i, dict(zip(gp, grads)), self.params["gen"], self.g_state)
        return loss.detach()

    def train_batch(self, key: torch.Tensor, real) -> Tuple[float, float]:
        """One D step + one G step; returns (d_loss, g_loss)."""
        kd, kg = prng.split(key)
        real = torch.as_tensor(np.asarray(real, np.float32)
                               if not isinstance(real, torch.Tensor)
                               else real, dtype=torch.float32,
                               device=self.device)
        n = real.shape[0]
        d_loss = self._d_step(real, self._noise(kd, n), self._step)
        g_loss = self._g_step(self._noise(kg, n), self._step)
        self._step += 1
        return float(d_loss), float(g_loss)

    @torch.no_grad()
    def sample(self, key: torch.Tensor, n: int) -> torch.Tensor:
        return generator(self.params, self._noise(key, n), self.cfg)
