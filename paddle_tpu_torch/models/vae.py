"""Variational autoencoder (counterpart of ``paddle_tpu/models/vae.py``;
reference: v1_api_demo/vae/vae_conf.py + vae_train.py — MLP
encoder/decoder on MNIST with the reparameterisation trick and an ELBO
objective).

One eager train step: ``torch.autograd.grad`` of the negative ELBO, the
Adam update written into the parameters. The sampling key threads
explicitly and the noise is ``ops/prng.normal`` (JAX's draws for the
same key)."""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from paddle_tpu_torch import optimizer as opt_mod
from paddle_tpu_torch.core import place
from paddle_tpu_torch.models.gan import (softplus, tree_from_numpy,  # noqa: F401
                                         tree_to_numpy)
from paddle_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    x_dim: int = 784
    hidden_dim: int = 400
    z_dim: int = 20
    lr: float = 1e-3


def init_params(key: torch.Tensor, cfg: VAEConfig, device=None):
    """The JAX package's initial weights for ``key``, on ``device``
    (default: the card)."""
    device = place.resolve_device(device)
    ks = prng.split(key, 5)
    X, H, Z = cfg.x_dim, cfg.hidden_dim, cfg.z_dim

    def dense(k, i, o):
        return prng.normal(k, (i, o), device=device) / math.sqrt(i)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    return {
        "enc_w": dense(ks[0], X, H), "enc_b": zeros(H),
        "mu_w": dense(ks[1], H, Z), "mu_b": zeros(Z),
        "lv_w": dense(ks[2], H, Z), "lv_b": zeros(Z),
        "dec_w": dense(ks[3], Z, H), "dec_b": zeros(H),
        "out_w": dense(ks[4], H, X), "out_b": zeros(X),
    }


def encode(params, x):
    h = torch.tanh(x @ params["enc_w"] + params["enc_b"])
    mu = h @ params["mu_w"] + params["mu_b"]
    logvar = h @ params["lv_w"] + params["lv_b"]
    return mu, logvar


def decode(params, z):
    h = torch.tanh(z @ params["dec_w"] + params["dec_b"])
    return h @ params["out_w"] + params["out_b"]     # bernoulli logits


def elbo_loss(params, x, key) -> Tuple[torch.Tensor, dict]:
    """Negative ELBO = BCE reconstruction + KL(q(z|x) || N(0,1))."""
    mu, logvar = encode(params, x)
    eps = prng.normal(key, tuple(mu.shape), device=mu.device)
    z = mu + torch.exp(0.5 * logvar) * eps           # reparameterisation
    logits = decode(params, z)
    bce = torch.sum(softplus(logits) - x * logits, dim=-1)
    kl = -0.5 * torch.sum(1 + logvar - torch.square(mu) - torch.exp(logvar),
                          dim=-1)
    loss = torch.mean(bce + kl)
    return loss, {"bce": torch.mean(bce), "kl": torch.mean(kl)}


class VAETrainer:
    def __init__(self, cfg: VAEConfig, key: torch.Tensor, device=None):
        self.cfg = cfg
        self.device = place.resolve_device(device)
        self.params = init_params(key, cfg, self.device)
        self.opt = opt_mod.Adam(learning_rate=cfg.lr).bind([])
        self.opt_state = self.opt.init_state(self.params)
        self._step = 0

    def _x(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(self.device, torch.float32)

    def train_batch(self, key: torch.Tensor, x) -> float:
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self.params.items()}
        loss, _ = elbo_loss(leaves, self._x(x), key)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _, self.opt_state = self.opt.update(
            self._step, dict(zip(leaves, grads)), self.params,
            self.opt_state)
        self._step += 1
        return float(loss.detach())

    @torch.no_grad()
    def reconstruct(self, key: torch.Tensor, x) -> torch.Tensor:
        mu, logvar = encode(self.params, self._x(x))
        return torch.sigmoid(decode(self.params, mu))

    @torch.no_grad()
    def sample(self, key: torch.Tensor, n: int) -> torch.Tensor:
        z = prng.normal(key, (n, self.cfg.z_dim), device=self.device)
        return torch.sigmoid(decode(self.params, z))
