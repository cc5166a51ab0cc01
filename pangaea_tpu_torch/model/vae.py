"""Variational autoencoder over (abundance, TNF) barcode features.

Port of pangaea_tpu/model/vae.py as an ``nn.Module``. Behavior contract
(reference src/models/VAENET.py):

- architecture (VAENET.py:187-253): encoder stack of
  Linear -> BatchNorm1d -> LeakyReLU -> Dropout per hidden size; heads
  ``mu`` and ``sigma`` (softplus on the sigma head => ``logsigma >= 0``);
  reparameterization ``latent = mu + eps * exp(logsigma / 2)``
  (VAENET.py:222-230); mirrored decoder stack; one output Linear to
  abd_dim + tnf_dim, split and softmax'ed per head (VAENET.py:238-253).
- ``nn.LeakyReLU(True)`` in the reference binds negative_slope=1.0, so
  the activation is the identity by default.
- loss (VAENET.py:161-184): ``wa*CE(abd) + wt*CE(tnf) + w_kl*KL``.
- ``matmul_dtype='bfloat16'`` (pangaea_tpu's ``_mm``, vae.py:163-168)
  rounds both operands of every layer's matmul to bfloat16 and
  accumulates in float32 with a float32 result; the backward pass rounds
  both input gradients to bfloat16, as the VJP of JAX's
  ``lax.dot(bf16, bf16, preferred_element_type=f32)`` behind an f32->bf16
  convert does (:class:`BF16Matmul`). Biases, BatchNorm, activations, the
  loss and Adam stay float32.
- BatchNorm is written out by hand, as pangaea_tpu's ``_bn_apply``:
  biased variance to normalise, unbiased variance (n / max(n-1, 1)) into
  the running stats, eps 1e-5, momentum 0.1; eval mode uses the running
  stats. ``nn.BatchNorm1d`` would raise on a one-row training batch,
  which the last batch of an epoch can be.

Randomness: dropout masks and the latent noise are drawn from an explicit
``torch.Generator`` unless the caller hands them in (the tests hand in
the masks and noise the JAX package draws, so both compute the same).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class BF16Matmul(torch.autograd.Function):
    """``x @ w.T`` on bfloat16-rounded operands with a float32 result.

    The products of two bfloat16 values are exact in float32, so a
    float32 matmul of the rounded operands (TF32 off, as
    ``utils.setup_numerics`` sets) is a bfloat16 matmul with float32
    accumulation. Both input gradients are rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xb, wb = _round_bf16(x), _round_bf16(w)
        ctx.save_for_backward(xb, wb)
        return xb @ wb.T

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xb, wb = ctx.saved_tensors
        gx = _round_bf16(g @ wb) if ctx.needs_input_grad[0] else None
        gw = _round_bf16(g.T @ xb) if ctx.needs_input_grad[1] else None
        return gx, gw


class BatchNorm(nn.Module):
    """BatchNorm1d with pangaea_tpu's semantics (see module docstring).

    ``row_reduce``, when set, is a differentiable sum over the ranks that
    hold the batch's rows (``parallel.dist`` sets it for a data-parallel
    step): the mean is the global sum over the global row count, then the
    variance the global sum of squared deviations from that mean over the
    same count — the two passes of the one-device form, never
    E[x^2] - E[x]^2."""

    row_reduce = None

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.row_reduce is None:
                n = x.shape[0]
                mean = x.mean(0)
                var = (x - mean).square().mean(0)
                bessel = n / max(n - 1.0, 1.0)
            else:
                red = self.row_reduce
                tot = red(torch.cat([x.sum(0), x.new_full((1,), x.shape[0])]))
                n = tot[-1]
                mean = tot[:-1] / n
                var = red((x - mean).square().sum(0)) / n
                bessel = n.detach() / torch.clamp(n.detach() - 1.0, min=1.0)
            xhat = (x - mean) * torch.rsqrt(var + self.eps)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * bessel
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            xhat = ((x - self.running_mean)
                    * torch.rsqrt(self.running_var + self.eps))
        return xhat * self.weight + self.bias


class VAE(nn.Module):
    def __init__(self, abd_dim: int, tnf_dim: int,
                 hidden_sizes: Sequence[int] = (512, 512),
                 latent_dim: int = 32, dropout: float = 0.2,
                 negative_slope: float = 1.0, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, loss_eps: float = 1e-9,
                 matmul_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        """Weights follow nn.Linear's default init (U(+-1/sqrt(fan_in))
        for weight and bias), drawn from ``generator`` when given."""
        super().__init__()
        if matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"matmul_dtype={matmul_dtype!r}: float32 or "
                             "bfloat16")
        self.matmul_dtype = matmul_dtype
        self.abd_dim, self.tnf_dim = abd_dim, tnf_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.latent_dim = latent_dim
        self.dropout = dropout
        self.negative_slope = negative_slope
        self.loss_eps = loss_eps
        sizes = (self.input_dim,) + self.hidden_sizes
        rsizes = (latent_dim,) + self.hidden_sizes[::-1]
        nh = len(self.hidden_sizes)
        self.enc = nn.ModuleList(nn.Linear(sizes[i], sizes[i + 1])
                                 for i in range(nh))
        self.enc_bn = nn.ModuleList(BatchNorm(sizes[i + 1], bn_eps,
                                              bn_momentum) for i in range(nh))
        self.mu = nn.Linear(self.hidden_sizes[-1], latent_dim)
        self.sigma = nn.Linear(self.hidden_sizes[-1], latent_dim)
        self.dec = nn.ModuleList(nn.Linear(rsizes[i], rsizes[i + 1])
                                 for i in range(nh))
        self.dec_bn = nn.ModuleList(BatchNorm(rsizes[i + 1], bn_eps,
                                              bn_momentum) for i in range(nh))
        self.out = nn.Linear(self.hidden_sizes[0], self.input_dim)
        with torch.no_grad():
            for lin in self.linears():
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)

    @property
    def input_dim(self) -> int:
        return self.abd_dim + self.tnf_dim

    def linears(self) -> List[nn.Linear]:
        return [*self.enc, self.mu, self.sigma, *self.dec, self.out]

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.negative_slope == 1.0:
            return x
        return F.leaky_relu(x, self.negative_slope)

    def linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``lin(x)`` under the model's matmul precision."""
        if self.matmul_dtype == "bfloat16":
            return BF16Matmul.apply(x, lin.weight) + lin.bias
        return lin(x)

    def _stack(self, lins, bns, x, masks):
        for i, (lin, bn) in enumerate(zip(lins, bns)):
            x = self._act(bn(self.linear(lin, x)))
            if masks is not None:
                x = torch.where(masks[i], x / (1.0 - self.dropout),
                                torch.zeros_like(x))
        return x

    def _drop_masks(self, n: int, device, generator) -> Optional[list]:
        if self.dropout == 0.0:
            return None
        keep = 1.0 - self.dropout
        shapes = ([(n, h) for h in self.hidden_sizes]
                  + [(n, h) for h in self.hidden_sizes[::-1]])
        return [torch.rand(s, generator=generator, device=device) < keep
                for s in shapes]

    def draws(self, n: int, device, generator: torch.Generator,
              train: bool) -> Tuple[Optional[list], torch.Tensor]:
        """The (dropout keep-masks, latent noise) a forward pass of ``n``
        rows draws from ``generator``, in its order: the masks (train
        mode, dropout on) first, then the noise. A data-parallel step
        draws them for the whole batch and gives each rank its rows, so
        the world size does not change the draw."""
        masks = self._drop_masks(n, device, generator) if train else None
        noise = torch.randn((n, self.latent_dim), generator=generator,
                            device=device)
        return masks, noise

    def forward(self, abd: torch.Tensor, tnf: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                drop_masks: Optional[List[torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Full forward pass; returns the out_net dict of VAENET.py:246-253
        (abd/tnf inputs, abd_rec/tnf_rec softmax reconstructions, mu,
        logsigma).

        Train mode applies dropout with ``drop_masks`` (boolean keep
        masks, encoder layers then decoder layers) or masks drawn from
        ``generator``, and always samples the latent noise. Eval mode
        applies no dropout; it samples the noise when given a
        ``generator`` (the reference's val pass does, VAENET.py:227) and
        uses zero noise otherwise. ``noise`` overrides any draw."""
        nh = len(self.hidden_sizes)
        x = torch.cat([abd, tnf], dim=1)
        if self.training and drop_masks is None:
            drop_masks = self._drop_masks(x.shape[0], x.device, generator)
        if not self.training:
            drop_masks = None
        h = self._stack(self.enc, self.enc_bn, x,
                        None if drop_masks is None else drop_masks[:nh])
        mu = self.linear(self.mu, h)
        logsigma = F.softplus(self.linear(self.sigma, h))
        if noise is None:
            if self.training or generator is not None:
                noise = torch.randn(mu.shape, generator=generator,
                                    device=mu.device)
            else:
                noise = torch.zeros_like(mu)
        latent = mu + noise * torch.exp(logsigma / 2.0)
        d = self._stack(self.dec, self.dec_bn, latent,
                        None if drop_masks is None else drop_masks[nh:])
        out = self.linear(self.out, d)
        return {"abd": abd, "tnf": tnf,
                "abd_rec": F.softmax(out[:, :self.abd_dim], dim=1),
                "tnf_rec": F.softmax(out[:, self.abd_dim:], dim=1),
                "mu": mu, "logsigma": logsigma}


def loss_weights(model: VAE, alpha: float = 0.1, w_kl: float = 0.015
                 ) -> Tuple[float, float, float]:
    """(wa, wt, w_kl) exactly as VAENET.py:20-22."""
    wa = alpha * 100.0 / math.log(model.abd_dim)
    wt = (1.0 - alpha) * 100.0 / math.log(model.tnf_dim)
    wkl = w_kl * 100.0 / model.latent_dim
    return wa, wt, wkl


def unlabeled_loss(out_net: Dict[str, torch.Tensor], model: VAE, wa: float,
                   wt: float, wkl: float, denom=None
                   ) -> Dict[str, torch.Tensor]:
    """VAENET.unlabeled_loss (VAENET.py:161-180): means over the batch.
    With ``denom`` (a data-parallel step's global row count) each term is
    this rank's row sum over ``denom``: its share of the global mean."""
    eps = model.loss_eps
    ce_abd = -(torch.log(out_net["abd_rec"] + eps) * out_net["abd"]).sum(-1)
    ce_tnf = -(torch.log(out_net["tnf_rec"] + eps) * out_net["tnf"]).sum(-1)
    mu, logsigma = out_net["mu"], out_net["logsigma"]
    kl = -0.5 * (1 + logsigma - mu.square() - torch.exp(logsigma)).sum(-1)
    if denom is None:
        loss_abd, loss_tnf, loss_kl = ce_abd.mean(), ce_tnf.mean(), kl.mean()
    else:
        loss_abd, loss_tnf, loss_kl = (ce_abd.sum() / denom,
                                       ce_tnf.sum() / denom, kl.sum() / denom)
    total = wa * loss_abd + wt * loss_tnf + wkl * loss_kl
    return {"total": total, "abd_rec": loss_abd, "tnf_rec": loss_tnf,
            "kl_loss": loss_kl}


def embed(model: VAE, abd: torch.Tensor, tnf: torch.Tensor) -> torch.Tensor:
    """mu only, eval semantics (running BN stats, no dropout, no noise) —
    VAENET.emebdding (VAENET.py:232-236), pangaea_tpu's ``vae_embed``.
    Leaves the module's train/eval mode as it found it."""
    was = model.training
    model.eval()
    try:
        h = model._stack(model.enc, model.enc_bn,
                         torch.cat([abd, tnf], dim=1), None)
        return model.linear(model.mu, h)
    finally:
        model.train(was)


def l1_normalize(x: np.ndarray) -> np.ndarray:
    """sklearn normalize(x, 'l1') twin: rows of all-zero stay zero."""
    s = np.abs(x).sum(axis=1, keepdims=True)
    s = np.where(s == 0, 1.0, s)
    return x / s
