"""PyTorch port vs pangaea_tpu: the VAE with ``matmul_dtype='bfloat16'``.

pangaea_tpu computes every layer's matmul as ``lax.dot(x.astype(bf16),
w.astype(bf16), preferred_element_type=f32)`` (model/vae.py:163-168). Its
VJP rounds both input gradients to bfloat16: ``grad_w`` is
``round_bf16(x_bf16^T g)`` and ``grad_x`` is ``round_bf16(g w_bf16^T)``.
The port's ``BF16Matmul`` computes the same in float32 on rounded
operands and rounds its gradients the same way.

Tolerances, from the worst case over seeds 0-9 on the CPU with a margin
of about 5x (the seeds tested here are a subset):

- the matmul's output: rtol/atol 1e-6 (the products are exact; only the
  order of the float32 sums differs; worst 9.5e-7 absolute on values
  near 10);
- its gradients: every element within one bfloat16 step (2^-7 of its
  magnitude) of pangaea_tpu's, and at most 1 % of the elements not
  bit-equal (worst: 1 element of 3,072): a float32 sum that lands near a
  bfloat16 rounding boundary may round the other way;
- the model's train-mode forward: within 5e-4 of each output's largest
  magnitude (worst 1.1e-4: bf16 operand rounding turns float32 ulps into
  occasional bf16 steps), the losses within rtol 5e-6 (worst 5.7e-7);
- each parameter's gradient: within 1e-2 of its largest magnitude plus
  3e-5 (worst 1.9e-3, one bfloat16 step of an entry near the largest;
  the biases of layers followed by BatchNorm have a gradient that is 0
  in exact arithmetic, and float32 noise of up to 6.2e-6 on the CPU,
  hence the 3e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pangaea_tpu.config import ModelConfig as JaxModelConfig
from pangaea_tpu.model import train as jtrain
from pangaea_tpu.model import vae as jvae
from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
from pangaea_tpu_torch.cluster.skeleton import weighted_kmeans
from pangaea_tpu_torch.config import ModelConfig
from pangaea_tpu_torch.model import train as ttrain
from pangaea_tpu_torch.model.convert import (vae_state_from_jax,
                                             vae_state_to_jax)
from pangaea_tpu_torch.model.dataset import BarcodeDataset
from pangaea_tpu_torch.model.vae import (VAE, BF16Matmul, embed,
                                         loss_weights, unlabeled_loss)

ABD, TNF, HIDDEN, LATENT, DROPOUT = 24, 10, (16, 12), 4, 0.2
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_thread():
    """One BLAS, OpenMP and torch thread: the models here are tiny, and
    threads only contend with each other and with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)


def _round_bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _jax_mm(x, w):
    return jax.lax.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)


def _within_one_step(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got, _round_bf16(got))  # rounded
    assert (np.abs(got - want) <= BF16_STEP * np.abs(want)).all()
    assert (got != want).mean() <= 0.01


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_matmul_and_its_gradients_match_jax(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 48).astype(np.float32)
    w = (rng.randn(48, 24) * 0.3).astype(np.float32)
    g = rng.randn(64, 24).astype(np.float32)
    y, vjp = jax.vjp(_jax_mm, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    ty = BF16Matmul.apply(tx, tw)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               rtol=1e-6, atol=1e-6)
    ty.backward(torch.from_numpy(g))
    _within_one_step(tx.grad.numpy(), gx)
    _within_one_step(tw.grad.numpy().T, gw)
    # the rounding is real: the unrounded float32 gradient differs
    assert not np.array_equal(tw.grad.numpy(), g.T @ _round_bf16(x))


def _pair(seed):
    jm = jvae.VAE(abd_dim=ABD, tnf_dim=TNF, hidden_sizes=HIDDEN,
                  latent_dim=LATENT, dropout=DROPOUT,
                  matmul_dtype="bfloat16")
    params, bn = jvae.init_vae(jax.random.PRNGKey(seed), jm)
    params = jax.tree_util.tree_map(np.asarray, params)
    bn = jax.tree_util.tree_map(np.asarray, bn)
    model = VAE(ABD, TNF, hidden_sizes=HIDDEN, latent_dim=LATENT,
                dropout=DROPOUT, matmul_dtype="bfloat16")
    model.load_state_dict(vae_state_from_jax(params, bn))
    return jm, params, bn, model


def _jax_draws(key, jm, batch):
    """The dropout keep-masks and latent noise vae_forward(train=True)
    draws from ``key`` (vae.py:208-222)."""
    nh = len(jm.hidden_sizes)
    ks = jax.random.split(key, 2 * nh + 1)
    widths = list(jm.hidden_sizes) + list(jm.hidden_sizes[::-1])
    keys = list(ks[:nh]) + list(ks[nh + 1:])
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 1.0 - jm.dropout, (batch, w)))) for k, w in zip(keys, widths)]
    noise = torch.from_numpy(np.array(jax.random.normal(
        ks[nh], (batch, jm.latent_dim), jnp.float32)))
    return masks, noise


def _near(got, want, frac, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= frac * np.abs(want).max() + atol


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_train_step_matches_jax(seed):
    """Forward, losses, every parameter's gradient and one Adam step of
    the bf16 model, the port taking JAX's dropout masks and noise."""
    jm, params, bn, model = _pair(seed)
    rng = np.random.RandomState(100 + seed)
    batch = 48
    abd = rng.rand(batch, ABD).astype(np.float32)
    tnf = rng.rand(batch, TNF).astype(np.float32)
    abd /= abd.sum(1, keepdims=True)
    tnf /= tnf.sum(1, keepdims=True)
    key = jax.random.PRNGKey(seed + 7)
    wa, wt, wkl = jvae.loss_weights(jm)

    def jloss(p):
        out, _ = jvae.vae_forward(p, bn, jm, jnp.asarray(abd),
                                  jnp.asarray(tnf), key=key, train=True)
        losses = jvae.unlabeled_loss(out, jm, wa, wt, wkl)
        return losses["total"], (out, losses)

    (_, (jout, jlosses)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    masks, noise = _jax_draws(key, jm, batch)
    model.train()
    out = model(torch.from_numpy(abd), torch.from_numpy(tnf), noise=noise,
                drop_masks=masks)
    losses = unlabeled_loss(out, model, *loss_weights(model))
    model.zero_grad()
    losses["total"].backward()
    for k in ("abd_rec", "tnf_rec", "mu", "logsigma"):
        assert out[k].dtype == torch.float32
        _near(out[k].detach(), jout[k], 5e-4)
    for k in ("total", "abd_rec", "tnf_rec", "kl_loss"):
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]),
                                   rtol=5e-6)
    state = dict(model.state_dict())
    for name, p in model.named_parameters():
        state[name] = p.grad
        if name.endswith(".weight") and "bn" not in name:
            np.testing.assert_array_equal(  # rounded as the VJP rounds
                p.grad.numpy(), _round_bf16(p.grad.numpy()))
    got = vae_state_to_jax(state)[0]
    jax.tree_util.tree_map(lambda g, w: _near(g, w, 1e-2, 3e-5), got,
                           jgrads)

    # one Adam step from the same weights and the same (JAX's) bf16
    # gradients: the first step is about lr * sign(g), so the pre-BN
    # biases' noise-level gradients would flip it (see
    # tests/test_torch_model.py::test_one_adam_step_matches)
    cfg = JaxModelConfig()
    tx = jtrain.VAETrainer(jm, cfg).tx
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params,
                                  updates)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=cfg.weight_decay)
    as_port = vae_state_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                 bn)
    for name, p in model.named_parameters():
        p.grad = as_port[name].clone()
    opt.step()
    stepped, _ = vae_state_to_jax(model.state_dict())
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6),
        stepped, want)


def test_bf16_eval_forward_and_embed_match_jax():
    jm, params, bn, model = _pair(5)
    rng = np.random.RandomState(5)
    abd = rng.rand(32, ABD).astype(np.float32)
    tnf = rng.rand(32, TNF).astype(np.float32)
    want, _ = jvae.vae_forward(params, bn, jm, jnp.asarray(abd),
                               jnp.asarray(tnf), key=None, train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(abd), torch.from_numpy(tnf))
        mu = embed(model, torch.from_numpy(abd), torch.from_numpy(tnf))
    for k in ("abd_rec", "tnf_rec", "mu", "logsigma"):
        _near(got[k], want[k], 5e-4)
    _near(mu, jvae.vae_embed(params, bn, jm, jnp.asarray(abd),
                             jnp.asarray(tnf)), 5e-4)


def _synth(n=600, k=3, seed=0):
    """tests/test_model.py's make_synth_dataset: k separated mixtures."""
    rng = np.random.RandomState(seed)
    centers_a = rng.rand(k, 40) * 5
    centers_t = rng.rand(k, 16) * 5
    lab = rng.randint(0, k, n)
    abd = np.abs(centers_a[lab] + rng.randn(n, 40) * 0.1)
    tnf = np.abs(centers_t[lab] + rng.randn(n, 16) * 0.1)
    return BarcodeDataset(np.array([f"BC{i}" for i in range(n)]), abd,
                          tnf), lab


def test_bf16_training_separates_clusters(tmp_path):
    """The bf16 model trains to a separating latent, as
    tests/test_model.py::test_bf16_matmul_forward_close_and_trains
    requires of pangaea_tpu's (ARI > 0.9)."""
    ds, lab = _synth()
    cfg = ModelConfig(epochs=12, batch_size=128, patience=100,
                      eval_every_batches=5, hidden_sizes=(32, 32),
                      latent_dim=8, matmul_dtype="bfloat16")
    model = VAE(40, 16, hidden_sizes=(32, 32), latent_dim=8,
                matmul_dtype="bfloat16",
                generator=torch.Generator().manual_seed(0))
    trainer = ttrain.VAETrainer(model, cfg, device="cpu")
    trainer.fit(ds, str(tmp_path))
    with torch.no_grad():
        mu = embed(model, torch.from_numpy(ds.abd),
                   torch.from_numpy(ds.tnf)).numpy()
    assert np.isfinite(mu).all()
    pred = weighted_kmeans(mu, np.ones(len(mu)), 3, random_state=0)[1]
    assert adjusted_rand_score(lab, pred) > 0.9


def test_unknown_matmul_dtype_raises():
    with pytest.raises(ValueError, match="matmul_dtype"):
        VAE(ABD, TNF, matmul_dtype="float16")
