"""PyTorch port vs pangaea_tpu: the VAE, its loss, gradients, optimiser and
training loop.

The same weights (carried across by ``vae_state_from_jax``) and the same
inputs go through pangaea_tpu's ``vae_forward`` and the port's ``VAE``.
Tolerances: float32 on the CPU, where the two packages order their sums
differently (XLA's fused reductions vs ATen's), so values agree to a few
ulps of the largest term — rtol 1e-5 / atol 1e-6 for a forward pass, and
rtol 1e-4 / atol 1e-5 once a backward pass or an optimiser step
compounds the rounding. The host random streams (batches, val sets,
latent order) must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangaea_tpu.config import ModelConfig as JaxModelConfig
from pangaea_tpu.model import train as jtrain
from pangaea_tpu.model import vae as jvae
from pangaea_tpu.model.dataset import BarcodeDataset as JaxDataset
from pangaea_tpu_torch.config import ModelConfig
from pangaea_tpu_torch.model import train as ttrain
from pangaea_tpu_torch.model.convert import (vae_state_from_jax,
                                             vae_state_to_jax)
from pangaea_tpu_torch.model.dataset import BarcodeDataset
from pangaea_tpu_torch.model.vae import (VAE, BatchNorm, embed, loss_weights,
                                         unlabeled_loss)

ABD, TNF, HIDDEN, LATENT, DROPOUT = 24, 10, (16, 12), 4, 0.2
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _jax_model():
    return jvae.VAE(abd_dim=ABD, tnf_dim=TNF, hidden_sizes=HIDDEN,
                    latent_dim=LATENT, dropout=DROPOUT)


def _port_model():
    return VAE(ABD, TNF, hidden_sizes=HIDDEN, latent_dim=LATENT,
               dropout=DROPOUT, generator=torch.Generator().manual_seed(0))


def _features(n, seed):
    rng = np.random.RandomState(seed)
    abd = rng.rand(n, ABD).astype(np.float32)
    tnf = rng.rand(n, TNF).astype(np.float32)
    return abd / abd.sum(1, keepdims=True), tnf / tnf.sum(1, keepdims=True)


@pytest.fixture
def pair():
    """JAX (params, bn_state) with non-trivial BN running stats, and a port
    VAE holding the same values."""
    jm = _jax_model()
    params, bn = jvae.init_vae(jax.random.PRNGKey(3), jm)
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(np.asarray, params)
    bn = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) + 0.5).astype(np.float32), bn)
    for layer in params["enc"] + params["dec"]:
        layer["scale"] = (rng.rand(*layer["scale"].shape) + 0.5
                          ).astype(np.float32)
        layer["bias"] = rng.randn(*layer["bias"].shape).astype(np.float32)
    model = _port_model()
    model.load_state_dict(vae_state_from_jax(params, bn))
    return jm, params, bn, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_state_round_trips(pair):
    jm, params, bn, model = pair
    p2, bn2 = vae_state_to_jax(model.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, p2, params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, bn2, bn)
    # and port -> JAX -> port
    fresh = _port_model()
    back = vae_state_from_jax(*vae_state_to_jax(fresh.state_dict()))
    for k, v in fresh.state_dict().items():
        assert torch.equal(back[k], v), k


def test_eval_forward_and_embed_match(pair):
    jm, params, bn, model = pair
    abd, tnf = _features(32, 5)
    want, _ = jvae.vae_forward(params, bn, jm, jnp.asarray(abd),
                               jnp.asarray(tnf), key=None, train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(abd), torch.from_numpy(tnf))
    for k in ("abd_rec", "tnf_rec", "mu", "logsigma"):
        _close(got[k], want[k], FWD)
    with torch.no_grad():
        mu = embed(model, torch.from_numpy(abd), torch.from_numpy(tnf))
    _close(mu, jvae.vae_embed(params, bn, jm, jnp.asarray(abd),
                              jnp.asarray(tnf)), FWD)


def _jax_draws(key, jm, batch):
    """The dropout keep-masks and latent noise vae_forward(train=True)
    draws from ``key`` (vae.py:208-222), for the port to take as given."""
    nh = len(jm.hidden_sizes)
    ks = jax.random.split(key, 2 * nh + 1)
    widths = list(jm.hidden_sizes) + list(jm.hidden_sizes[::-1])
    keys = list(ks[:nh]) + list(ks[nh + 1:])
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, 1.0 - jm.dropout, (batch, w)))) for k, w in zip(keys, widths)]
    noise = torch.from_numpy(np.array(jax.random.normal(
        ks[nh], (batch, jm.latent_dim), jnp.float32)))
    return masks, noise


def _grads_as_jax(model):
    state = {k: v for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        state[name] = p.grad
    return vae_state_to_jax(state)[0]


def _train_step(pair, batch, seed):
    """One train-mode forward + backward on both sides, with the port
    taking the dropout masks and noise the JAX forward drew."""
    jm, params, bn, model = pair
    abd, tnf = _features(batch, seed)
    key = jax.random.PRNGKey(seed)
    wa, wt, wkl = jvae.loss_weights(jm)

    @jax.jit
    def jstep(p):
        def jloss(p):
            out, new_bn = jvae.vae_forward(p, bn, jm, jnp.asarray(abd),
                                           jnp.asarray(tnf), key=key,
                                           train=True)
            losses = jvae.unlabeled_loss(out, jm, wa, wt, wkl)
            return losses["total"], (out, losses, new_bn)
        return jax.value_and_grad(jloss, has_aux=True)(p)

    (_, (jout, jlosses, jbn)), jgrads = jstep(params)
    masks, noise = _jax_draws(key, jm, batch)
    model.train()
    out = model(torch.from_numpy(abd), torch.from_numpy(tnf), noise=noise,
                drop_masks=masks)
    losses = unlabeled_loss(out, model, *loss_weights(model))
    model.zero_grad()
    losses["total"].backward()
    return (jout, jlosses, jbn, jgrads), (out, losses)


def test_train_forward_loss_and_grads_match(pair):
    (jout, jlosses, jbn, jgrads), (out, losses) = _train_step(
        pair, batch=48, seed=7)
    model = pair[3]
    for k in ("abd_rec", "tnf_rec", "mu", "logsigma"):
        _close(out[k].detach(), jout[k], GRAD)
    for k in ("total", "abd_rec", "tnf_rec", "kl_loss"):
        _close(losses[k].detach(), jlosses[k], GRAD)
    jax.tree_util.tree_map(lambda g, w: _close(g, w, GRAD),
                           _grads_as_jax(model), jgrads)
    # the running statistics moved the same way
    _, bn_now = vae_state_to_jax(model.state_dict())
    jax.tree_util.tree_map(lambda g, w: _close(g, w, FWD), bn_now, jbn)


def test_one_adam_step_matches(pair):
    """torch.optim.Adam with weight_decay == pangaea_tpu's optax chain
    (add_decayed_weights -> scale_by_adam -> scale(-lr)). Both step from
    the same weights with the same gradients: the first Adam step is
    about lr * sign(g), so gradients that differ by rounding near zero
    would flip it; the gradients themselves are compared above."""
    jm, params, bn, model = pair
    rng = np.random.RandomState(11)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32), params)
    cfg = JaxModelConfig()
    tx = jtrain.VAETrainer(jm, cfg).tx
    opt_state = tx.init(params)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=cfg.weight_decay)
    as_port = vae_state_from_jax(grads, bn)
    want = params
    for _ in range(2):  # the second step uses the moments of the first
        updates, opt_state = tx.update(grads, opt_state, want)
        want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), want,
                                      updates)
        for name, p in model.named_parameters():
            p.grad = as_port[name].clone()
        opt.step()
    got, _ = vae_state_to_jax(model.state_dict())
    jax.tree_util.tree_map(lambda g, w: _close(g, w, FWD), got, want)


@pytest.mark.parametrize("rows", [1, 2, 9])
def test_batchnorm_matches_jax_bn_apply(rows):
    """Train-mode BN on any batch, one row included (nn.BatchNorm1d would
    raise there): biased variance to normalise, n/max(n-1,1) into the
    running variance."""
    rng = np.random.RandomState(rows)
    x = rng.randn(rows, 6).astype(np.float32)
    layer = {"scale": (rng.rand(6) + 0.5).astype(np.float32),
             "bias": rng.randn(6).astype(np.float32)}
    state = {"mean": rng.randn(6).astype(np.float32),
             "var": (rng.rand(6) + 0.5).astype(np.float32)}
    want, wstate = jvae._bn_apply(layer, state, jnp.asarray(x), train=True,
                                  mask=None, eps=1e-5, momentum=0.1)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(layer["scale"]))
        bn.bias.copy_(torch.from_numpy(layer["bias"]))
        bn.running_mean.copy_(torch.from_numpy(state["mean"]))
        bn.running_var.copy_(torch.from_numpy(state["var"]))
    got = bn(torch.from_numpy(x))
    assert torch.isfinite(got).all()
    _close(got.detach(), want, FWD)
    _close(bn.running_mean, wstate["mean"], FWD)
    _close(bn.running_var, wstate["var"], FWD)


def test_one_row_training_step_runs():
    model = _port_model()
    model.train()
    abd, tnf = _features(1, 0)
    out = model(torch.from_numpy(abd), torch.from_numpy(tnf),
                generator=torch.Generator().manual_seed(0))
    loss = unlabeled_loss(out, model, *loss_weights(model))["total"]
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_early_stopping_decisions_match():
    losses = [5.0, 4.0, 4.0, 4.0000005, 3.0, 3.5, 3.2, 3.1, 3.3, 2.0, 2.5]
    saves = {"jax": 0, "port": 0}

    def counter(which):
        def save():
            saves[which] += 1
        return save

    j = jtrain.EarlyStopping(patience=3, delta=1e-6, save_fn=counter("jax"))
    t = ttrain.EarlyStopping(patience=3, delta=1e-6, save_fn=counter("port"))
    for v in losses:
        j(v)
        t(v)
        assert (t.counter, t.early_stop, t.best_score, t.val_loss_min) == \
            (j.counter, j.early_stop, j.best_score, j.val_loss_min)
    assert saves["jax"] == saves["port"] > 1
    assert t.early_stop


def _synth(n, seed=0):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, n)
    abd = np.abs(rng.rand(3, ABD)[lab] * 5 + rng.randn(n, ABD) * 0.1)
    tnf = np.abs(rng.rand(3, TNF)[lab] * 5 + rng.randn(n, TNF) * 0.1)
    return np.array([f"BC{i}" for i in range(n)]), abd, tnf


def _record_draws(ds, log):
    draw = ds.sample_indices

    def recorded(rng, num, replacement=True):
        out = draw(rng, num, replacement=replacement)
        log.append((num, replacement, out.copy()))
        return out
    ds.sample_indices = recorded


@pytest.mark.parametrize("n,bsz,ev,epochs", [(50, 8, 10, 3), (90, 8, 5, 2)])
def test_host_streams_and_latent_order_match(tmp_path, n, bsz, ev, epochs):
    """Same RandomState, same calls in the same order: identical train
    batches and val sets, the same eval points, the same rng state after
    the fit, and the same barcode order in the latent dump. The port's
    fit (its fused loop) draws as pangaea_tpu's stepwise and fused loops
    do."""
    names, abd, tnf = _synth(n)
    kw = dict(epochs=epochs, batch_size=bsz, patience=1000,
              eval_every_batches=ev, hidden_sizes=HIDDEN, latent_dim=LATENT)
    draws = {"jax": [], "port": [], "jax_fused": []}
    fds = JaxDataset(names, abd, tnf)
    _record_draws(fds, draws["jax_fused"])
    jtrain.VAETrainer(_jax_model(), JaxModelConfig(**kw))._fit_fused(
        fds, str(tmp_path / "jf"), rng=np.random.RandomState(2021))

    jds = JaxDataset(names, abd, tnf)
    _record_draws(jds, draws["jax"])
    jt = jtrain.VAETrainer(_jax_model(), JaxModelConfig(**kw))
    jrng = np.random.RandomState(2021)
    jp, jbn = jt._fit_stepwise(jds, str(tmp_path / "j"), rng=jrng)
    _, jbcs = jt.dump_latent(jds, str(tmp_path / "j"), jp, jbn, rng=jrng)

    tds = BarcodeDataset(names, abd, tnf)
    _record_draws(tds, draws["port"])
    tt = ttrain.VAETrainer(_port_model(), ModelConfig(**kw), device="cpu")
    trng = np.random.RandomState(2021)
    state = tt.fit(tds, str(tmp_path / "t"), rng=trng)
    mu, tbcs = tt.dump_latent(tds, str(tmp_path / "t"), state, rng=trng)

    assert len(draws["port"]) == len(draws["jax"]) > epochs
    assert len(draws["jax_fused"]) == len(draws["jax"])
    for (na, ra, a), (nb, rb, b), (nc, rc, c) in zip(
            draws["port"], draws["jax"], draws["jax_fused"]):
        assert (na, ra) == (nb, rb) == (nc, rc)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert [h[:2] for h in tt.val_history] == [h[:2] for h in jt.val_history]
    s, j = trng.get_state(), jrng.get_state()
    assert s[0] == j[0] and (s[1] == j[1]).all() and s[2:] == j[2:]
    np.testing.assert_array_equal(tbcs, jbcs)
    assert mu.shape == (n, LATENT) and np.isfinite(mu).all()


def test_fit_resumes_from_checkpoint(tmp_path):
    names, abd, tnf = _synth(40)
    ds = BarcodeDataset(names, abd, tnf)
    cfg = ModelConfig(epochs=2, batch_size=16, eval_every_batches=2,
                      hidden_sizes=HIDDEN, latent_dim=LATENT)
    first = ttrain.VAETrainer(_port_model(), cfg, device="cpu").fit(
        ds, str(tmp_path))
    again = ttrain.VAETrainer(_port_model(), cfg, device="cpu").fit(
        ds, str(tmp_path))
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])
