"""The port's fused training loop against its stepwise loop, and both
against pangaea_tpu's host streams.

pangaea_tpu pins its fused loop to its stepwise loop
(tests/test_model.py::test_fused_fit_equals_stepwise): the same val-loss
sequence, stop point, best state, checkpoint bytes and host rng stream
afterwards. The port's fused loop is held to the same, bit for bit, at the
same five geometries, across chunk boundaries, and with every unit of a
chunk launched past the stop (as on the card, where the stop flag lands a
unit or two late). Its host ``RandomState`` draws, the draws made ahead
for a chunk included, equal pangaea_tpu's ``_fit_fused``'s.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pangaea_tpu.config import ModelConfig as JaxModelConfig
from pangaea_tpu.model import train as jtrain
from pangaea_tpu.model import vae as jvae
from pangaea_tpu.model.dataset import BarcodeDataset as JaxDataset
from pangaea_tpu_torch.config import ModelConfig
from pangaea_tpu_torch.model import train as ttrain
from pangaea_tpu_torch.model.dataset import BarcodeDataset
from pangaea_tpu_torch.model.vae import VAE

ABD, TNF, HIDDEN, LATENT = 40, 16, (32, 32), 8


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


def _synth(n, seed=0):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, n)
    abd = np.abs(rng.rand(3, ABD)[lab] * 5 + rng.randn(n, ABD) * 0.1)
    tnf = np.abs(rng.rand(3, TNF)[lab] * 5 + rng.randn(n, TNF) * 0.1)
    return np.array([f"BC{i}" for i in range(n)]), abd, tnf


def _cfg(bsz, ev, epochs, patience, **kw):
    return ModelConfig(epochs=epochs, batch_size=bsz, patience=patience,
                       eval_every_batches=ev, hidden_sizes=HIDDEN,
                       latent_dim=LATENT, **kw)


def _fit(loop, ds, cfg, model_dir):
    model = VAE(ABD, TNF, hidden_sizes=HIDDEN, latent_dim=LATENT,
                dropout=0.2, generator=torch.Generator().manual_seed(0))
    trainer = ttrain.VAETrainer(model, cfg, device="cpu")
    rng = np.random.RandomState(2021)
    state = getattr(trainer, f"_fit_{loop}")(ds, str(model_dir), rng=rng)
    return dict(state=state, hist=list(trainer.val_history),
                rng=rng.get_state(), pt=dict(trainer.phase_times),
                ckpt=(model_dir / "train_model.pk").read_bytes())


def _assert_same(s, f):
    assert [h[:2] for h in s["hist"]] == [h[:2] for h in f["hist"]]
    np.testing.assert_array_equal(
        np.asarray([h[2] for h in s["hist"]], np.float32),
        np.asarray([h[2] for h in f["hist"]], np.float32))
    assert s["state"].keys() == f["state"].keys()
    for k in s["state"]:
        np.testing.assert_array_equal(s["state"][k], f["state"][k])
    assert s["ckpt"] == f["ckpt"]
    sa, fa = s["rng"], f["rng"]
    assert sa[0] == fa[0] and (sa[1] == fa[1]).all() and sa[2:] == fa[2:]


GEOMETRIES = [
    (50, 8, 10, 6, 100),    # nb_epoch < ev: one unit per epoch
    (64, 8, 4, 5, 100),     # nb_epoch % ev == 0: full cadences only
    (90, 8, 5, 6, 100),     # mixed: units of 5, 5, 2 per epoch
    (90, 8, 5, 40, 2),      # early stop mid-run
    (50, 8, 10, 30, 1),     # early stop, small n
]


@pytest.mark.parametrize("n,bsz,ev,epochs,patience", GEOMETRIES)
def test_fused_fit_equals_stepwise(tmp_path, n, bsz, ev, epochs, patience):
    ds = BarcodeDataset(*_synth(n))
    cfg = _cfg(bsz, ev, epochs, patience)
    s = _fit("stepwise", ds, cfg, tmp_path / "s")
    f = _fit("fused", ds, cfg, tmp_path / "f")
    _assert_same(s, f)
    assert f["pt"]["chunks"] == 1 and f["pt"]["units"] == len(f["hist"])


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("n,bsz,ev,epochs,patience", [GEOMETRIES[2],
                                                     GEOMETRIES[3]])
def test_fused_fit_equals_stepwise_across_chunks(monkeypatch, tmp_path, n,
                                                 bsz, ev, epochs, patience,
                                                 chunk):
    """Small chunks: the checkpoint is pickled behind the next chunk, and
    the stop lands inside a later chunk."""
    monkeypatch.setattr(ttrain, "chunk_units", lambda *a: chunk)
    ds = BarcodeDataset(*_synth(n))
    cfg = _cfg(bsz, ev, epochs, patience)
    s = _fit("stepwise", ds, cfg, tmp_path / "s")
    f = _fit("fused", ds, cfg, tmp_path / "f")
    _assert_same(s, f)
    assert f["pt"]["chunks"] == -(-len(f["hist"]) // chunk)


@pytest.mark.parametrize("chunk", [3, 40])
def test_units_launched_after_the_stop_change_nothing(monkeypatch, tmp_path,
                                                      chunk):
    """No stop flag ever lands before the chunk ends: every unit of the
    stop's chunk is launched and trains, and the mask keeps the best
    state, the EarlyStopping state and the replay those of the stop."""
    monkeypatch.setattr(ttrain, "chunk_units", lambda *a: chunk)
    monkeypatch.setattr(ttrain._StopFlags, "landed", lambda self, i: False)
    ds = BarcodeDataset(*_synth(90))
    cfg = _cfg(8, 5, 40, 2)
    s = _fit("stepwise", ds, cfg, tmp_path / "s")
    f = _fit("fused", ds, cfg, tmp_path / "f")
    _assert_same(s, f)
    assert f["pt"]["units"] > len(f["hist"])
    assert f["pt"]["units"] % chunk == 0


def test_loop_switch_and_resume(monkeypatch, tmp_path):
    """fit() runs the fused loop unless PANGAEA_TRAIN_LOOP=stepwise; a
    second fit on the same directory loads the checkpoint."""
    ds = BarcodeDataset(*_synth(50))
    cfg = _cfg(8, 10, 3, 100)
    calls = []
    for loop in ("stepwise", "fused"):
        real = getattr(ttrain.VAETrainer, f"_fit_{loop}")
        monkeypatch.setattr(
            ttrain.VAETrainer, f"_fit_{loop}",
            lambda self, *a, _r=real, _l=loop, **k: (calls.append(_l),
                                                     _r(self, *a, **k))[1])

    def fit(d):
        model = VAE(ABD, TNF, hidden_sizes=HIDDEN, latent_dim=LATENT,
                    generator=torch.Generator().manual_seed(0))
        return ttrain.VAETrainer(model, cfg, device="cpu").fit(
            ds, str(d), rng=np.random.RandomState(2021))

    monkeypatch.delenv("PANGAEA_TRAIN_LOOP", raising=False)
    fused = fit(tmp_path / "f")
    monkeypatch.setenv("PANGAEA_TRAIN_LOOP", "stepwise")
    stepwise = fit(tmp_path / "s")
    assert calls == ["fused", "stepwise"]
    for k in fused:
        np.testing.assert_array_equal(fused[k], stepwise[k])
    monkeypatch.delenv("PANGAEA_TRAIN_LOOP")
    before = (tmp_path / "f" / "train_model.pk").read_bytes()
    again = fit(tmp_path / "f")   # resumes: no training
    assert calls == ["fused", "stepwise", "fused"]
    assert (tmp_path / "f" / "train_model.pk").read_bytes() == before
    for k in fused:
        np.testing.assert_array_equal(fused[k], again[k])


def test_fused_with_zero_epochs_saves_the_initial_model(tmp_path):
    ds = BarcodeDataset(*_synth(50))
    cfg = _cfg(8, 10, 0, 100)
    s = _fit("stepwise", ds, cfg, tmp_path / "s")
    f = _fit("fused", ds, cfg, tmp_path / "f")
    _assert_same(s, f)
    assert f["hist"] == [] and f["pt"]["units"] == 0


def _record_draws(ds, log):
    draw = ds.sample_indices

    def recorded(rng, num, replacement=True):
        out = draw(rng, num, replacement=replacement)
        log.append((num, replacement, out.copy()))
        return out
    ds.sample_indices = recorded


@pytest.mark.parametrize("n,bsz,ev,epochs,patience,delta", [
    (90, 8, 5, 6, 100, 1e-6),
    (90, 8, 5, 40, 2, 1e9),    # the stop lands on unit 2 in both packages
    (50, 8, 10, 30, 2, 1e9),   # ... with one unit per epoch
])
def test_fused_host_draws_equal_jax_fused(tmp_path, n, bsz, ev, epochs,
                                          patience, delta):
    """Every RandomState draw of pangaea_tpu's _fit_fused, the draws
    made ahead for the stop's chunk included, and the stream after the
    rollback, which the latent's shuffle reads. The two packages' val
    losses differ (their weights and noise do), so where a stop is
    tested a huge delta makes every eval after the first a
    non-improvement: both stop at unit ``patience``."""
    names, abd, tnf = _synth(n)
    kw = dict(epochs=epochs, batch_size=bsz, patience=patience,
              eval_every_batches=ev, early_stop_delta=delta,
              hidden_sizes=HIDDEN, latent_dim=LATENT)
    draws = {"jax": [], "port": []}
    jds = JaxDataset(names, abd, tnf)
    _record_draws(jds, draws["jax"])
    jm = jvae.VAE(abd_dim=ABD, tnf_dim=TNF, hidden_sizes=HIDDEN,
                  latent_dim=LATENT)
    jt = jtrain.VAETrainer(jm, JaxModelConfig(**kw))
    jrng = np.random.RandomState(2021)
    jt._fit_fused(jds, str(tmp_path / "j"), rng=jrng)
    tds = BarcodeDataset(names, abd, tnf)
    _record_draws(tds, draws["port"])
    model = VAE(ABD, TNF, hidden_sizes=HIDDEN, latent_dim=LATENT,
                generator=torch.Generator().manual_seed(0))
    tt = ttrain.VAETrainer(model, ModelConfig(**kw), device="cpu")
    trng = np.random.RandomState(2021)
    tt._fit_fused(tds, str(tmp_path / "t"), rng=trng)
    assert [h[:2] for h in tt.val_history] == [h[:2] for h in jt.val_history]
    assert len(draws["port"]) == len(draws["jax"])
    for (na, ra, a), (nb, rb, b) in zip(draws["port"], draws["jax"]):
        assert (na, ra) == (nb, rb)
        np.testing.assert_array_equal(a, b)
    s, j = trng.get_state(), jrng.get_state()
    assert s[0] == j[0] and (s[1] == j[1]).all() and s[2:] == j[2:]
    assert os.path.exists(tmp_path / "t" / "train_model.pk")


@pytest.mark.parametrize("n,bsz,ev,epochs,patience", [GEOMETRIES[2],
                                                     GEOMETRIES[3]])
def test_fused_on_the_cpu_replays_no_graph(tmp_path, n, bsz, ev, epochs,
                                           patience):
    """Off a card the fused loop captures nothing: every unit runs
    eagerly with torch.optim.Adam, in the chunks it always had."""
    ds = BarcodeDataset(*_synth(n))
    f = _fit("fused", ds, _cfg(bsz, ev, epochs, patience), tmp_path / "f")
    assert f["pt"]["graph_units"] == 0 and f["pt"]["capture"] == 0.0
    assert f["pt"]["units"] == len(f["hist"]) and f["pt"]["chunks"] == 1


@pytest.mark.parametrize("chunk", [3, 40])
def test_generator_after_a_stop_is_the_stepwise_one(monkeypatch, tmp_path,
                                                    chunk):
    """Units launched past the stop draw dropout masks and noise; the
    fused loop rolls the generator back to its state after the stop
    unit, where the stepwise loop leaves it."""
    monkeypatch.setattr(ttrain, "chunk_units", lambda *a: chunk)
    monkeypatch.setattr(ttrain._StopFlags, "landed", lambda self, i: False)
    gens = []
    make = ttrain.VAETrainer._generator
    monkeypatch.setattr(ttrain.VAETrainer, "_generator",
                        lambda self, off: gens.append(make(self, off))
                        or gens[-1])
    ds = BarcodeDataset(*_synth(90))
    cfg = _cfg(8, 5, 40, 2)
    s = _fit("stepwise", ds, cfg, tmp_path / "s")
    f = _fit("fused", ds, cfg, tmp_path / "f")
    _assert_same(s, f)
    assert f["pt"]["units"] > len(f["hist"])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
