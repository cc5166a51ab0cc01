"""Step 2's graphed fused loop and its Adam kernel, on a card.

Run on a machine with a CUDA card: ``python -m pytest --noconftest
tests/test_torch_graph.py``. Elsewhere every test skips (a CUDA graph and
a CUDA kernel have no CPU mode).

- the Adam kernel (``csrc/adam.cu``) against eager ``torch.optim.Adam``
  (foreach) over 50 steps on the VAE's parameter shapes, bit for bit;
- the fused loop as CUDA graphs against the same loop run eagerly and
  against the stepwise loop, bit for bit in every observable: val
  history, checkpoint bytes, ``dump_latent``'s latent and barcodes, the
  host ``RandomState`` and the device generator afterwards;
- the Adam kernel over more tensors than one launch takes, and past its
  table;
- the count of units replayed and of the kernel's launches.
"""

import numpy as np
import pytest
import torch

from pangaea_tpu_torch.config import ModelConfig
from pangaea_tpu_torch.kernels import adam
from pangaea_tpu_torch.model import train as ttrain
from pangaea_tpu_torch.model.dataset import BarcodeDataset
from pangaea_tpu_torch.model.vae import VAE

pytestmark = pytest.mark.cuda

ABD, TNF, HIDDEN, LATENT = 400, 136, (512, 512), 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _vae(matmul_dtype="float32"):
    return VAE(ABD, TNF, hidden_sizes=HIDDEN, latent_dim=LATENT,
               matmul_dtype=matmul_dtype,
               generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("takeover", [0, 7])
def test_adam_kernel_equals_eager_adam(cuda, takeover):
    """50 steps with random gradients of every scale; the kernel takes
    over eager Adam's state after ``takeover`` steps. Parameters, exp_avg
    and exp_avg_sq bit-equal after every step; one launch a step."""
    pa = [p.detach().to(cuda).requires_grad_() for p in _vae().parameters()]
    pb = [p.detach().clone().requires_grad_() for p in pa]
    oa = torch.optim.Adam(pa, lr=0.005, weight_decay=1e-4)
    ob = torch.optim.Adam(pb, lr=0.005, weight_decay=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(7)

    def grads(t):
        for i, (a, b) in enumerate(zip(pa, pb)):
            g = torch.randn(a.shape, generator=gen, device=cuda)
            a.grad, b.grad = g * 10.0 ** (i % 7 - 4), g * 10.0 ** (i % 7 - 4)
    for t in range(takeover):
        grads(t)
        oa.step()
        ob.step()
    kb = adam.KernelAdam(ob, 50)
    before = adam.adam_step.launches
    for t in range(takeover, 50):
        grads(t)
        oa.step()
        kb.step()
        for a, b in zip(pa, pb):
            assert torch.equal(a, b), f"param at step {t + 1}"
            assert torch.equal(oa.state[a]["exp_avg"], ob.state[b]["exp_avg"])
            assert torch.equal(oa.state[a]["exp_avg_sq"],
                               ob.state[b]["exp_avg_sq"])
    torch.cuda.synchronize()
    assert adam.adam_step.launches - before == 50 - takeover
    assert kb.state.tolist() == [50, 0, 0]


def test_adam_kernel_over_many_tensors_equals_eager_adam(cuda):
    """150 tensors, so three launches a step (64 tensors a launch), empty
    ones and ones of several chunks among them: 20 steps bit-equal to
    eager Adam, and the step counter advanced once a step."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    shapes = [(0,) if i % 13 == 0 else (3000 * (i % 4) + i % 9, 7)
              for i in range(150)]
    pa = [torch.randn(s, generator=gen, device=cuda).requires_grad_()
          for s in shapes]
    pb = [p.detach().clone().requires_grad_() for p in pa]
    oa = torch.optim.Adam(pa, lr=0.005, weight_decay=1e-4)
    kb = adam.KernelAdam(torch.optim.Adam(pb, lr=0.005, weight_decay=1e-4),
                         20)
    before = adam.adam_step.launches
    for t in range(20):
        for a, b in zip(pa, pb):
            a.grad = torch.randn(a.shape, generator=gen, device=cuda)
            b.grad = a.grad.clone()
        oa.step()
        kb.step()
        for i, (a, b) in enumerate(zip(pa, pb)):
            assert torch.equal(a, b), f"param {i} at step {t + 1}"
            assert torch.equal(oa.state[a]["exp_avg"], kb.exp_avgs[i])
            assert torch.equal(oa.state[a]["exp_avg_sq"], kb.exp_avg_sqs[i])
    assert adam.adam_step.launches - before == 20 * 3
    assert kb.state.tolist() == [20, 0, 0]


def test_adam_kernel_past_its_table_changes_nothing(cuda):
    """The step past the table leaves every tensor and the counter as
    they were and sets the flag that ``check`` raises on."""
    ps = [p.detach().to(cuda).requires_grad_() for p in _vae().parameters()]
    kb = adam.KernelAdam(torch.optim.Adam(ps, lr=0.005, weight_decay=1e-4),
                         3)
    for t in range(3):
        for p in ps:
            p.grad = torch.ones_like(p) * (t + 1)
        kb.step()
    kb.check()
    before = [t.clone() for t in ps + kb.exp_avgs + kb.exp_avg_sqs]
    kb.step()
    after = ps + kb.exp_avgs + kb.exp_avg_sqs
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert kb.state.tolist() == [3, 0, 1]
    with pytest.raises(RuntimeError, match="past its table of 3 steps"):
        kb.check()


def _synth(n, seed=0):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, n)
    abd = np.abs(rng.rand(3, ABD)[lab] * 5 + rng.randn(n, ABD) * 0.1)
    tnf = np.abs(rng.rand(3, TNF)[lab] * 5 + rng.randn(n, TNF) * 0.1)
    return (np.array([f"BC{i}" for i in range(n)]),
            (abd / abd.sum(1, keepdims=True)).astype(np.float32),
            (tnf / tnf.sum(1, keepdims=True)).astype(np.float32))


def _fit(loop, ds, cfg, model_dir, monkeypatch, graphs=True):
    """One fit on the card and what it leaves: ``graphs=False`` runs the
    fused loop as it runs off the card, with no graph."""
    gens = []
    make = ttrain.VAETrainer._generator

    def kept(self, offset):
        gens.append(make(self, offset))
        return gens[-1]
    with monkeypatch.context() as m:
        m.setattr(ttrain.VAETrainer, "_generator", kept)
        if not graphs:
            m.setattr(ttrain, "_UnitGraphs", lambda *a, **k: None)
        trainer = ttrain.VAETrainer(_vae(cfg.matmul_dtype), cfg,
                                    device="cuda")
        rng = np.random.RandomState(2021)
        state = getattr(trainer, f"_fit_{loop}")(ds, str(model_dir),
                                                 rng=rng)
        mu, barcodes = trainer.dump_latent(ds, str(model_dir), state,
                                           rng=rng)
    return dict(hist=list(trainer.val_history), pt=dict(trainer.phase_times),
                ckpt=(model_dir / "train_model.pk").read_bytes(),
                mu=mu, barcodes=barcodes, rng=rng.get_state(),
                gen=gens[0].get_state())


def _assert_same(a, b):
    assert [h[:2] for h in a["hist"]] == [h[:2] for h in b["hist"]]
    np.testing.assert_array_equal(
        np.asarray([h[2] for h in a["hist"]], np.float32),
        np.asarray([h[2] for h in b["hist"]], np.float32))
    assert a["ckpt"] == b["ckpt"]
    np.testing.assert_array_equal(a["mu"], b["mu"])
    np.testing.assert_array_equal(a["barcodes"], b["barcodes"])
    ra, rb = a["rng"], b["rng"]
    assert ra[0] == rb[0] and (ra[1] == rb[1]).all() and ra[2:] == rb[2:]
    assert torch.equal(a["gen"], b["gen"])


# (rows, batch, eval cadence, epochs, patience, delta, matmul)
CASES = {
    # 7 batches an epoch (6 full, one of 50 rows), one unit per epoch
    "one_shape": (6 * 256 + 50, 256, 100, 12, 100, 1e-6, "float32"),
    # units of 3, 3 and 1 batches: two graphs
    "two_shapes": (6 * 256 + 50, 256, 3, 5, 100, 1e-6, "float32"),
    # every eval after the first fails to improve: the stop lands on
    # unit 3, in the middle of the second chunk
    "early_stop": (6 * 256 + 50, 256, 100, 40, 3, 1e9, "float32"),
    "bfloat16": (6 * 256 + 50, 256, 100, 12, 100, 1e-6, "bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_fit_equals_eager_and_stepwise(cuda, tmp_path, monkeypatch,
                                               case):
    n, bsz, ev, epochs, patience, delta, mm = CASES[case]
    ds = BarcodeDataset(*_synth(n))
    cfg = ModelConfig(epochs=epochs, batch_size=bsz, patience=patience,
                      eval_every_batches=ev, early_stop_delta=delta,
                      hidden_sizes=HIDDEN, latent_dim=LATENT,
                      matmul_dtype=mm)
    g = _fit("fused", ds, cfg, tmp_path / "g", monkeypatch)
    e = _fit("fused", ds, cfg, tmp_path / "e", monkeypatch, graphs=False)
    s = _fit("stepwise", ds, cfg, tmp_path / "s", monkeypatch)
    _assert_same(g, e)
    _assert_same(g, s)
    pt = g["pt"]
    assert e["pt"]["graph_units"] == 0 and pt["graph_units"] > 0
    assert pt["capture"] > 0
    upe = -(-(-(-n // bsz)) // ev)
    # the first epoch runs eagerly, every later unit is a replay
    assert pt["graph_units"] == pt["units"] - upe
    if case == "early_stop":
        assert len(g["hist"]) == patience + 1
        # the host runs at most UNITS_AHEAD units past a landed flag
        assert pt["units"] <= len(g["hist"]) + ttrain.UNITS_AHEAD + 1


def test_one_shape_replays_all_but_the_first_unit(cuda, tmp_path,
                                                  monkeypatch):
    n, bsz, ev, epochs, patience, delta, mm = CASES["one_shape"]
    ds = BarcodeDataset(*_synth(n, seed=1))
    cfg = ModelConfig(epochs=epochs, batch_size=bsz, patience=patience,
                      eval_every_batches=ev, hidden_sizes=HIDDEN,
                      latent_dim=LATENT)
    adam.reset_launches()
    pt = _fit("fused", ds, cfg, tmp_path / "g", monkeypatch)["pt"]
    assert pt["units"] == epochs
    assert pt["graph_units"] == pt["units"] - 1
    # the graph records one launch for each of the unit's 7 steps; each
    # replay counts them, as the card runs them
    assert adam.adam_step.captured == 7
    assert adam.adam_step.launches == 7 * pt["graph_units"]


def test_capture_span_feeds_phase_times(cuda, tmp_path, monkeypatch):
    """The capture is timed by its own span, ``step2.capture``, directly
    under ``step2.fit`` (not inside ``step2.dispatch``), and
    ``phase_times["capture"]`` is that span's time."""
    from pangaea_tpu_torch import profiling
    n, bsz, ev, _, patience, delta, mm = CASES["two_shapes"]
    ds = BarcodeDataset(*_synth(n, seed=2))
    cfg = ModelConfig(epochs=3, batch_size=bsz, patience=patience,
                      eval_every_batches=ev, hidden_sizes=HIDDEN,
                      latent_dim=LATENT)
    profiling.take_records()
    profiling.take_totals()
    profiling.set_recording(True)
    try:
        with profiling.span("step2.fit"):
            pt = _fit("fused", ds, cfg, tmp_path / "g", monkeypatch)["pt"]
    finally:
        profiling.set_recording(False)
    recs = profiling.take_records()
    totals = profiling.take_totals()
    caps = [r for r in recs if r[0] == "step2.capture"]
    assert len(caps) == 1 and caps[0][1] == "step2.fit"
    assert pt["capture"] == pytest.approx(totals["step2.capture"], rel=1e-9)
    assert pt["graph_units"] == pt["units"] - 3
