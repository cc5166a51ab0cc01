"""The Adam kernel's host side on the CPU: the table of step scalars
against what ``torch.optim.Adam``'s foreach step uses, and the plain
version of the kernel's step against eager Adam, bit for bit. The kernel
itself is held against eager Adam on a card (tests/test_torch_graph.py)."""

import numpy as np
import pytest
import torch

from pangaea_tpu_torch.kernels import adam
from pangaea_tpu_torch.model.vae import VAE

LR, WD = 0.005, 1e-4


def _params(seed=0):
    model = VAE(40, 16, hidden_sizes=(32, 32), latent_dim=8,
                generator=torch.Generator().manual_seed(seed))
    return list(model.parameters())


def _grads(params, step):
    gen = torch.Generator().manual_seed(1000 + step)
    return [torch.randn(p.shape, generator=gen) * 10.0 ** (i % 5 - 3)
            for i, p in enumerate(params)]


def _eager(params):
    return torch.optim.Adam(params, lr=LR, weight_decay=WD, foreach=True)


def test_table_equals_the_scalars_of_eager_foreach_adam(monkeypatch):
    """Every step's step_size (addcdiv's scalars) and bias_correction2_sqrt
    (div_'s scalars) that eager foreach Adam passes, rounded to float32 as
    the foreach kernels round them, against the table's rows."""
    seen = {"div": [], "addcdiv": []}
    div, addcdiv = torch._foreach_div_, torch._foreach_addcdiv_

    def rec_div(tensors, scalars):
        seen["div"].append(list(scalars))
        return div(tensors, scalars)

    def rec_addcdiv(params, t1, t2, scalars):
        seen["addcdiv"].append(list(scalars))
        return addcdiv(params, t1, t2, scalars)

    monkeypatch.setattr(torch, "_foreach_div_", rec_div)
    monkeypatch.setattr(torch, "_foreach_addcdiv_", rec_addcdiv)
    params = _params()
    opt = _eager(params)
    for t in range(50):
        for p, g in zip(params, _grads(params, t)):
            p.grad = g
        opt.step()
    rows = adam.step_scalars(LR, 0.9, 0.999, 50)
    assert rows.dtype == np.float32 and rows.shape == (50, 2)
    assert len(seen["div"]) == len(seen["addcdiv"]) == 50
    for t in range(50):
        assert len(set(seen["addcdiv"][t])) == 1
        assert len(set(seen["div"][t])) == 1
        want = np.float32([seen["addcdiv"][t][0], seen["div"][t][0]])
        np.testing.assert_array_equal(rows[t], want, err_msg=f"step {t + 1}")


def test_consts_round_eager_adams_python_scalars():
    c = adam.Consts.of(0.9, 0.999, 1e-8, WD)
    assert c == adam.Consts(float(np.float32(WD)), float(np.float32(1 - 0.9)),
                            float(np.float32(0.999)),
                            float(np.float32(1 - 0.999)),
                            float(np.float32(1e-8)))


@pytest.mark.parametrize("takeover", [0, 1, 7])
def test_kernel_adam_plain_equals_eager_adam(takeover):
    """50 steps, the first ``takeover`` by eager Adam and the rest by
    KernelAdam (its plain version on the CPU): parameters, exp_avg and
    exp_avg_sq bit-equal to eager Adam's all along."""
    pa, pb = _params(), _params()
    oa, ob = _eager(pa), _eager(pb)
    for t in range(takeover):
        for pp in (pa, pb):
            for p, g in zip(pp, _grads(pp, t)):
                p.grad = g
        oa.step()
        ob.step()
    kb = adam.KernelAdam(ob, 50)
    for t in range(takeover, 50):
        kb.zero_grad()
        assert all(p.grad is None for p in pb)
        for pp in (pa, pb):
            for p, g in zip(pp, _grads(pp, t)):
                p.grad = g
        oa.step()
        kb.step()
        for a, b in zip(pa, pb):
            assert torch.equal(a, b), f"step {t + 1}"
            assert torch.equal(oa.state[a]["exp_avg"], ob.state[b]["exp_avg"])
            assert torch.equal(oa.state[a]["exp_avg_sq"],
                               ob.state[b]["exp_avg_sq"])
    assert kb.state.tolist() == [50, 0, 0]


def test_kernel_adam_plain_over_many_tensors_equals_eager_adam():
    """150 tensors, more than one launch of the kernel takes, empty ones
    among them: 20 steps bit-equal to eager Adam."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(i % 7, 3 + i % 5) if i % 11 else (0,) for i in range(150)]
    pa = [torch.randn(s, generator=gen).requires_grad_() for s in shapes]
    pb = [p.detach().clone().requires_grad_() for p in pa]
    oa = _eager(pa)
    kb = adam.KernelAdam(_eager(pb), 20)
    for t in range(20):
        for a, b in zip(pa, pb):
            a.grad = torch.randn(a.shape, generator=gen)
            b.grad = a.grad.clone()
        oa.step()
        kb.step()
    for i, (a, b) in enumerate(zip(pa, pb)):
        assert torch.equal(a, b)
        assert torch.equal(oa.state[a]["exp_avg"], kb.exp_avgs[i])
        assert torch.equal(oa.state[a]["exp_avg_sq"], kb.exp_avg_sqs[i])
    assert kb.state.tolist() == [20, 0, 0]


def test_step_past_the_table_changes_nothing_and_raises():
    """A KernelAdam given too few steps: the step past its table leaves
    parameters, moments and counter as they were, sets the flag, and
    ``check`` raises."""
    params = _params()
    kb = adam.KernelAdam(_eager(params), 3)
    for t in range(3):
        for p, g in zip(params, _grads(params, t)):
            p.grad = g
        kb.step()
    kb.check()
    before = [t.clone() for t in params + kb.exp_avgs + kb.exp_avg_sqs]
    kb.step()
    after = params + kb.exp_avgs + kb.exp_avg_sqs
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert kb.state.tolist() == [3, 0, 1]
    with pytest.raises(RuntimeError, match="past its table of 3 steps"):
        kb.check()


@pytest.mark.parametrize("numel, launches", [
    ([], 0), ([5], 1), ([1] * 64, 1), ([1] * 65, 2), ([1] * 129, 3),
    ([0] * 64 + [1], 1), ([1] + [0] * 64, 1), ([0] * 70, 0)])
def test_launches_of_counts_groups_with_elements(numel, launches):
    assert adam.launches_of(numel) == launches


def test_kernel_adam_without_decay_skips_it():
    """weight_decay 0: eager Adam adds no decay term, and neither does the
    step (0 * p would turn an infinite parameter into NaN)."""
    pa, pb = _params(), _params()
    oa = torch.optim.Adam(pa, lr=LR, weight_decay=0.0, foreach=True)
    kb = adam.KernelAdam(torch.optim.Adam(pb, lr=LR, weight_decay=0.0),
                         10)
    for t in range(10):
        for pp in (pa, pb):
            for p, g in zip(pp, _grads(pp, t)):
                p.grad = g
        oa.step()
        kb.step()
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


def test_kernel_adam_refuses_what_it_does_not_compute():
    params = _params()
    with pytest.raises(ValueError, match="coupled L2"):
        adam.KernelAdam(torch.optim.Adam(params, amsgrad=True), 5)
    with pytest.raises(ValueError, match="coupled L2"):
        adam.KernelAdam(torch.optim.AdamW(params), 5)
    kb = adam.KernelAdam(_eager(params), 5)
    with pytest.raises(ValueError, match="no gradient"):
        kb.step()
    with pytest.raises(ValueError, match="sets gradients to None"):
        kb.zero_grad(set_to_none=False)
