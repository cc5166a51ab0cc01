"""The plain reference: steps 0-3 worked out again from the benchmark's own
inputs, in NumPy and plain PyTorch.

It imports nothing of the program and takes nothing the program made.
What it computes follows the upstream tools' contracts:

- step 0 (``run_pangaea``'s stLFR branch): headers ``name#x_y_z/r``
  become ``name\\tBX:Z:<wl[x]wl[y]wl[z]>-1`` on both mates (``0_0_0``
  keeps the bare name), mates are interleaved, and pairs are sorted by
  the ``BX:Z:`` token (``~~~`` when absent) with the whole record
  breaking ties, as ``LANG=C sort`` does;
- step 1 (``count_kmer.cpp``, ``count_tnf.cpp``): a barcode's group is
  its pairs after the first, plus the first pair of the next barcode (the
  upstream flush order); a group is kept when it has a barcode and its
  concatenated length (``len + 1`` per read) exceeds ``-l``; a window's
  abundance bin is the file-wide count of its canonical k-mer divided by
  ``-s``, kept below ``-v``; TNF counts canonical 4-mers, columns in
  ascending canonical value, bases coded A=0 C=1 T=2 G=3;
- step 2 (``VAENET.py``, ``pangaea.py``): the VAE, its loss, Adam with
  coupled L2, the weighted samplers, an eval every epoch, the best val
  checkpoint, and ``mu`` of that checkpoint in a shuffled order. Weights,
  masks and noise are drawn from the configuration's seed in the order
  the upstream loop draws them, so a sound program gives the same
  latent;
- step 3: how far each barcode's own centroid lies beyond its nearest
  one, the centroids being the means of the program's clusters on the
  reference's latent (k-means converges to labels for which that is 0).

``precision="tf32"`` computes every matmul of step 2 on operands rounded
to TF32 (10 mantissa bits, round to nearest even) with float32 sums: the
control, which a sound program must beat.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch.nn import functional as F

# base code of count_kmer.cpp: (ascii >> 1) & 3 -> A=0 C=1 T=2 G=3
_CODE = np.full(256, 255, np.uint8)
for _b in b"ACGT":
    _CODE[_b] = (_b >> 1) & 3


# ---- step 0 -----------------------------------------------------------------

def sort_order(keys: np.ndarray, names: np.ndarray) -> np.ndarray:
    """Pair order of the barcode sort: by key bytes, then by record bytes,
    which for records with distinct fixed-width names is name order."""
    return np.lexsort((names, keys))


def stlfr_sorted(inp) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(order, headers, barcode ids) of step 0's output for raw stLFR:
    ``order`` indexes the raw pairs, ``headers`` are the rewritten
    headers (with '@') in sorted order."""
    bc = inp.pair_barcode
    virt = np.where(bc >= 0, inp.barcodes[np.maximum(bc, 0)], b"")
    keys = np.where(bc >= 0, np.char.add(np.char.add(b"BX:Z:", virt), b"-1"),
                    b"~~~")
    order = sort_order(keys, inp.names)
    head = np.char.add(b"@", inp.names)
    tagged = np.char.add(np.char.add(head, b"\tBX:Z:"),
                         np.char.add(virt, b"-1"))
    headers = np.where(bc >= 0, tagged, head)[order]
    return order, headers, bc[order]


# ---- step 1 -----------------------------------------------------------------

def group_of_pairs(pair_bc: np.ndarray) -> np.ndarray:
    """The group (barcode id, -1 for none) each pair of a sorted stream
    lands in under the upstream flush order."""
    prev = np.concatenate([[-1], pair_bc[:-1]])
    same = np.concatenate([[False], pair_bc[1:] == pair_bc[:-1]])
    return np.where(same, pair_bc, prev)


def _windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mer value of every window, (R, L-k+1) int64."""
    c = codes.to(torch.int64)
    w = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], w), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        col = c[:, j:j + w]
        fwd = fwd * 4 + col
        rev = rev + (col ^ 2) * (4 ** j)
    return torch.minimum(fwd, rev)


def features(seq1: np.ndarray, seq2: np.ndarray, pair_bc: np.ndarray,
             barcodes: np.ndarray, binning: dict, device
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(names, abundance, tnf) of every kept group, in stream order.
    ``seq1``/``seq2`` are the ASCII mates of a barcode-sorted stream."""
    k, tk = int(binning["k"]), int(binning["tnf_k"])
    win, vsize = int(binning["s"]), int(binning["v"])
    min_len = int(binning["l"])
    n, L = seq1.shape
    codes = torch.from_numpy(_CODE[np.concatenate([seq1, seq2])]).to(device)
    if bool((codes > 3).any()):
        raise ValueError("the reference takes ACGT reads only")
    grp = group_of_pairs(pair_bc)
    glen = np.bincount(grp[grp >= 0], minlength=len(barcodes)) * 2 * (L + 1)
    kept = glen > min_len
    present = np.zeros(len(barcodes), bool)
    present[grp[grp >= 0]] = True
    kept &= present
    # kept groups in stream order (the first pair of each group)
    first = np.unique(grp[grp >= 0], return_index=True)
    ids = first[0][np.argsort(first[1])]
    ids = ids[kept[ids]]
    slot = np.full(len(barcodes) + 1, -1, np.int64)
    slot[ids] = np.arange(len(ids))
    row_slot = torch.from_numpy(np.concatenate([slot[grp], slot[grp]])
                                ).to(device)

    canon = _windows(codes, k)
    _, inv, cnt = torch.unique(canon.reshape(-1), return_inverse=True,
                               return_counts=True)
    bins = (cnt[inv] // win).view_as(canon)
    ok = (bins < vsize) & (row_slot[:, None] >= 0)
    flat = (row_slot[:, None] * vsize + bins)[ok]
    abd = torch.bincount(flat, minlength=len(ids) * vsize).view(-1, vsize)

    all4 = torch.arange(4 ** tk, device=device)
    digits = torch.stack([(all4 >> (2 * (tk - 1 - j))) & 3
                          for j in range(tk)], 1)
    canon_all = _windows(digits, tk).view(-1)
    cols = torch.unique(canon_all)
    t = _windows(codes, tk)
    rank = torch.searchsorted(cols, t)
    okt = (row_slot[:, None] >= 0).expand_as(t)
    tflat = (row_slot[:, None] * len(cols) + rank)[okt]
    tnf = torch.bincount(tflat, minlength=len(ids) * len(cols)
                         ).view(-1, len(cols))
    return barcodes[ids], abd.cpu().numpy(), tnf.cpu().numpy()


# ---- step 2 -----------------------------------------------------------------

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    """``x @ w.T + b`` with every matmul, forward and backward, on
    TF32-rounded operands."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = _round_tf32(x), _round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.T + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _round_tf32(g)
        return gr @ wr, gr.T @ xr, g.sum(0)


class _Linear(torch.nn.Linear):
    tf32 = False

    def forward(self, x):
        if self.tf32:
            return _TF32Linear.apply(x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)


class _BatchNorm(torch.nn.Module):
    """Batch statistics with the biased variance; the running variance
    takes the unbiased one (n / max(n - 1, 1)); eps 1e-5, momentum 0.1."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(dim))
        self.bias = torch.nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        eps, m = 1e-5, 0.1
        if self.training:
            n = x.shape[0]
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            xhat = (x - mean) * torch.rsqrt(var + eps)
            with torch.no_grad():
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            xhat = ((x - self.running_mean)
                    * torch.rsqrt(self.running_var + eps))
        return xhat * self.weight + self.bias


class VAE(torch.nn.Module):
    """VAENET.py's VAE. ``nn.LeakyReLU(True)`` upstream sets the slope to
    1.0, so the activation is the identity."""

    def __init__(self, abd_dim, tnf_dim, hidden, latent, dropout,
                 generator, tf32=False):
        super().__init__()
        self.abd_dim, self.dropout = abd_dim, dropout
        self.hidden = tuple(hidden)
        din = abd_dim + tnf_dim
        sizes = (din,) + self.hidden
        rsizes = (latent,) + self.hidden[::-1]
        nh = len(self.hidden)
        self.enc = torch.nn.ModuleList(_Linear(sizes[i], sizes[i + 1])
                                       for i in range(nh))
        self.enc_bn = torch.nn.ModuleList(_BatchNorm(s) for s in sizes[1:])
        self.mu = _Linear(self.hidden[-1], latent)
        self.sigma = _Linear(self.hidden[-1], latent)
        self.dec = torch.nn.ModuleList(_Linear(rsizes[i], rsizes[i + 1])
                                       for i in range(nh))
        self.dec_bn = torch.nn.ModuleList(_BatchNorm(s) for s in rsizes[1:])
        self.out = _Linear(self.hidden[0], din)
        with torch.no_grad():
            for lin in (*self.enc, self.mu, self.sigma, *self.dec, self.out):
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)
                lin.tf32 = tf32

    def _stack(self, lins, bns, x, masks):
        for i, (lin, bn) in enumerate(zip(lins, bns)):
            x = bn(lin(x))
            if masks is not None:
                x = torch.where(masks[i], x / (1.0 - self.dropout),
                                torch.zeros_like(x))
        return x

    def forward(self, abd, tnf, gen):
        x = torch.cat([abd, tnf], dim=1)
        masks = None
        if self.training:
            n, keep = x.shape[0], 1.0 - self.dropout
            masks = [torch.rand((n, h), generator=gen, device=x.device) < keep
                     for h in self.hidden + self.hidden[::-1]]
        nh = len(self.hidden)
        h = self._stack(self.enc, self.enc_bn, x,
                        None if masks is None else masks[:nh])
        mu = self.mu(h)
        logsigma = F.softplus(self.sigma(h))
        noise = torch.randn(mu.shape, generator=gen, device=mu.device)
        z = mu + noise * torch.exp(logsigma / 2.0)
        d = self._stack(self.dec, self.dec_bn, z,
                        None if masks is None else masks[nh:])
        out = self.out(d)
        return (F.softmax(out[:, :self.abd_dim], dim=1),
                F.softmax(out[:, self.abd_dim:], dim=1), mu, logsigma)

    def embed(self, abd, tnf):
        self.eval()
        h = self._stack(self.enc, self.enc_bn, torch.cat([abd, tnf], 1), None)
        return self.mu(h)


def _l1(x: np.ndarray) -> np.ndarray:
    s = np.abs(x).sum(axis=1, keepdims=True)
    return x / np.where(s == 0, 1.0, s)


def latent(names: np.ndarray, abd: np.ndarray, tnf: np.ndarray,
           binning: dict, device, precision: str = "float32"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(barcodes, mu) in the order the latent dump writes them."""
    seed = int(binning["seed"])
    abd_l1 = _l1(abd.astype(np.float64))
    weights = abd_l1.max(axis=1) ** 2
    p = weights / weights.sum()
    a32 = torch.from_numpy(abd_l1.astype(np.float32)).to(device)
    t32 = torch.from_numpy(_l1(tnf.astype(np.float64)).astype(np.float32)
                           ).to(device)
    n = len(names)
    model = VAE(abd.shape[1], tnf.shape[1], binning["hidden"],
                binning["latent"], binning["dropout"],
                torch.Generator().manual_seed(seed),
                tf32=precision == "tf32").to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    opt = torch.optim.Adam(model.parameters(), lr=binning["lr"],
                           betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=binning["weight_decay"])
    abd_dim, tnf_dim, lat = abd.shape[1], tnf.shape[1], binning["latent"]
    wa = binning["weight_alpha"] * 100.0 / math.log(abd_dim)
    wt = (1.0 - binning["weight_alpha"]) * 100.0 / math.log(tnf_dim)
    wkl = binning["weight_kl"] * 100.0 / lat

    def loss(rows):
        abd_rec, tnf_rec, mu, ls = model(a32[rows], t32[rows], gen)
        ce_a = -(torch.log(abd_rec + 1e-9) * a32[rows]).sum(-1)
        ce_t = -(torch.log(tnf_rec + 1e-9) * t32[rows]).sum(-1)
        kl = -0.5 * (1 + ls - mu.square() - torch.exp(ls)).sum(-1)
        return wa * ce_a.mean() + wt * ce_t.mean() + wkl * kl.mean()

    rng = np.random.RandomState(seed)
    bsz = min(int(binning["batch"]), n)
    if -(-n // bsz) > 100:
        raise ValueError("the reference evaluates once per epoch, as the "
                         "program does up to 100 batches an epoch")
    val_size = min(int(n * 0.7), 1_000_000)
    delta = np.float32(1e-6)
    best_score, best, counter = np.float32(-np.inf), None, 0
    for _ in range(int(binning["epochs"])):
        tidx = rng.choice(n, size=n, p=p, replace=True).astype(np.int32)
        vidx = rng.choice(n, size=val_size, p=p, replace=False
                          ).astype(np.int32)
        model.train()
        for lo in range(0, n, bsz):
            rows = torch.from_numpy(tidx[lo:lo + bsz]).to(device, torch.int64)
            total = loss(rows)
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
        model.eval()
        with torch.no_grad():
            totals = [loss(torch.from_numpy(vidx[lo:lo + bsz]).to(
                device, torch.int64)) for lo in range(0, val_size, bsz)]
            val = np.float32(torch.stack(totals).mean().item())
        if not (np.float32(-val) - best_score) <= delta:
            best_score, counter = np.float32(-val), 0
            best = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            counter += 1
            if counter >= int(binning["patience"]):
                break
    if best is not None:
        model.load_state_dict(best)
    order = torch.from_numpy(rng.permutation(n).astype(np.int32)
                             ).to(device, torch.int64)
    with torch.no_grad():
        mu = torch.cat([model.embed(a32[r], t32[r])
                        for r in order.split(bsz)])
    return names[order.cpu().numpy()], mu.cpu().numpy()


# ---- step 3 -----------------------------------------------------------------

def centroid_excess(x: np.ndarray, labels: np.ndarray) -> float:
    """Largest amount by which a point's squared distance to its own
    cluster's mean exceeds that to the nearest mean, over the mean of the
    nearest squared distances. 0 at a k-means fixed point."""
    x = x.astype(np.float64)
    ids, lab = np.unique(labels, return_inverse=True)
    cent = np.zeros((len(ids), x.shape[1]))
    np.add.at(cent, lab, x)
    cent /= np.bincount(lab, minlength=len(ids))[:, None]
    d = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    own = d[np.arange(len(x)), lab]
    near = d.min(1)
    return float((own - near).max() / near.mean())
