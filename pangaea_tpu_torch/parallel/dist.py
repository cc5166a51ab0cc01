"""Data-parallel versions of the hot paths over ``torch.distributed``.

Port of pangaea_tpu/parallel/dist.py. pangaea_tpu drives a ('data',)
mesh from one process with ``shard_map``/GSPMD; here each rank is one
process on one device (``parallel.mesh``), holds its rows, and the
cross-rank steps are explicit collectives on the group — NCCL on the
card, gloo on the CPU:

1. feature extraction — every rank streams the same input and keeps its
   rows of each batch (:class:`ShardedFeatureExtractor`); the global
   k-mer table is sharded by KEY RANGE and each batch's window keys are
   routed to their owning rank (:func:`make_sharded_kmer_counter`:
   ``all_gather`` or ``all_to_all``); the sort-join routes one (key,
   local run length or local weight sum) pair per distinct key to the
   key's owner, which joins them and sends the bins back
   (:func:`make_sharded_sortjoin`).
2. VAE training — the rows of every batch are split over the ranks;
   BatchNorm's two passes and the loss means are sums over the ranks,
   the gradients are summed by ``all_reduce``, and the parameters, Adam
   and the early-stop state stay replicated
   (:func:`sharded_train_block`, :func:`sharded_unit_chunk`).
3. final k-means — X rows are split, the centres replicated; the cluster
   counts, sums and inertia are summed by ``all_reduce``
   (:func:`sharded_lloyd`).

Every branch that stops or steers a loop (Lloyd's convergence, an empty
cluster's relocation, the fused loop's stop, a spill) reads a value that
is the same on every rank — a reduced value, or one computed from input
that every rank reads — so no rank waits alone in a collective.

pangaea_tpu's routing buckets have a fixed capacity (its
``capacity_factor``) and count an overflow, for XLA's static shapes.
``all_to_all_single`` takes exchanged split sizes, so the port routes
exactly and never overflows: it has no capacity to set, and the overflow
output stays, always 0, so callers keep their shape.

Every function takes the group (the default group when None) and the
rank's device (``cuda:<local rank>`` unless the caller asks for the CPU);
a CUDA device on a non-NCCL group raises, and so does a CPU device on an
NCCL group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pangaea_tpu_torch.config import FeatureConfig
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.kernels import scan
from pangaea_tpu_torch.kernels.encode import (canonical_kmers,
                                              kmer_window_values)
from pangaea_tpu_torch.kernels.features import (_run_flags, _run_ids,
                                                _run_weight_sums,
                                                kmer_key_sentinel,
                                                sortjoin_bins_weighted)
from pangaea_tpu_torch.parallel.mesh import (Group, check_backend,
                                             data_group, rank_device)
from pangaea_tpu_torch.parallel.multihost import gather_rows
from pangaea_tpu_torch.utils import DeviceLike

_M32 = 0xFFFFFFFF


def _setup(group: Group, device: DeviceLike):
    g = data_group(group)
    dev = rank_device(device)
    check_backend(g, dev)
    return g, dev, dist.get_rank(g), dist.get_world_size(g)


def _all_gather(g, t: torch.Tensor) -> list:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
    dist.all_gather(out, t.contiguous(), group=g)
    return out


def _all_sum(g, t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


def _route(g, send: torch.Tensor, send_counts: list, recv_counts: list
           ) -> torch.Tensor:
    """``all_to_all_single`` with exact split sizes."""
    out = send.new_empty(sum(recv_counts))
    dist.all_to_all_single(out, send.contiguous(), recv_counts, send_counts,
                           group=g)
    return out


def _split_sizes(g, send_counts: torch.Tensor):
    """(send, receive) split sizes as host lists: each rank's counts per
    destination, exchanged."""
    recv = torch.empty_like(send_counts)
    dist.all_to_all_single(recv, send_counts, group=g)
    return send_counts.tolist(), recv.tolist()


# ---- the global table, sharded by key range (k <= 15) ----------------------


def make_sharded_kmer_counter(group: Group, k: int, overlap: int,
                              route: str = "auto",
                              device: DeviceLike = None):
    """Global k-mer counting with the (4^k,) int32 table SHARDED by key
    range: rank r owns keys [r * S, (r + 1) * S), S = ceil(4^k / world).

    Scattering into a replicated table would all-reduce the whole table
    every batch (4 GiB at k = 15); the batch's window keys move instead:

    - ``all_to_all``: each rank sorts its keys by owner and routes each
      owner exactly its keys (``all_to_all_single`` with exchanged split
      sizes), so every rank scatter-adds only its own keys;
    - ``all_gather``: every rank gathers all ranks' keys (equal lengths:
      every rank holds the same number of rows) and keeps its range.

    ``auto`` takes pangaea_tpu's choice: ``all_to_all`` past 4 ranks.
    Returns (init_table, step, unshard, (lo, hi)):
    ``step(table, codes, lengths, cont) -> (table, overflow)`` adds this
    rank's rows of one batch to the table (in place; overflow is always
    0), ``unshard(table)`` returns the whole (4^k,) table on every rank,
    and (lo, hi) is this rank's key range. No scan kernel runs here."""
    if k > 15:
        raise ValueError(f"k={k}: the dense 4^k table exists for k <= 15 "
                         "only; larger k runs the sort-join")
    g, dev, r, world = _setup(group, device)
    total = 4 ** k
    shard = -(-total // world)
    padded = shard * world
    lo = r * shard
    if route == "auto":
        route = "all_to_all" if world > 4 else "all_gather"
    if route not in ("all_to_all", "all_gather"):
        raise ValueError(f"unknown route {route!r}")

    def _indices(codes, lengths, cont):
        skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
        vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
        canon = canonical_kmers(vals, k).to(torch.int64)
        return torch.where(valid, canon, padded).reshape(-1)

    def _add(table, keys):
        local = keys - lo
        local = local[(local >= 0) & (local < shard)]
        table.index_add_(0, local, torch.ones_like(local, dtype=torch.int32))

    def step(table, codes, lengths, cont):
        idx = _indices(codes, lengths, cont)
        if route == "all_gather":
            _add(table, torch.cat(_all_gather(g, idx)))
        else:
            idx = idx[idx < padded]
            owner = idx // shard
            idx = idx[torch.argsort(owner, stable=True)]
            sc, rc = _split_sizes(g, torch.bincount(owner, minlength=world))
            _add(table, _route(g, idx, sc, rc))
        return table, torch.zeros(1, dtype=torch.int32, device=dev)

    def init_table():
        return torch.zeros(shard, dtype=torch.int32, device=dev)

    def unshard(table):
        if world == 1:
            return table[:total]
        return torch.cat(_all_gather(g, table))[:total]

    return init_table, step, unshard, (lo, lo + shard)


# ---- the routed sort-join ----------------------------------------------------


def _owner(keys: torch.Tensor, k: int, world: int) -> torch.Tensor:
    """Owner rank of each key: pangaea_tpu's multiplicative hash, its
    high half mapped onto [0, world) — of the int32 key at k <= 15, of
    the (hi, lo) words at k = 16..31 (dist.py:228-236, :354-359), so the
    routed-pair counts equal pangaea_tpu's."""
    x = keys.to(torch.int64)
    if k <= 15:
        h = (x * 2654435761) & _M32
    else:
        hi, lo = x >> 32, x & _M32
        h = ((hi * 2654435761) & _M32) ^ ((lo * 40503) & _M32) ^ (lo >> 16)
    return ((h >> 16) * world) >> 16


def make_sharded_sortjoin(group: Group, k: int, window: int,
                          vector_size: int, with_stats: bool = False,
                          weighted: bool = False,
                          device: DeviceLike = None):
    """Distributed sort-join: per-window global-count bins of every
    rank's keys without a global sort or gathered key array.

    Equal keys must meet on one rank to be counted, so each key has an
    owner (:func:`_owner`). Routing is RUN-LENGTH COMPRESSED: each rank
    sorts its keys and routes one (key, local run length) pair per
    distinct key — genomic k-mer multiplicities are Zipfian, and routing
    every instance would pile a hot key's load onto its owner. The owner
    joins what it receives with the port's weighted sort-join
    (``sortjoin_bins_weighted``: the CUDA cumsum of its run ids, int64
    run sums), sends each pair's bin back, and each rank fills the bins
    forward through its local runs (the CUDA cummax of the run starts).

    ``weighted`` (the quality-masked paired join): the routed value is
    the run's local WEIGHT SUM, formed in int64 by run id — never an
    int32 cumsum, which wraps once a call's weights pass 2^31 - 1 — and
    summed in int64 by the owner, whose ``count > 0`` check reproduces
    the absent-from-masked-dump skip.

    One function serves int32 keys (k <= 15) and int64 keys (k = 16..31).
    Returns (bins_fn, group): ``bins_fn(keys[, weights])`` maps this
    rank's (N,) keys (sentinel 4^k = invalid), on its device, to
    (bins, overflow) with bins int32 in the keys' order (-1 = no
    contribution) and overflow always 0. ``with_stats`` adds the
    (world, world) int64 routed-pair matrix [source, dest]."""
    g, dev, r, world = _setup(group, device)
    sent = kmer_key_sentinel(k)

    def bins_fn(keys, weights=None):
        if (weights is not None) != weighted:
            raise TypeError("bins_fn takes (keys, weights) when weighted, "
                            "else (keys)")
        if keys.device != dev:
            raise ValueError(f"keys on {keys.device}, the join runs on "
                             f"{dev}")
        n = keys.numel()
        sk, si = torch.sort(keys, stable=True)
        start, _ = _run_flags(sk)
        starts = torch.nonzero(start).squeeze(1)
        if weighted:
            run_val = (_run_weight_sums(weights[si], _run_ids(start))
                       if n else starts.new_zeros(0))
        else:
            run_val = torch.diff(starts, append=starts.new_full((1,), n))
        ukeys = sk[starts]
        routed = torch.nonzero(ukeys < sent).squeeze(1)
        owner = _owner(ukeys[routed], k, world)
        routed = routed[torch.argsort(owner, stable=True)]
        send_counts = torch.bincount(owner, minlength=world)
        sc, rc = _split_sizes(g, send_counts)
        rkeys = _route(g, ukeys[routed], sc, rc)
        rvals = _route(g, run_val[routed], sc, rc)
        if rkeys.numel():
            rbins = sortjoin_bins_weighted(rkeys, rvals, k=k, window=window,
                                           vector_size=vector_size)
        else:
            rbins = torch.empty(0, dtype=torch.int32, device=dev)
        back = _route(g, rbins, rc, sc)
        bins = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if n:
            start_bins = torch.full_like(bins, -1)
            start_bins[starts[routed]] = back
            pos = torch.arange(n, dtype=torch.int32, device=dev)
            run_start = scan.cummax(torch.where(start, pos, 0))
            bins[si] = start_bins[run_start.long()]
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        if with_stats:
            return bins, overflow, torch.stack(_all_gather(g, send_counts))
        return bins, overflow

    return bins_fn, g


# pangaea_tpu's split-word (k = 16..31) twin: the port's keys are int64
# at every k > 15, so one function serves both
make_sharded_sortjoin_pair = make_sharded_sortjoin


class ShardedFeatureExtractor(FeatureExtractor):
    """Step 1 with every batch's rows split over the group's ranks.

    Every rank streams the same input (the counterpart of pangaea_tpu's
    one stream with sharded rows) and keeps rows [r R / W, (r + 1) R / W)
    of each R-row batch; ``reads_per_batch`` is rounded up to a multiple
    of the world size W on a copy of the config. The sort-join's window
    cap scales with W (each rank holds about 1/W of the windows), its
    joins run through :func:`make_sharded_sortjoin`, the dense-table
    paths count through :func:`make_sharded_kmer_counter`, the group
    histograms are summed over the ranks, and rank 0 alone writes the
    CSVs and the step marker. Past the scaled cap it keeps pangaea_tpu's
    raw spill (``_spill_aggregate = False``): the stream is read once and
    each key range is joined through the routed join, every rank joining
    every range. The feature directory should be one all ranks see: a run
    resumes only when every rank finds both CSVs."""

    _spill_aggregate = False

    def __init__(self, cfg: FeatureConfig, feature_dir: str,
                 group: Group = None, device: DeviceLike = None):
        g, dev, rank, world = _setup(group, device)
        if cfg.reads_per_batch % world:
            cfg = dataclasses.replace(
                cfg, reads_per_batch=cfg.reads_per_batch + world
                - cfg.reads_per_batch % world)
        super().__init__(cfg, feature_dir, device=dev)
        self.group, self.rank, self.world = g, rank, world
        self._joins = {}  # weighted -> bins_fn, built on first use

    def _row_span(self):
        per = self.cfg.reads_per_batch // self.world
        return self.rank * per, (self.rank + 1) * per

    def _device_batch(self, host):
        lo, hi = self._row_span()
        return self._upload(tuple(t[lo:hi] for t in host))

    def _local_rows(self, rows: int) -> int:
        lo, hi = self._row_span()
        return min(max(rows - lo, 0), hi - lo)

    def _sortjoin_window_cap(self) -> int:
        return self.cfg.sortjoin_max_windows * self.world

    def _sortjoin_pad_size(self, n: int) -> int:
        return n  # the routed join takes any length

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _all_sum(self.group, t)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_rows(t, self.group)

    def _bins(self, keys, weights):
        weighted = weights is not None
        if weighted not in self._joins:
            c = self.cfg
            self._joins[weighted] = make_sharded_sortjoin(
                self.group, c.kmer, c.window_size, c.vector_size,
                weighted=weighted, device=self.device)[0]
        fn = self._joins[weighted]
        bins, _ = fn(keys, weights) if weighted else fn(keys)
        return bins

    def global_kmer_table(self, reads1: str = "", reads2: str = "",
                          interleaved: str = "") -> torch.Tensor:
        """The global pass on the key-range-sharded counter; returns the
        whole (4^k,) table on every rank (the group pass indexes it with
        global keys)."""
        c = self.cfg
        init_table, step, unshard, _ = make_sharded_kmer_counter(
            self.group, c.kmer, c.kmer - 1, device=self.device)
        table = init_table()
        for codes, lengths, _, cont in self._global_batches(
                reads1, reads2, interleaved):
            table, _ = step(table, codes, lengths, cont)
        return unshard(table)

    def _features_exist(self) -> bool:
        here = torch.tensor([int(super()._features_exist())],
                            device=self.device)
        return int(self._reduce(here)) == self.world

    def _save(self, names, abd, tnf) -> None:
        if self.rank == 0:
            super()._save(names, abd, tnf)


# ---- VAE training with the batch rows split -------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the group: the backward pass sums the
    gradients over the ranks too (the gradient of every rank's loss with
    respect to this rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_sum(group, x)

    @staticmethod
    def backward(ctx, grad):
        return _all_sum(ctx.group, grad), None


@dataclasses.dataclass
class _RowShard:
    """A batch's rows split over the group's ranks in rank order: rank r
    runs rows [r n / W, (r + 1) n / W) (a 17-row batch over 3 ranks is
    5 + 6 + 6 rows)."""

    group: dist.ProcessGroup
    rank: int
    world: int

    def span(self, n: int):
        return self.rank * n // self.world, (self.rank + 1) * n // self.world

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return _all_sum(self.group, t)

    @contextlib.contextmanager
    def batchnorm(self, model):
        from pangaea_tpu_torch.model.vae import BatchNorm
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        for m in bns:
            m.row_reduce = lambda t: _AllReduceSum.apply(t, self.group)
        try:
            yield
        finally:
            for m in bns:
                del m.row_reduce

    def sum_grads(self, model) -> None:
        """Sum every parameter's gradient over the ranks (one flat
        all_reduce)."""
        params = [p for p in model.parameters() if p.requires_grad]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()


def _trainer_shard(trainer, group: Group, device: DeviceLike) -> _RowShard:
    g, dev, rank, world = _setup(group, device or trainer.device)
    if dev.type != trainer.device.type:
        raise ValueError(f"the trainer runs on {trainer.device}, the "
                         f"group's rank on {dev}")
    return _RowShard(g, rank, world)


def sharded_train_block(trainer, group: Group = None,
                        device: DeviceLike = None):
    """The trainer's train steps with every batch's rows split over the
    group (pangaea_tpu's ``sharded_train_block``). Returns
    ``block(opt, gen, abd_all, tnf_all, idx, counts, draws=None)``: one
    Adam step per batch ``idx[j, :counts[j]]`` on the replicated model
    and optimiser (in place), the mean (4,) loss stats returned. Masks
    and noise are drawn for the whole batch from ``gen`` (the same
    generator state on every rank), or taken in order from the
    ``draws`` iterator of (masks, noise)."""
    shard = _trainer_shard(trainer, group, device)

    def block(opt, gen, abd_all, tnf_all, idx, counts, draws=None):
        trainer.model.train()
        stats = [trainer._train_batch(
            opt, gen, abd_all, tnf_all,
            torch.as_tensor(idx[j][:cnt]).to(trainer.device, torch.int64),
            shard, draws) for j, cnt in enumerate(counts)]
        return torch.stack(stats).mean(0)

    return block


def sharded_unit_chunk(trainer, group: Group = None,
                       device: DeviceLike = None):
    """The fused loop's units with every batch's rows split over the
    group (pangaea_tpu's ``sharded_unit_chunk``). Returns
    ``chunk(es, opt, gen, abd_all, tnf_all, uidx, ucnt, ulive, vidx,
    vcnt, draws=None) -> (C, 8) rows``: unit i trains on the batches
    ``uidx[i, j, :ucnt[i, j]]`` with ``ucnt[i, j] > 0``, runs the val
    pass over ``vidx[i]`` (``vcnt`` rows per batch) and steps the
    EarlyStopping state ``es`` (``model.train.FusedState``, replicated).
    A unit that is not live, or comes after the stop, is held: it trains
    nothing and its row is [0 x 6, stopped, 0], as pangaea_tpu's. The
    stop is read from the replicated state, so every rank holds the same
    units."""
    shard = _trainer_shard(trainer, group, device)

    def chunk(es, opt, gen, abd_all, tnf_all, uidx, ucnt, ulive, vidx,
              vcnt, draws=None):
        dev = trainer.device
        uidx = torch.as_tensor(uidx).to(dev, torch.int64)
        vidx = torch.as_tensor(vidx).to(dev, torch.int64)
        ucnt = np.asarray(ucnt)
        rows = torch.zeros((len(ulive), 8), dtype=torch.float32, device=dev)
        for i, live in enumerate(np.asarray(ulive)):
            if not live or bool(es.stopped):
                rows[i, 6] = es.stopped.float()
                continue
            real = np.flatnonzero(ucnt[i] > 0)
            rows[i], _ = trainer._run_unit(
                es, opt, gen, abd_all, tnf_all, ucnt[i][real].tolist(),
                uidx[i][torch.from_numpy(real).to(dev)], vidx[i],
                [int(c) for c in vcnt], shard, draws)
        return rows

    return chunk


# ---- k-means Lloyd with the rows split ------------------------------------


def sharded_lloyd(group: Group = None, max_iter: int = 300,
                  device: DeviceLike = None):
    """kmeans Lloyd (``cluster.kmeans._lloyd``) with X's rows split over
    the group and the centres replicated. Returns
    ``lloyd(X, W, C0, tol_eff) -> (centres, labels, inertia, n_iter)``
    over this rank's rows X (n_r, d) and weights W (n_r,): the per-cluster
    weight sums and weighted point sums are summed by one ``all_reduce``
    per iteration, the labels are this rank's, the inertia is global. An
    empty cluster takes the same point the one-device fit gives it: each
    rank offers its farthest points, ranked by (-distance, global row),
    through an ``all_gather``, and the global top e are the one-device
    stable ranking's first e."""
    from pangaea_tpu_torch.cluster.kmeans import _dist2
    g, dev, rank, world = _setup(group, device)

    def relocate(X, C, counts, offset):
        empty = counts == 0
        e = int(empty.sum())  # reduced counts: the same on every rank
        if e == 0:
            return C
        inf = torch.full_like(counts, float("inf"))
        d = _dist2(X, C) + torch.where(empty, inf,
                                       torch.zeros_like(counts))[None]
        mind = d.min(dim=1).values
        top = torch.argsort(-mind, stable=True)[:e]
        m = top.numel()
        cand_d = torch.full((e,), float("-inf"), device=dev)
        cand_i = torch.full((e,), torch.iinfo(torch.int64).max,
                            dtype=torch.int64, device=dev)
        cand_x = torch.zeros((e, X.shape[1]), dtype=X.dtype, device=dev)
        cand_d[:m], cand_i[:m], cand_x[:m] = mind[top], top + offset, X[top]
        all_d = torch.cat(_all_gather(g, cand_d))
        all_i = torch.cat(_all_gather(g, cand_i))
        all_x = torch.cat(_all_gather(g, cand_x))
        by_row = torch.argsort(all_i, stable=True)
        order = by_row[torch.argsort(-all_d[by_row], stable=True)][:e]
        erank = torch.cumsum(empty.to(torch.int64), 0) - 1
        far = all_x[order][erank.clamp(0, e - 1)]
        return torch.where(empty[:, None], far, C)

    def lloyd(X, W, C0, tol_eff):
        for t in (X, W, C0):
            if t.device != dev:
                raise ValueError(f"a tensor on {t.device}, the fit runs on "
                                 f"{dev}")
        ns = [int(c) for c in _all_gather(g, torch.tensor(
            [X.shape[0]], dtype=torch.int64, device=dev))]
        offset = sum(ns[:rank])
        k = C0.shape[0]
        C = C0.to(torch.float32)
        shift = torch.tensor(float("inf"), device=dev)
        it = 0
        while it < max_iter and bool(shift > tol_eff):
            assign = torch.argmin(_dist2(X, C), dim=1)
            stats = torch.zeros((k, 1 + C.shape[1]), dtype=X.dtype,
                                device=dev)
            stats[:, :1].index_add_(0, assign, W[:, None])
            stats[:, 1:].index_add_(0, assign, X * W[:, None])
            stats = _all_sum(g, stats)
            counts, sums = stats[:, 0], stats[:, 1:]
            newC = sums / torch.where(counts > 0, counts,
                                      torch.ones_like(counts))[:, None]
            newC = relocate(X, newC, counts, offset)
            shift = (newC - C).square().sum()
            C = newC
            it += 1
        d = _dist2(X, C)
        assign = torch.argmin(d, dim=1).to(torch.int32)
        inertia = _all_sum(g, (d.min(dim=1).values * W).sum())
        return C, assign, inertia, it

    return lloyd
