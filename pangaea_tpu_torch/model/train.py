"""VAE training loop: device-resident data, eval cadence, early stop.

Port of pangaea_tpu/model/train.py. Behavior contract (reference
src/models/VAENET.py:31-159 + src/utils.py:26-52):

- Adam(lr, weight_decay) with torch's coupled L2 (decay added to the grad
  before the moment update) (VAENET.py:39) — ``torch.optim.Adam`` with
  ``weight_decay`` is exactly that, and matches the optax chain
  add_decayed_weights -> scale_by_adam -> scale(-lr) of the JAX package.
- every ``eval_every_batches`` train batches: a full val pass; early
  stopping on the mean of per-batch val totals, delta 1e-6
  (VAENET.py:64-91). The val forward runs in eval mode (no dropout,
  running BN stats) but *does* sample the latent noise (VAENET.py:227).
- at epoch end a val pass + early() happens only when the number of train
  batches is not a multiple of the cadence (VAENET.py:111-115).
- the checkpoint written on each val improvement is the one reloaded for
  the latent dump (utils.py:50-52, VAENET.py:131); the latent is mu only,
  in shuffled order, with barcodes saved in matching order
  (VAENET.py:126-144).

Two loops, as in pangaea_tpu (train.py:352-361): the fused loop by
default, the stepwise loop with ``PANGAEA_TRAIN_LOOP=stepwise``. The
stepwise loop (``_fit_stepwise``) is the executable spec: it reads each
val loss on the host, runs the host EarlyStopping, uploads each batch's
row indices and pickles a checkpoint on every improvement. The fused
loop (``_fit_fused``, pangaea_tpu's ``_fit_fused`` :363-547) runs
"units" — one train interval and its val pass — in chunks, and is
bit-identical to it in every observable: val losses, stop unit, best
state, checkpoint bytes and the host ``RandomState`` afterwards.

- A chunk's train and val indices are built on the host from the same
  ``RandomState`` calls in the same order, and uploaded once, from
  pinned memory. Padded batches are skipped on the host, where their
  counts are, so the ``torch.Generator`` makes the stepwise loop's draws.
- The EarlyStopping state (best score float32, counter, stopped) and the
  best state, packed into one flat buffer, stay on the device. The
  decision is ``(score - best) <= float32(delta)`` in float32; the host
  compares ``score < best + delta`` in float64 on float32 values. Near
  the threshold the subtraction is Sterbenz-exact, no float32 lies
  strictly between float32(1e-6) and 1e-6, and NaN and -inf take the
  same branch in both forms (pangaea_tpu train.py:37-43), so the
  decisions agree bit for bit.
- Each unit writes one (8,) row — val loss, four train stats, improved,
  stopped, ran — and the host reads the chunk's (C, 8) block once.
- After a stop, the host stops launching units as soon as a non-blocking
  copy of a unit's stop flag has landed (a unit or two late on the
  card). Units launched meanwhile are masked: they change neither the
  best state nor the EarlyStopping state, and their rows say they did
  not run.
- The host rng is rolled back to the snapshot taken after the stop
  unit's val draw, so ``dump_latent`` sees the stepwise stream.
- When a chunk improved, its best state is copied to pinned host memory
  behind the chunk's work and pickled after the next chunk is launched.

Random streams: the host ``RandomState`` draws (epoch sampling, val
sampling, the latent permutation) are the JAX package's calls in its
order, so batches, val sets and latent order match its run exactly.
Dropout masks and latent noise come from a ``torch.Generator`` on the
device seeded from ``ModelConfig.seed``; they cannot match ``jax.random``.
Weights are initialised on the CPU from ``ModelConfig.seed`` and moved,
so the initial model is the same on every device.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pangaea_tpu_torch.config import ModelConfig
from pangaea_tpu_torch.model.dataset import BarcodeDataset, batch_index_matrix
from pangaea_tpu_torch.model.vae import VAE, embed, loss_weights, unlabeled_loss
from pangaea_tpu_torch.utils import (DeviceLike, replacing, resolve_device,
                                     setup_numerics)

log = logging.getLogger(__name__)

StateDict = Dict[str, np.ndarray]


class EarlyStopping:
    """utils.py:26-52: tracks the best val loss, saves via callback."""

    def __init__(self, patience: int = 7, delta: float = 0.0,
                 save_fn=None):
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = np.inf
        self.save_fn = save_fn or (lambda: None)

    def __call__(self, val_loss: float) -> None:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            self._save(val_loss)
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self._save(val_loss)
            self.counter = 0

    def _save(self, val_loss: float) -> None:
        self.save_fn()
        self.val_loss_min = val_loss


def host_state(model: torch.nn.Module) -> StateDict:
    """The model's state dict as host numpy arrays (a snapshot)."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def save_params(path: str, state: StateDict) -> None:
    """Write-then-rename pickle of a host state dict."""
    with replacing(path) as tmp, open(tmp, "wb") as f:
        pickle.dump(state, f)


def load_params(path: str) -> StateDict:
    """Read a checkpoint written by :func:`save_params` (this program's
    own files only: unpickling runs code)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def load_into(model: torch.nn.Module, state: StateDict) -> None:
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})


def chunk_units(total_units: int, U: int, vnb: int, bsz: int) -> int:
    """Units per chunk of the fused loop: pangaea_tpu's (train.py:403-405),
    so both draw ahead by the same units — at most 512 train batches and
    about 48 MB of int32 indices a chunk."""
    per_unit_elems = (U + vnb) * bsz
    return max(1, min(total_units, 512 // max(1, U) or 1,
                      (48 << 20) // (4 * per_unit_elems) or 1))


class _StopFlags:
    """Each unit's stop flag, copied to the host without blocking; the
    host reads a flag once its copy has landed."""

    def __init__(self, n: int, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.bool, pin_memory=cuda)
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(n)]

    def put(self, i: int, flag: torch.Tensor) -> None:
        self.host[i].copy_(flag, non_blocking=True)
        if self.events[i] is not None:
            self.events[i].record()

    def landed(self, i: int) -> bool:
        return self.events[i] is None or self.events[i].query()


def flat_state(model: torch.nn.Module) -> torch.Tensor:
    """The model's state dict as one flat device tensor."""
    return torch.cat([v.reshape(-1) for v in model.state_dict().values()])


class FusedState:
    """The fused loop's device state: the EarlyStopping state (best score
    float32, counter, stopped) and the best state dict, flat."""

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig,
                 device: torch.device):
        self.best_flat = torch.zeros_like(flat_state(model))
        self.best_score = torch.tensor(-np.inf, dtype=torch.float32,
                                       device=device)
        self.counter = torch.zeros((), dtype=torch.int32, device=device)
        self.stopped = torch.zeros((), dtype=torch.bool, device=device)
        self.delta32 = torch.tensor(np.float32(cfg.early_stop_delta),
                                    device=device)


class VAETrainer:
    def __init__(self, model: VAE, cfg: ModelConfig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        setup_numerics()
        self.model = model.to(self.device)
        self.cfg = cfg
        self.wa, self.wt, self.wkl = loss_weights(
            model, cfg.weight_alpha, cfg.weight_kl)
        self.val_history = []  # (epoch, done_batches, val_loss) per eval
        # per-fit phase timers (seconds) of the fused loop
        self.phase_times: Dict[str, float] = {}

    def optimizer(self) -> torch.optim.Adam:
        """Adam with torch's coupled L2 over the model's parameters."""
        return torch.optim.Adam(self.model.parameters(), lr=self.cfg.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.cfg.weight_decay)

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + offset)

    def _losses(self, gen, abd_all, tnf_all, rows, shard=None, draws=None
                ) -> Dict[str, torch.Tensor]:
        """The loss terms of one forward pass over the batch ``rows``
        (device int64 indices) in the model's current mode. With a
        ``shard`` (``parallel.dist``'s data-parallel rows) this rank runs
        its rows of the batch, with the masks and noise drawn for the
        whole batch (or taken from the ``draws`` iterator) and BatchNorm
        summed over the ranks, and each term is its share of the global
        mean."""
        model = self.model
        if shard is None:
            out = model(abd_all[rows], tnf_all[rows], generator=gen)
            return unlabeled_loss(out, model, self.wa, self.wt, self.wkl)
        n = rows.numel()
        masks, noise = (next(draws) if draws is not None else
                        model.draws(n, self.device, gen, model.training))
        lo, hi = shard.span(n)
        local = rows[lo:hi]
        with shard.batchnorm(model):
            out = model(abd_all[local], tnf_all[local], noise=noise[lo:hi],
                        drop_masks=None if masks is None
                        else [m[lo:hi] for m in masks])
        return unlabeled_loss(out, model, self.wa, self.wt, self.wkl,
                              denom=n)

    def _train_batch(self, opt, gen, abd_all, tnf_all, rows, shard=None,
                     draws=None) -> torch.Tensor:
        """One Adam step on the batch ``rows``; returns its (4,) loss
        stats (total, abd_rec, tnf_rec, kl_loss). With a ``shard`` the
        gradients and the stats are summed over the ranks before the
        step, so every rank takes the same step."""
        model = self.model
        losses = self._losses(gen, abd_all, tnf_all, rows, shard, draws)
        opt.zero_grad(set_to_none=True)
        losses["total"].backward()
        if shard is not None:
            shard.sum_grads(model)
        opt.step()
        stats = torch.stack([losses[k].detach() for k in
                             ("total", "abd_rec", "tnf_rec", "kl_loss")])
        return stats if shard is None else shard.sum(stats)

    def _val_total(self, gen, abd_all, tnf_all, vmat, vcounts, shard=None,
                   draws=None) -> torch.Tensor:
        """Mean over val batches of the per-batch loss totals (a 0-d
        float32 tensor on the device). ``vmat`` holds host or device
        row indices."""
        self.model.eval()
        totals = []
        with torch.no_grad():
            for bidx, cnt in zip(vmat, vcounts):
                if cnt == 0:
                    totals.append(torch.zeros((), device=self.device))
                    continue
                rows = torch.as_tensor(bidx[:cnt]).to(self.device,
                                                      torch.int64)
                total = self._losses(gen, abd_all, tnf_all, rows, shard,
                                     draws)["total"]
                totals.append(total if shard is None else shard.sum(total))
        return torch.stack(totals).mean()

    def _run_unit(self, es: "FusedState", opt, gen, abd_all, tnf_all,
                  counts, t_rows, v_rows, vcounts, shard=None, draws=None):
        """One unit of the fused loop — the train batches ``t_rows[j,
        :counts[j]]``, the val pass over ``v_rows`` and the EarlyStopping
        transition on the device state ``es`` (a unit launched after the
        stop changes nothing there). Returns the unit's (8,) row — val
        loss, four train stats, improved, stopped, ran — and its stop
        flag."""
        model, dev = self.model, self.device
        model.train()
        stats = torch.zeros(4, device=dev)
        for j, cnt in enumerate(counts):
            stats += self._train_batch(opt, gen, abd_all, tnf_all,
                                       t_rows[j, :cnt], shard, draws)
        val = self._val_total(gen, abd_all, tnf_all, v_rows, vcounts,
                              shard, draws)
        live = ~es.stopped
        improved = live & ~((-val - es.best_score) <= es.delta32)
        es.counter = torch.where(improved, 0, torch.where(
            live, es.counter + 1, es.counter))
        stop = live & ~improved & (es.counter >= self.cfg.patience)
        es.best_score = torch.where(improved, -val, es.best_score)
        es.best_flat = torch.where(improved, flat_state(model), es.best_flat)
        es.stopped = es.stopped | stop
        row = torch.cat([val[None], stats / len(counts),
                         torch.stack([improved, stop, live]).float()])
        return row, stop

    def fit(self, dataset: BarcodeDataset, model_dir: str,
            rng: Optional[np.random.RandomState] = None) -> StateDict:
        """Train (resumable); returns the best model's host state dict.

        The fused loop by default; ``PANGAEA_TRAIN_LOOP=stepwise`` runs
        the stepwise loop. Both give the same results (module
        docstring)."""
        if os.environ.get("PANGAEA_TRAIN_LOOP", "fused") == "stepwise":
            return self._fit_stepwise(dataset, model_dir, rng=rng)
        return self._fit_fused(dataset, model_dir, rng=rng)

    def _fit_stepwise(self, dataset: BarcodeDataset, model_dir: str,
                      rng: Optional[np.random.RandomState] = None
                      ) -> StateDict:
        """The reference host loop: one host read and EarlyStopping call
        per eval. Kept as the executable spec of the fused loop."""
        cfg, model = self.cfg, self.model
        rng = rng or np.random.RandomState(cfg.seed)
        os.makedirs(model_dir, exist_ok=True)
        ckpt = os.path.join(model_dir, "train_model.pk")
        if os.path.exists(ckpt):
            log.info("training model already saved")
            state = load_params(ckpt)
            load_into(model, state)
            return state

        opt = self.optimizer()
        gen = self._generator(1)
        abd_all = torch.from_numpy(dataset.abd).to(self.device)
        tnf_all = torch.from_numpy(dataset.tnf).to(self.device)
        best: Dict[str, Optional[StateDict]] = {"state": None}

        def save_best():
            best["state"] = host_state(model)
            save_params(ckpt, best["state"])

        early = EarlyStopping(patience=cfg.patience,
                              delta=cfg.early_stop_delta, save_fn=save_best)
        n = len(dataset)
        val_size = dataset.val_size(cfg.val_fraction, cfg.val_max)
        bsz = min(cfg.batch_size, n)
        nb_epoch = -(-n // bsz)
        ev = cfg.eval_every_batches

        def run_val() -> float:
            vidx = dataset.sample_indices(rng, val_size, replacement=False)
            vmat, vmask = batch_index_matrix(vidx, bsz)
            vcounts = vmask.sum(axis=(1, 2)).astype(np.int64)
            return float(self._val_total(gen, abd_all, tnf_all, vmat,
                                         vcounts))

        log.info("train start")
        self.val_history = []
        for epoch in range(1, cfg.epochs + 1):
            tidx = dataset.sample_indices(rng, n, replacement=True)
            tmat, tmask = batch_index_matrix(tidx, bsz)
            tcounts = tmask.sum(axis=(1, 2)).astype(np.int64)
            done = 0
            while done < nb_epoch and not early.early_stop:
                nb = min(ev, nb_epoch - done)
                model.train()
                stats = torch.zeros(4, device=self.device)
                for j in range(done, done + nb):
                    rows = torch.from_numpy(tmat[j, :tcounts[j]]).to(
                        self.device, torch.int64)
                    stats += self._train_batch(opt, gen, abd_all, tnf_all,
                                               rows)
                done += nb
                if nb == ev:  # the reference evals only on full cadences
                    val_loss = run_val()
                    self.val_history.append((epoch, done, val_loss))
                    t, a, tn, kl = (stats / nb).tolist()
                    log.info(
                        "epoch %d/%d batch %d/%d: train %.8f abd %.8f "
                        "tnf %.8f kl %.8f | test %.8f", epoch, cfg.epochs,
                        done, nb_epoch, t, a, tn, kl, val_loss)
                    early(val_loss)
            if early.early_stop:
                log.info("early stop triggered")
                break
            if nb_epoch % ev != 0:  # VAENET.py:111-115
                val_loss = run_val()
                self.val_history.append((epoch, nb_epoch, val_loss))
                early(val_loss)
                if early.early_stop:
                    log.info("early stop triggered")
                    break
        if not os.path.exists(ckpt):
            save_best()
        load_into(model, best["state"])
        return best["state"]

    def _fit_fused(self, dataset: BarcodeDataset, model_dir: str,
                   rng: Optional[np.random.RandomState] = None
                   ) -> StateDict:
        """The fused loop (module docstring): chunks of units, the
        EarlyStopping state and the best state on the device, one host
        read per chunk. ``phase_times`` holds the host seconds spent
        building chunks (``build``), launching their units
        (``dispatch``), waiting for their rows (``sync``) and saving
        checkpoints (``ckpt_io``), with the ``chunks`` and the ``units``
        launched."""
        cfg, model, dev = self.cfg, self.model, self.device
        rng = rng or np.random.RandomState(cfg.seed)
        os.makedirs(model_dir, exist_ok=True)
        ckpt = os.path.join(model_dir, "train_model.pk")
        if os.path.exists(ckpt):
            log.info("training model already saved")
            state = load_params(ckpt)
            load_into(model, state)
            return state

        opt = self.optimizer()
        gen = self._generator(1)
        abd_all = torch.from_numpy(dataset.abd).to(dev)
        tnf_all = torch.from_numpy(dataset.tnf).to(dev)
        cuda = dev.type == "cuda"

        n = len(dataset)
        val_size = dataset.val_size(cfg.val_fraction, cfg.val_max)
        bsz = min(cfg.batch_size, n)
        nb_epoch = -(-n // bsz)
        ev = cfg.eval_every_batches
        U = min(ev, nb_epoch)            # padded interval length
        upe = -(-nb_epoch // ev)         # units per epoch
        vnb = max(1, -(-val_size // bsz))
        total_units = cfg.epochs * upe
        counts_epoch = np.full(nb_epoch, bsz, np.int64)
        counts_epoch[-1] = n - (nb_epoch - 1) * bsz
        vcounts = np.zeros(vnb, np.int64)
        if val_size:
            vcounts[:] = bsz
            vcounts[-1] = val_size - (vnb - 1) * bsz
        C = chunk_units(total_units, U, vnb, bsz)

        # snapshots[g]: the rng state right after unit g's val draw (the
        # stepwise loop's stop point)
        snapshots: Dict[int, tuple] = {}

        def units():
            g = 0
            for epoch in range(1, cfg.epochs + 1):
                tidx = dataset.sample_indices(rng, n, replacement=True)
                tmat, _ = batch_index_matrix(tidx, bsz)
                for j in range(upe):
                    lo, hi = j * ev, min(j * ev + ev, nb_epoch)
                    vidx = dataset.sample_indices(rng, val_size,
                                                  replacement=False)
                    vmat, _ = batch_index_matrix(vidx, bsz)
                    snapshots[g] = rng.get_state()
                    yield (g, epoch, hi - lo, hi, tmat[lo:hi],
                           counts_epoch[lo:hi], vmat)
                    g += 1

        names = list(model.state_dict())
        shapes = [v.shape for v in model.state_dict().values()]
        es = FusedState(model, cfg, dev)
        rows_dev = torch.zeros((C, 8), dtype=torch.float32, device=dev)
        flags = _StopFlags(C, dev)
        best: Dict[str, Optional[StateDict]] = {"state": None}
        pending: list = []   # (pinned host copy, its event) to pickle

        def upload(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(a)
            if cuda:
                t = t.pin_memory()
            return t.to(dev, non_blocking=True).long()

        def drain_ckpt() -> None:
            if not pending:
                return
            t0 = time.perf_counter()
            host, done = pending.pop()
            if done is not None:
                done.synchronize()
            flat, state, off = host.numpy(), {}, 0
            for name, shape in zip(names, shapes):
                size = int(np.prod(shape, dtype=np.int64))
                state[name] = flat[off:off + size].reshape(shape).copy()
                off += size
            best["state"] = state
            save_params(ckpt, state)
            pt["ckpt_io"] += time.perf_counter() - t0

        pt = self.phase_times = {"build": 0.0, "dispatch": 0.0, "sync": 0.0,
                                 "ckpt_io": 0.0, "chunks": 0, "units": 0}
        self.val_history = []
        gen_units = units()
        done_units = 0
        stopped_at = None
        log.info("train start")
        while done_units < total_units and stopped_at is None:
            t0 = time.perf_counter()
            chunk = [next(gen_units)
                     for _ in range(min(C, total_units - done_units))]
            t_np = np.zeros((C, U, bsz), np.int32)
            v_np = np.zeros((C, vnb, bsz), np.int32)
            for i, (_, _, nb_u, _, tm, _, vm) in enumerate(chunk):
                t_np[i, :nb_u], v_np[i] = tm, vm
            t_idx, v_idx = upload(t_np), upload(v_np)
            rows_dev.zero_()
            pt["build"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            polled, halt = 0, False
            for i, (_, _, _, _, _, counts, _) in enumerate(chunk):
                # stop launching once an earlier unit's stop flag landed
                while polled < i and flags.landed(polled):
                    halt |= bool(flags.host[polled])
                    polled += 1
                if halt:
                    break
                rows_dev[i], stop = self._run_unit(
                    es, opt, gen, abd_all, tnf_all, counts, t_idx[i],
                    v_idx[i], vcounts)
                flags.put(i, stop)
                pt["units"] += 1
            pt["dispatch"] += time.perf_counter() - t0
            pt["chunks"] += 1

            drain_ckpt()  # the previous chunk's best, behind this chunk

            t0 = time.perf_counter()
            rows = rows_dev.cpu().numpy()   # one (C, 8) read
            pt["sync"] += time.perf_counter() - t0
            any_improved = False
            for i, (g, epoch, nb_u, done_b, *_) in enumerate(chunk):
                val, stats = rows[i, 0], rows[i, 1:5]
                improved, stop, ran = rows[i, 5:8] != 0
                if not ran:
                    break
                self.val_history.append((epoch, done_b, float(val)))
                if nb_u == ev:  # the reference logs full cadences only
                    t, a, tn, kl = stats
                    log.info(
                        "epoch %d/%d batch %d/%d: train %.8f abd %.8f "
                        "tnf %.8f kl %.8f | test %.8f", epoch, cfg.epochs,
                        done_b, nb_epoch, t, a, tn, kl, val)
                any_improved |= bool(improved)
                if stop:
                    stopped_at = g
                    break
            done_units += len(chunk)
            if any_improved:
                t0 = time.perf_counter()
                host = torch.empty(es.best_flat.shape,
                                   dtype=es.best_flat.dtype, pin_memory=cuda)
                host.copy_(es.best_flat, non_blocking=True)
                done = torch.cuda.Event() if cuda else None
                if cuda:
                    done.record()
                pending.append((host, done))
                pt["ckpt_io"] += time.perf_counter() - t0

        drain_ckpt()
        if stopped_at is not None:
            log.info("early stop triggered")
            rng.set_state(snapshots[stopped_at])
        if best["state"] is None:  # epochs == 0: the initial model
            best["state"] = host_state(model)
            save_params(ckpt, best["state"])
        log.info("train phases (s): %s",
                 {k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in pt.items()})
        load_into(model, best["state"])
        return best["state"]

    def dump_latent(self, dataset: BarcodeDataset, model_dir: str,
                    state: Optional[StateDict] = None,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Best-model mu for every barcode, shuffled order
        (VAENET.py:126-144). Writes latent.npz + barcodes.npz; returns
        (embedding, barcodes). ``state`` defaults to the checkpoint."""
        latent_path = os.path.join(model_dir, "latent.npz")
        barcodes_path = os.path.join(model_dir, "barcodes.npz")
        if os.path.exists(latent_path) and os.path.exists(barcodes_path):
            log.info("latent and barcodes already saved")
            return (np.load(latent_path)["arr_0"],
                    np.load(barcodes_path)["arr_0"])
        if state is None:
            state = load_params(os.path.join(model_dir, "train_model.pk"))
        load_into(self.model, state)
        rng = rng or np.random.RandomState(self.cfg.seed)
        n = len(dataset)
        order = rng.permutation(n).astype(np.int32)
        bsz = min(self.cfg.batch_size, n)
        dev_order = torch.from_numpy(order).to(self.device, torch.int64)
        abd_all = torch.from_numpy(dataset.abd).to(self.device)
        tnf_all = torch.from_numpy(dataset.tnf).to(self.device)
        with torch.no_grad():
            mu = torch.cat([embed(self.model, abd_all[rows], tnf_all[rows])
                            for rows in dev_order.split(bsz)])
        mu = mu.cpu().numpy()
        barcodes = dataset.barcodes[order]
        np.savez(barcodes_path, barcodes)
        np.savez(latent_path, mu)
        return mu, barcodes
