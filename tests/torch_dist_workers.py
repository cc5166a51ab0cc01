"""Rank functions of the port's multi-process tests
(tests/test_torch_parallel*.py) and the launcher that runs them.

A spawned child imports the module its function lives in, so this module
imports no JAX and nothing of pangaea_tpu: the JAX side of each test runs
in the parent test process. ``run_world`` starts one ``spawn`` process
per rank, each joining a gloo group through
``parallel.initialize_distributed`` with a ``file://`` rendezvous under
the test's own directory (no fixed port, so parallel test workers do not
collide), runs ``fn(rank, world, *args)`` and pickles its result. The
parent joins the ranks under a timeout, kills them all if one fails or
the time runs out, and raises.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
import uuid

import numpy as np

RANK_TIMEOUT_S = 240.0


def _child(fn, rank, world, store, out, args):
    import torch
    torch.set_num_threads(1)
    from pangaea_tpu_torch.config import ParallelConfig
    from pangaea_tpu_torch.parallel import initialize_distributed
    try:
        initialize_distributed(
            ParallelConfig(use_distributed=True,
                           coordinator_address=f"file://{store}",
                           num_processes=world, process_id=rank),
            device="cpu", timeout_s=RANK_TIMEOUT_S)
        res = fn(rank, world, *args)
        with open(f"{out}.{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    import torch.distributed as dist
    dist.destroy_process_group()


def run_world(fn, world: int, workdir: str, *args,
              timeout: float = RANK_TIMEOUT_S) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns
    the ranks' results in rank order."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tag = os.path.join(workdir, f"run.{uuid.uuid4().hex}")
    store = tag + ".store"
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, store, tag, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} at world size {world} "
                                   f"did not finish in {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errs = [open(f"{tag}.{r}.err").read() for r in range(world)
            if os.path.exists(f"{tag}.{r}.err")]
    if errs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{fn.__name__} at world size {world} failed "
                           f"(exit codes {[p.exitcode for p in procs]}):\n"
                           + "\n".join(errs))
    out = []
    for r in range(world):
        with open(f"{tag}.{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def block(a, rank: int, world: int):
    """Rank ``rank``'s contiguous block of ``a``'s rows (the first blocks
    one row longer where the rows do not divide)."""
    return np.array_split(a, world)[rank]


# ---- kernels-level cases -----------------------------------------------------


def kernels_battery(rank: int, world: int, inp: dict) -> dict:
    """The sharded counter, joins and Lloyd on this rank's rows."""
    import torch
    from pangaea_tpu_torch.parallel import (make_sharded_kmer_counter,
                                            make_sharded_sortjoin,
                                            make_sharded_sortjoin_pair,
                                            sharded_lloyd)
    res = {}

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(block(a, rank, world)))

    for name, codes in (("counter", inp["codes"]),
                        ("counter_polya", inp["polya"])):
        rows = mine(codes)
        lengths = torch.full((rows.shape[0],), rows.shape[1],
                             dtype=torch.int32)
        cont = torch.zeros(rows.shape[0], dtype=torch.uint8)
        for route in ("all_gather", "all_to_all"):
            init, step, unshard, (lo, hi) = make_sharded_kmer_counter(
                None, 7, 6, route=route, device="cpu")
            table = init()
            ov = 0
            for _ in range(2):  # accumulate twice
                table, o = step(table, rows, lengths, cont)
                ov += int(o.sum())
            res[f"{name}_{route}"] = (unshard(table).numpy(), ov,
                                      (lo, hi))

    def join(key, fn, *arrays):
        out = fn(*(mine(a) for a in arrays))
        res[key] = tuple(o.numpy() if torch.is_tensor(o) else o
                         for o in out)

    k, w, v = inp["sj_kwv"]
    join("sortjoin", make_sharded_sortjoin(None, k, w, v, with_stats=True,
                                           device="cpu")[0], inp["sj_keys"])
    join("hot3", make_sharded_sortjoin(None, 8, 3, 9,
                                       device="cpu")[0], inp["hot"])
    join("hot1024", make_sharded_sortjoin(None, 8, 1024, 9,
                                          device="cpu")[0], inp["hot"])
    join("adversarial", make_sharded_sortjoin(None, 8, 3, 9,
                                              device="cpu")[0],
         inp["adversarial"])
    join("pair", make_sharded_sortjoin_pair(None, 21, 3, 9, device="cpu")[0],
         inp["pair_keys"])
    join("weighted", make_sharded_sortjoin(None, 8, 3, 9, weighted=True,
                                           device="cpu")[0],
         inp["w_keys"], inp["w_wts"])
    for kk, name in ((15, "wrap15"), (21, "wrap21")):
        keys, wts, window, vec = inp[name]
        join(name, make_sharded_sortjoin(None, kk, window, vec,
                                         weighted=True, device="cpu")[0],
             keys, wts)

    X = inp["lloyd_X"]
    for name, init in (("lloyd", inp["lloyd_init"]),
                       ("lloyd_empty", inp["lloyd_init_empty"])):
        lloyd = sharded_lloyd(device="cpu")
        xs = mine(X)
        C, lab, inertia, it = lloyd(xs, torch.ones(xs.shape[0]),
                                    torch.from_numpy(init),
                                    torch.tensor(inp["lloyd_tol"]))
        res[name] = (C.numpy(), lab.numpy(), float(inertia), it)
    return res


# ---- training cases ----------------------------------------------------------


def _trainer(state: dict, dropout: float, batch_size: int = 32,
             patience: int = 7):
    import torch
    from pangaea_tpu_torch.config import ModelConfig
    from pangaea_tpu_torch.model import VAE, VAETrainer
    model = VAE(40, 16, hidden_sizes=(32, 32), latent_dim=8, dropout=dropout)
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in state.items()})
    return VAETrainer(model, ModelConfig(batch_size=batch_size,
                                         patience=patience), device="cpu")


def _noise(seq):
    import torch
    return iter([(None, torch.from_numpy(np.array(n))) for n in seq])


def train_battery(rank: int, world: int, inp: dict) -> dict:
    """sharded_train_block (JAX draws, then generator draws with dropout)
    and sharded_unit_chunk (JAX draws) from the same weights."""
    import torch
    from pangaea_tpu_torch.kernels import adam
    from pangaea_tpu_torch.model.train import FusedState, host_state
    from pangaea_tpu_torch.parallel import (sharded_train_block,
                                            sharded_unit_chunk)
    abd = torch.from_numpy(inp["abd"])
    tnf = torch.from_numpy(inp["tnf"])
    res = {}

    tr = _trainer(inp["state"], 0.0)
    stats = sharded_train_block(tr, device="cpu")(
        tr.optimizer(), tr._generator(1), abd, tnf, inp["idx"],
        inp["counts"], _noise(inp["block_noise"]))
    res["block"] = (stats.numpy(), host_state(tr.model))

    tr = _trainer(inp["state"], 0.2)
    stats = sharded_train_block(tr, device="cpu")(
        tr.optimizer(), tr._generator(1), abd, tnf, inp["idx"],
        inp["drop_counts"])
    res["block_dropout"] = (stats.numpy(), host_state(tr.model))

    tr = _trainer(inp["state"], 0.0, patience=2)
    es = FusedState(tr.model, tr.cfg, tr.device)
    rows = sharded_unit_chunk(tr, device="cpu")(
        es, tr.optimizer(), tr._generator(1),
        torch.from_numpy(inp["u_abd"]), torch.from_numpy(inp["u_tnf"]),
        inp["uidx"],
        inp["ucnt"], inp["ulive"], inp["vidx"], inp["vcnt"],
        _noise(inp["unit_noise"]))
    res["unit"] = (rows.numpy(), host_state(tr.model), int(es.counter),
                   bool(es.stopped))
    res["unit_graphs"] = (tr.phase_times.get("graph_units", 0),
                          adam.adam_step.launches)
    return res


# ---- step 1 and the multi-process flow --------------------------------------


def features_battery(rank: int, world: int, cases: list, workdir: str
                     ) -> dict:
    """ShardedFeatureExtractor on every case: (name, FeatureConfig
    kwargs, inputs); rank 0 writes each case's CSVs."""
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.parallel import ShardedFeatureExtractor
    res = {}
    for name, cfg, inputs in cases:
        d = os.path.join(workdir, f"{name}.w{world}")
        fe = ShardedFeatureExtractor(FeatureConfig(**cfg), d, device="cpu")
        names, abd, tnf = fe.extract_features(**inputs)
        res[name] = {"names": list(names), "abd": abd, "tnf": tnf,
                     "stats": dict(fe.stats), "abd_gz": fe.abd_gz,
                     "tnf_gz": fe.tnf_gz,
                     "reads_per_batch": fe.cfg.reads_per_batch}
    return res


def multihost_flow(rank: int, world: int, fq: str, workdir: str,
                   cfg: dict) -> dict:
    """tests/multihost_worker.py's flow on the port: split at barcode
    boundaries, this rank's partial table, allreduce_table, group
    features against the merged table, allgather_rows."""
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.features import FeatureExtractor
    from pangaea_tpu_torch.parallel.multihost import (
        allgather_rows, allreduce_table, split_interleaved_by_barcode)
    shards = split_interleaved_by_barcode(
        fq, os.path.join(workdir, f"w{world}.p{rank}"), world,
        compress=False)
    mine = shards[rank]
    fe = FeatureExtractor(FeatureConfig(**cfg),
                          os.path.join(workdir, f"w{world}.feat{rank}"),
                          device="cpu")
    merged = allreduce_table(fe.global_kmer_table(interleaved=mine))
    names, abd, tnf = fe.group_features(merged, interleaved=mine)
    return {"names": list(names), "abd": abd, "tnf": tnf,
            "table_sum": int(merged.sum(dtype=__import__("torch").int64)),
            "all_abd": allgather_rows(abd.astype(np.float32)),
            "all_tnf": allgather_rows(tnf.astype(np.float32))}


def backend_mismatch(rank: int, world: int) -> list:
    """A CUDA device on the gloo group must raise (this machine may have
    no card: the check comes first, or resolving the device raises)."""
    from pangaea_tpu_torch.parallel import make_sharded_sortjoin
    import torch.distributed as dist
    from pangaea_tpu_torch.parallel.mesh import check_backend
    import torch
    errors = []
    for call in (lambda: make_sharded_sortjoin(None, 8, 3, 9,
                                               device="cuda"),
                 lambda: check_backend(dist.group.WORLD,
                                       torch.device("cuda"))):
        try:
            call()
            errors.append(None)
        except (ValueError, RuntimeError) as e:
            errors.append(str(e))
    return errors
