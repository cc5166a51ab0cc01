"""PyTorch port vs pangaea_tpu: the sharded counter, joins, Lloyd and
training steps of ``pangaea_tpu_torch.parallel`` on gloo at world sizes
1, 2 and 3 (tests/torch_dist_workers.py runs the ranks; each run is
joined under a timeout).

The same seeded numpy inputs go through pangaea_tpu — its one-device
functions, and for the routed-pair matrix its sharded join on a mesh of
the same size — and through the port's ranks, each holding its
contiguous block of the rows. Integer outputs are bit-equal; the port
routes exactly, so where pangaea_tpu's fixed buckets report an overflow
the port gives the right table and bins with overflow 0. Floats use
tests/test_parallel.py's tolerances: losses rtol 2e-4 / atol 1e-5,
parameters rtol 2e-3 / atol 2e-5; Lloyd's labels and relocated centres
are equal (centres to float32 rounding of the summed order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_dist_workers as W

WORLDS = (1, 2, 3)
LOSS = dict(rtol=2e-4, atol=1e-5)
PARAM = dict(rtol=2e-3, atol=2e-5)


# ---- inputs and the JAX side -------------------------------------------------


@pytest.fixture(scope="module")
def kernel_inputs():
    from pangaea_tpu.kernels.features import kmer_key_sentinel
    rng = np.random.RandomState(3)
    inp = {"codes": rng.randint(0, 4, (66, 64)).astype(np.uint8),
           "polya": np.zeros((66, 64), np.uint8)}
    rng = np.random.RandomState(0)
    n = 6 * 4096  # divides over 1, 2 and 3 ranks, as P('data') needs
    keys = rng.randint(0, 2000, n).astype(np.int32)
    keys[rng.rand(n) < 0.15] = kmer_key_sentinel(8)
    inp["sj_kwv"] = (8, 3, 9)
    inp["sj_keys"] = keys
    inp["hot"] = np.full(6 * 1024, 7, np.int32)
    inp["adversarial"] = ((8 * np.arange(6 * 1024)) % (4 ** 8)
                          ).astype(np.int32)
    rng = np.random.RandomState(1)
    hi = rng.randint(0, 40, n).astype(np.int64)
    lo = rng.randint(0, 50, n).astype(np.int64)
    pair = (hi << 32) | lo
    pair[rng.rand(n) < 0.15] = 4 ** 21
    inp["pair_keys"] = pair
    rng = np.random.RandomState(5)
    wk = rng.randint(0, 1500, n).astype(np.int32)
    wk[rng.rand(n) < 0.15] = kmer_key_sentinel(8)
    ww = (rng.rand(n) < 0.6).astype(np.int32)
    ww[wk < 100] = 0
    inp["w_keys"], inp["w_wts"] = wk, ww
    # chip_smoke.check_wrap's 82 keys (2,400,000,100 in all), and two
    # keys split over the ranks whose one key weighs 6e9 at its owner
    inp["wrap15"] = ((np.arange(82) * 7919).astype(np.int32),
                     np.array([50] + [30_000_000] * 80 + [50], np.int32),
                     10, 400)
    inp["wrap21"] = (np.array([0, 1] * 6, np.int64) + (5 << 32),
                     np.array([1_000_000_000, 1] * 6, np.int32),
                     1_000_000_000, 400)
    rng = np.random.RandomState(2)
    centers = rng.randn(4, 8).astype(np.float32) * 4
    lab = rng.randint(0, 4, 258)
    X = (centers[lab] + rng.randn(258, 8) * 0.2).astype(np.float32)
    inp["lloyd_X"] = X
    inp["lloyd_init"] = X[[0, 50, 100, 200]]
    inp["lloyd_init_empty"] = X[[0, 0, 100, 200]]
    inp["lloyd_tol"] = np.float32(1e-4 * X.var(axis=0).mean())
    return inp


@pytest.fixture(scope="module", params=WORLDS)
def kernels_run(request, kernel_inputs, tmp_path_factory):
    world = request.param
    return world, W.run_world(W.kernels_battery, world,
                              str(tmp_path_factory.mktemp("kern")),
                              kernel_inputs)


def _cat(results, key, i=0):
    return np.concatenate([r[key][i] for r in results])


def _jax_count(codes):
    from pangaea_tpu.kernels.features import (count_kmers_global,
                                              make_global_table)
    n = codes.shape[0]
    return np.asarray(count_kmers_global(
        make_global_table(7), jnp.asarray(codes),
        jnp.full(n, 64, jnp.int32), jnp.zeros(n, jnp.uint8), k=7,
        overlap=6))


# ---- the key-range-sharded counter -------------------------------------------


@pytest.mark.parametrize("case", ["counter", "counter_polya"])
@pytest.mark.parametrize("route", ["all_gather", "all_to_all"])
def test_sharded_table_counter_matches_single(kernels_run, kernel_inputs,
                                              case, route):
    """Each rank's unsharded table == 2 x pangaea_tpu's one-device count
    (two steps). On poly-A reads, where pangaea_tpu's all_to_all
    buckets at capacity_factor 0.01 report an overflow
    (test_sharded_counter_overflow_detected), the port routes exactly:
    the right table, overflow 0."""
    world, results = kernels_run
    codes = kernel_inputs["codes" if case == "counter" else "polya"]
    want = 2 * _jax_count(codes)
    ranges = []
    for r in results:
        table, overflow, key_range = r[f"{case}_{route}"]
        assert overflow == 0
        np.testing.assert_array_equal(table, want)
        ranges.append(key_range)
    # the key ranges tile [0, 4^7) in rank order
    assert ranges[0][0] == 0 and ranges[-1][1] >= 4 ** 7
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# ---- the routed sort-join -----------------------------------------------------


def test_sharded_sortjoin_matches_single_and_routes_like_jax(
        kernels_run, kernel_inputs):
    """Bins == pangaea_tpu's one-device sortjoin_bins (sentinels and bin
    capping included), and the with_stats routed-pair matrix == that of
    pangaea_tpu's sharded join on a mesh of the same size."""
    from pangaea_tpu.kernels.features import sortjoin_bins
    from pangaea_tpu.parallel import data_mesh, make_sharded_sortjoin
    world, results = kernels_run
    k, window, vec = kernel_inputs["sj_kwv"]
    keys = kernel_inputs["sj_keys"]
    want = np.asarray(sortjoin_bins(jnp.asarray(keys), k=k, window=window,
                                    vector_size=vec))
    np.testing.assert_array_equal(_cat(results, "sortjoin"), want)
    assert all(int(r["sortjoin"][1].sum()) == 0 for r in results)
    mesh = data_mesh(world)
    bins_fn, row = make_sharded_sortjoin(mesh, k, window, vec,
                                         with_stats=True)
    jb, jov, jstats = bins_fn(jax.device_put(jnp.asarray(keys), row))
    np.testing.assert_array_equal(np.asarray(jb), want)
    for r in results:
        assert r["sortjoin"][2].shape == (world, world)
        np.testing.assert_array_equal(r["sortjoin"][2], np.asarray(jstats))


def test_sharded_sortjoin_hot_key(kernels_run):
    """One hot key routes as one (key, count) pair per rank: bin 2048 >=
    9 -> -1 everywhere at window 3; 6144 // 1024 = 6 at window 1024."""
    world, results = kernels_run
    assert (_cat(results, "hot3") == -1).all()
    assert (_cat(results, "hot1024") == 6).all()
    assert all(int(r[k][1].sum()) == 0 for r in results
               for k in ("hot3", "hot1024"))


def test_sharded_sortjoin_adversarial_keys_exact(kernels_run,
                                                 kernel_inputs):
    """The keys whose hash piles them on one shard, where pangaea_tpu's
    fixed buckets report an overflow
    (test_sharded_sortjoin_overflow_detected): the port's exact routing
    gives pangaea_tpu's one-device bins, overflow 0."""
    from pangaea_tpu.kernels.features import sortjoin_bins
    world, results = kernels_run
    keys = kernel_inputs["adversarial"]
    want = np.asarray(sortjoin_bins(jnp.asarray(keys), k=8, window=3,
                                    vector_size=9))
    np.testing.assert_array_equal(_cat(results, "adversarial"), want)
    assert all(int(r["adversarial"][1].sum()) == 0 for r in results)


def test_sharded_sortjoin_pair_matches_single(kernels_run, kernel_inputs):
    """k = 21: int64 keys through the same routed join ==
    pangaea_tpu's one-device split-word sortjoin_bins_pair."""
    from pangaea_tpu.kernels.features import sortjoin_bins_pair
    world, results = kernels_run
    keys = kernel_inputs["pair_keys"]
    hi = (keys >> 32).astype(np.uint32)
    lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    want = np.asarray(sortjoin_bins_pair(jnp.asarray(hi), jnp.asarray(lo),
                                         k=21, window=3, vector_size=9))
    np.testing.assert_array_equal(_cat(results, "pair"), want)


def test_sharded_weighted_sortjoin_matches_single(kernels_run,
                                                  kernel_inputs):
    """Routed local weight sums == pangaea_tpu's one-device weighted
    join, keys of zero total weight included (-1)."""
    from pangaea_tpu.kernels.features import sortjoin_bins_weighted
    world, results = kernels_run
    want = np.asarray(sortjoin_bins_weighted(
        jnp.asarray(kernel_inputs["w_keys"]),
        jnp.asarray(kernel_inputs["w_wts"]), k=8, window=3, vector_size=9))
    np.testing.assert_array_equal(_cat(results, "weighted"), want)


@pytest.mark.parametrize("case", ["wrap15", "wrap21"])
def test_sharded_weighted_join_past_int32(kernels_run, kernel_inputs, case):
    """Total weight past 2^31 - 1 (pangaea_tpu's int32 weight cumsum
    wraps there; the port routes int64 sums): the bins of an int64 numpy
    count — the 82 keys of chip_smoke.check_wrap, and one key weighing
    6e9 summed over the ranks at its owner."""
    world, results = kernels_run
    keys, wts, window, vec = kernel_inputs[case]
    uniq, inv = np.unique(keys, return_inverse=True)
    counts = np.bincount(inv, weights=wts.astype(np.float64)).astype(
        np.int64)[inv]
    assert int(wts.astype(np.int64).sum()) > 2 ** 31 - 1
    bins = counts // window
    want = np.where((counts > 0) & (bins < vec), bins, -1).astype(np.int32)
    got = _cat(results, case)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---- Lloyd ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["lloyd", "lloyd_empty"])
def test_sharded_lloyd_matches_single(kernels_run, kernel_inputs, case):
    """Labels and iterations equal pangaea_tpu's kmeans_lloyd, the
    centres to float32 rounding, the inertia within rtol 1e-3; with two
    equal initial centres one cluster empties and is relocated to the
    same farthest point."""
    from pangaea_tpu.cluster.kmeans import kmeans_lloyd
    world, results = kernels_run
    X = kernel_inputs["lloyd_X"]
    init = kernel_inputs[case.replace("lloyd", "lloyd_init")]
    C1, l1, in1, it1 = kmeans_lloyd(X, init)
    labels = _cat(results, case, 1)
    np.testing.assert_array_equal(labels, np.asarray(l1))
    for r in results:
        C, _, inertia, it = r[case]
        assert it == int(it1)
        np.testing.assert_allclose(C, np.asarray(C1), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(inertia, float(in1), rtol=1e-3)
    if case == "lloyd_empty":
        # the relocated centre sits on the data, away from the duplicate
        assert not np.allclose(results[0][case][0][0],
                               results[0][case][0][1])


# ---- training ---------------------------------------------------------------------


def _jax_vae(dropout=0.0):
    from pangaea_tpu.model import VAE
    return VAE(abd_dim=40, tnf_dim=16, hidden_sizes=(32, 32), latent_dim=8,
               dropout=dropout)


def _train_noise(key, batch):
    """The latent noise pangaea_tpu's train step draws from ``key``
    (vae_forward train=True: split(key, 5)[2] with two hidden layers)."""
    ks = jax.random.split(key, 5)
    return np.asarray(jax.random.normal(ks[2], (batch, 8), jnp.float32))


@pytest.fixture(scope="module")
def train_inputs():
    from pangaea_tpu.config import ModelConfig
    from pangaea_tpu.model import VAETrainer, init_vae
    from pangaea_tpu.model.dataset import batch_index_matrix
    from pangaea_tpu_torch.model.convert import vae_state_from_jax
    model = _jax_vae()
    params, bn = init_vae(jax.random.PRNGKey(0), model)
    state = {k: v.numpy() for k, v in vae_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, bn)).items()}
    rng = np.random.RandomState(1)
    abd = rng.rand(128, 40).astype(np.float32)
    tnf = rng.rand(128, 16).astype(np.float32)
    idx, mask = batch_index_matrix(np.arange(128), 32)
    # pangaea_tpu's train block: one key split per batch
    trainer = VAETrainer(model, ModelConfig(batch_size=32))
    key = jax.random.PRNGKey(3)
    p1, _, _, _, s1 = trainer._train_block(
        params, trainer.tx.init(params), bn, jnp.array(key), jnp.asarray(abd),
        jnp.asarray(tnf), jnp.asarray(idx), jnp.asarray(mask))
    noise = []
    for _ in range(idx.shape[0]):
        key, sub = jax.random.split(key)
        noise.append(_train_noise(sub, 32))
    inp = {"state": state, "abd": abd, "tnf": tnf, "idx": idx,
           "counts": [32] * idx.shape[0], "block_noise": noise,
           "drop_counts": [32, 17]}
    want = {"block": (np.asarray(s1), np.asarray(p1["out"]["w"]))}
    # pangaea_tpu's fused unit chunk (tests/test_parallel.py's geometry)
    uin, want["unit"] = _jax_unit_chunk()
    inp.update(uin)
    return inp, want


def _jax_unit_chunk():
    from pangaea_tpu.config import ModelConfig
    from pangaea_tpu.model import VAETrainer, init_vae
    params, bn = init_vae(jax.random.PRNGKey(0), _jax_vae())
    rng = np.random.RandomState(4)
    n, bsz, C, U, vnb = 128, 32, 4, 2, 2
    abd = rng.rand(n, 40).astype(np.float32)
    tnf = rng.rand(n, 16).astype(np.float32)
    uidx = rng.randint(0, n, (C, U, bsz)).astype(np.int32)
    ucnt = np.full((C, U), bsz, np.int32)
    ucnt[-1, -1] = 17  # a partial batch
    ulive = np.array([True, True, True, False])
    vidx = rng.randint(0, n, (C, vnb, bsz)).astype(np.int32)
    vcnt = np.array([bsz, 11], np.int32)
    trainer = VAETrainer(_jax_vae(), ModelConfig(batch_size=32, patience=2))
    key0 = jax.random.PRNGKey(5)
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    es = (jnp.float32(-np.inf), jnp.int32(0), jnp.bool_(False))
    out = trainer._unit_chunk(
        params, trainer.tx.init(params), bn, jnp.array(key0), zeros(params),
        zeros(bn), es, jnp.asarray(abd), jnp.asarray(tnf),
        jnp.asarray(uidx), jnp.asarray(ucnt), jnp.asarray(ulive),
        jnp.asarray(vidx), jnp.asarray(vcnt))
    rows = np.asarray(out[7])
    # replay the chunk's key splits over the units that ran
    noise, key = [], jax.random.PRNGKey(5)
    for i in range(C):
        if rows[i, 7] == 0:
            continue
        for j in range(U):
            if ucnt[i, j] > 0:
                key, sub = jax.random.split(key)
                noise.append(_train_noise(sub, bsz))
        key, vkey = jax.random.split(key)
        for _ in range(vnb):
            vkey, vsub = jax.random.split(vkey)
            noise.append(np.asarray(jax.random.normal(vsub, (bsz, 8),
                                                      jnp.float32)))
    inp = {"u_abd": abd, "u_tnf": tnf, "uidx": uidx, "ucnt": ucnt,
           "ulive": ulive, "vidx": vidx, "vcnt": vcnt, "unit_noise": noise}
    return inp, (rows, np.asarray(out[0]["out"]["w"]), int(out[6][1]),
                 bool(out[6][2]))


@pytest.fixture(scope="module", params=WORLDS)
def train_run(request, train_inputs, tmp_path_factory):
    inp, _ = train_inputs
    world = request.param
    return world, W.run_world(W.train_battery, world,
                              str(tmp_path_factory.mktemp("train")), inp)


def _out_w(state):
    from pangaea_tpu_torch.model.convert import vae_state_to_jax
    return vae_state_to_jax(state)[0]["out"]["w"]


def _replicated(results, key):
    """Every rank holds the same parameters after the step."""
    states = [r[key][1] for r in results]
    for s in states[1:]:
        for name, a in s.items():
            np.testing.assert_array_equal(a, states[0][name], err_msg=name)
    return states[0]


def test_sharded_train_block_matches_jax(train_run, train_inputs):
    """pangaea_tpu's train block (4 batches of 32, its latent noise
    handed to the port): mean loss stats and the output layer's weights
    after four Adam steps, on every rank."""
    world, results = train_run
    _, want = train_inputs
    s1, w1 = want["block"]
    state = _replicated(results, "block")
    for r in results:
        np.testing.assert_allclose(r["block"][0], s1, **LOSS)
    np.testing.assert_allclose(_out_w(state), w1, **PARAM)


def test_sharded_train_block_draws_do_not_depend_on_world(train_run,
                                                          train_inputs):
    """Dropout on: masks and noise drawn for the whole batch from the one
    generator and sliced per rank, a 17-row batch split unevenly (BN's
    two passes over all ranks' rows) == the port's one-device steps."""
    import torch
    world, results = train_run
    inp, _ = train_inputs
    tr = W._trainer(inp["state"], 0.2)
    opt, gen = tr.optimizer(), tr._generator(1)
    tr.model.train()
    abd, tnf = torch.from_numpy(inp["abd"]), torch.from_numpy(inp["tnf"])
    stats = torch.stack([
        tr._train_batch(opt, gen, abd, tnf,
                        torch.from_numpy(inp["idx"][j][:c]).long())
        for j, c in enumerate(inp["drop_counts"])]).mean(0)
    state = _replicated(results, "block_dropout")
    np.testing.assert_allclose(results[0]["block_dropout"][0],
                               stats.numpy(), **LOSS)
    from pangaea_tpu_torch.model.train import host_state
    want = host_state(tr.model)
    for name, a in state.items():
        # a Linear's bias right before BatchNorm has a gradient of zero
        # up to rounding (BN takes the batch mean out), which Adam's
        # first steps blow up to +-lr; it and the BN running mean that
        # carries it are left out (tests/test_parallel.py compares the
        # output layer only)
        if (name.split(".")[0] in ("enc", "dec") and name.endswith("bias")
                or name.endswith("running_mean")):
            continue
        np.testing.assert_allclose(a, want[name], err_msg=name, **PARAM)


def test_sharded_unit_chunk_matches_jax(train_run, train_inputs):
    """pangaea_tpu's fused chunk (4 units, patience 2, a partial train
    batch and a partial val batch, a dead tail unit): the same units
    ran, improved and stopped, val losses and output weights within
    tolerance, the same patience counter and stop flag."""
    world, results = train_run
    _, want = train_inputs
    rows1, w1, counter1, stopped1 = want["unit"]
    state = _replicated(results, "unit")
    for r in results:
        rows2, _, counter2, stopped2 = r["unit"]
        ran1, ran2 = rows1[:, 7] != 0, rows2[:, 7] != 0
        np.testing.assert_array_equal(ran1, ran2)
        np.testing.assert_array_equal(rows1[:, 5] != 0, rows2[:, 5] != 0)
        np.testing.assert_array_equal(rows1[:, 6] != 0, rows2[:, 6] != 0)
        np.testing.assert_allclose(rows2[ran2, 0], rows1[ran1, 0], **LOSS)
        assert counter2 == counter1 and stopped2 == stopped1
    np.testing.assert_allclose(_out_w(state), w1, **PARAM)


def test_sharded_unit_chunk_runs_no_graph(train_run):
    """The sharded units stay eager: no unit is a replay and the Adam
    kernel never steps (the fused loop graphs only its own units)."""
    _, results = train_run
    for r in results:
        assert r["unit_graphs"] == (0, 0)


def test_cuda_device_on_gloo_group_raises(tmp_path):
    """A CUDA device on the gloo group raises; nothing moves to the CPU
    to make a collective work."""
    errors = W.run_world(W.backend_mismatch, 1, str(tmp_path))[0]
    assert all(e is not None for e in errors), errors


def test_initialize_distributed_single_process_and_rendezvous(monkeypatch):
    """One process with use_distributed=False (and no torchrun world)
    joins no group; a file:// rendezvous path is made absolute, a bare
    host:port becomes tcp://."""
    import torch.distributed as dist
    from pangaea_tpu_torch.config import ParallelConfig
    from pangaea_tpu_torch.parallel import initialize_distributed, world_size
    from pangaea_tpu_torch.parallel.mesh import _init_method
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed(ParallelConfig(), device="cpu") is None
    assert not dist.is_initialized() and world_size() == 1
    assert _init_method("file://build/store") == \
        "file://" + os.path.abspath("build/store")
    assert _init_method("localhost:29500") == "tcp://localhost:29500"
    assert _init_method("tcp://h:1") == "tcp://h:1"
