"""PyTorch port vs pangaea_tpu: step 3 without -c.

The BIC cluster count (``select_k_with_bic``, ``cal_bic``, ``kneedle``),
the reducer's bucket-improvement modes, ``Pipeline._estimate_k`` on its
metaphlan and BIC branches, the CLI without ``-c``, and steps 1-3 without
``-c``. Both packages take the same numpy-seeded inputs; pangaea_tpu fits
each skeleton with sklearn, the port with its numpy reproduction, so the
BIC values agree within rtol 1e-5 (float32 rounding of the skeletons and
centers) and everything integer (-inf places, skeleton sizes) is equal.
The k is pangaea_tpu's wherever every k is feasible. Where some are not
(-inf), the port runs pangaea_tpu's Kneedle on the feasible k only, a
pangaea_tpu fault it does not copy (cluster/k_selection.py), and is held
against that rule applied to pangaea_tpu's own BIC lists.
"""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import pangaea_tpu.cluster as jax_cluster
import pangaea_tpu_torch.cluster as port_cluster
from pangaea_tpu.cluster import RPHKMeans as JaxRPHKMeans
from pangaea_tpu.cluster.k_selection import cal_bic as jax_cal_bic
from pangaea_tpu.cluster.k_selection import kneedle as jax_kneedle
from pangaea_tpu.cluster.k_selection import \
    select_k_with_bic as jax_select_k
from pangaea_tpu.cluster.reduce import RPPointReducer as JaxReducer
from pangaea_tpu.config import ClusterConfig as JaxClusterConfig
from pangaea_tpu.config import PangaeaConfig as JaxPangaeaConfig
from pangaea_tpu.pipeline import Pipeline as JaxPipeline
from pangaea_tpu_torch.cluster import RPHKMeans, RPPointReducer
from pangaea_tpu_torch.cluster.k_selection import (cal_bic, kneedle,
                                                   select_k_with_bic)
from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
from pangaea_tpu_torch.config import PangaeaConfig
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished, cli
from tests.test_cluster import blobs
from tests.test_misc import blobs as misc_blobs
from tests.test_pipeline import small_config
from tests.test_torch_pipeline import REPO, _clusters, _port_config


@pytest.fixture(autouse=True)
def _one_thread():
    """One BLAS, OpenMP and torch thread: the fits here are small, and
    threads only contend with each other and with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)


def _same_bic_lists(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def _knee_k(bic_lists, k_range):
    """pangaea_tpu's choice of k (Kneedle at S = 3, 2, 1, else the best
    BIC, then the rounded mean), its Kneedle run on each curve's finite
    entries only."""
    ks = []
    for bl in map(np.asarray, bic_lists):
        fin = np.isfinite(bl)
        x, y = np.asarray(k_range)[fin], bl[fin]
        knees = [jax_kneedle(x, y, S=s) for s in (3.0, 2.0, 1.0)]
        knees = [kk for kk in knees if kk is not None]
        ks.append(knees[0] if knees else k_range[int(np.argmax(bl))])
    return int(round(float(np.mean(ks))))


# ---- select_k_with_bic ------------------------------------------------------

# (blob seed, reducer max_point, kmax): the tests/test_cluster.py case, a
# second seed, and a skeleton of fewer points than kmax (-inf entries)
SELECT_CASES = [(17, 300, 10), (5, 300, 10), (17, 9, 12)]


@pytest.mark.parametrize("seed,max_point,kmax", SELECT_CASES)
def test_select_k_with_bic_matches_jax(seed, max_point, kmax):
    X, _ = blobs(n=1200, k=4, d=4, spread=1.0, seed=seed)
    kw = dict(kmax=kmax, kmin=2, ske_repeat=3, k_repeat=2,
              point_reducer_kwargs={"max_point": max_point}, random_state=0)
    jk, jlists, jrange = jax_select_k(X, **kw)
    k, lists, k_range = select_k_with_bic(X, device="cpu", **kw)
    assert k_range == jrange == list(range(2, kmax + 1))
    _same_bic_lists(lists, jlists)
    assert k == _knee_k(jlists, jrange)
    if np.isfinite(jlists).all():
        assert k == jk
    else:
        assert max_point < kmax



def test_collapsed_skeletons_give_a_k_the_final_fit_holds():
    """Tight clusters in more rows than max_point collapse to a skeleton
    of a few dozen points in one reduction round. pangaea_tpu's k is then
    about the skeleton size, and its own final RPH-KMeans raises; the
    port's k comes from the feasible k, and its final fit runs."""
    X, lab = blobs(n=600, k=8, d=32, spread=0.3, seed=33)
    red = {"max_point": 300}
    kw = dict(kmax=40, kmin=4, ske_repeat=3, k_repeat=1,
              point_reducer_kwargs=red, random_state=0)
    jk, jlists, jrange = jax_select_k(X, **kw)
    k, lists, _ = select_k_with_bic(X, device="cpu", workers=2, **kw)
    _same_bic_lists(lists, jlists)
    assert np.isinf(lists).any()
    assert k == _knee_k(jlists, jrange) < jk
    fit = dict(n_init=20, random_state=2021, **red)
    with pytest.raises(RuntimeError, match="too small"):
        JaxRPHKMeans(n_clusters=jk, **fit).fit(X)
    got = RPHKMeans(n_clusters=k, device="cpu", **fit).fit_predict(X)
    assert adjusted_rand_score(lab, got) > 0.5


def test_select_k_pool_equals_inline():
    """The fits in 3 spawned workers give the inline run's results."""
    X, _ = blobs(n=1200, k=4, d=4, spread=1.0, seed=17)
    kw = dict(kmax=10, kmin=2, ske_repeat=3, k_repeat=2,
              point_reducer_kwargs={"max_point": 300}, random_state=0,
              device="cpu")
    stats = {}
    k1, lists1, _ = select_k_with_bic(X, workers=1, **kw)
    k3, lists3, _ = select_k_with_bic(X, workers=3, stats=stats, **kw)
    assert k1 == k3 and lists1 == lists3
    assert stats["workers"] == 3 and stats["n_fits"] == 3 * 9 * 2


def test_pool_worker_imports_numpy_only():
    """A spawned worker loads cluster/skeleton.py: that import must not
    pull in torch (nor jax, pangaea_tpu or sklearn)."""
    code = ("import sys\n"
            "import pangaea_tpu_torch.cluster.skeleton\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('torch', 'jax', 'pangaea_tpu', 'sklearn')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _curve(name):
    x = np.arange(1, 21, dtype=float)
    if name == "sharp":
        return x, np.minimum(x, 5.0)
    if name == "log":
        return x, np.log(x)
    if name == "linear":          # no knee
        return x, 2 * x + 1
    if name == "flat":            # no range
        return x, np.ones_like(x)
    if name == "short":           # fewer than 3 points
        return x[:2], x[:2]
    if name == "inf":             # infeasible k at the top
        return x, np.concatenate([np.minimum(x, 5.0)[:15],
                                  np.full(5, -np.inf)])
    if name == "noisy":
        rng = np.random.RandomState(3)
        return x, -100.0 / x + rng.rand(20)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["sharp", "log", "linear", "flat",
                                  "short", "inf", "noisy"])
@pytest.mark.parametrize("S", [1.0, 3.0])
def test_kneedle_matches_jax(name, S):
    x, y = _curve(name)
    assert kneedle(x, y, S=S) == jax_kneedle(x, y, S=S)


@pytest.mark.parametrize("k,weighted", [(3, False), (3, True), (8, True)])
def test_cal_bic_matches_jax(k, weighted):
    X, _ = blobs(n=600, k=3, d=4, spread=0.2, seed=19)
    rng = np.random.RandomState(k)
    y = rng.randint(0, k, len(X))
    centers = np.stack([X[y == i].mean(0) for i in range(k)])
    w = rng.rand(len(X)).astype(np.float32) + 0.5 if weighted else None
    assert cal_bic(X, y, centers, w) == jax_cal_bic(X, y, centers, w)


# ---- the reducer's bucket-improvement modes ---------------------------------

@pytest.mark.parametrize("mode,kwargs", [
    ("radius", {"radius_divide": 1.0}),
    ("min_bkt_size", {"bkt_size_keepr": 0.8}),
    ("min_center_dist", {"center_dist_keepr": 0.8}),
])
def test_reducer_bkt_improve_modes_match_jax(mode, kwargs):
    X, _ = misc_blobs()
    j = JaxReducer(max_point=200, bkt_improve=mode,
                   rng=np.random.RandomState(0), **kwargs)
    t = RPPointReducer(max_point=200, bkt_improve=mode,
                       rng=np.random.RandomState(0), device="cpu", **kwargs)
    jskel, jw, jlab, jit = j.fit_transform(X)
    skel, w, lab, it = t.fit_transform(X)
    assert it == jit >= 1
    np.testing.assert_array_equal(skel, jskel)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(lab, jlab)
    assert t.rng.randint(2 ** 31 - 1) == j.rng.randint(2 ** 31 - 1)


def test_rph_kmeans_with_bkt_improve_matches_jax():
    X, lab = misc_blobs(n=2500, k=4)
    kw = dict(n_clusters=4, n_init=2, bkt_improve="min_bkt_size",
              bkt_size_keepr=0.9, max_point=300, random_state=0)
    want = JaxRPHKMeans(**kw).fit_predict(X)
    got = RPHKMeans(device="cpu", **kw).fit_predict(X)
    np.testing.assert_array_equal(got, want)
    assert adjusted_rand_score(lab, got) > 0.95


# ---- Pipeline._estimate_k --------------------------------------------------

def _patch_bic(monkeypatch, **small):
    """select_k_with_bic at a small depth, in both packages' ``cluster``
    namespace (where ``_estimate_k`` looks it up)."""
    for mod in (jax_cluster, port_cluster):
        real = mod.select_k_with_bic
        monkeypatch.setattr(mod, "select_k_with_bic",
                            lambda X, real=real, **kw: real(X, **{**kw,
                                                                  **small}))


@pytest.fixture
def small_bic(monkeypatch):
    _patch_bic(monkeypatch, kmax=10, ske_repeat=2)


def _stub_metaphlan(tmp_path, monkeypatch):
    """A metaphlan on PATH that writes a 60/40 profile (tests/test_asm.py
    stub), and a database directory with an index."""
    db = tmp_path / "db"
    db.mkdir()
    (db / "mpa_vOct22_SGB.1.bt2l").write_text("")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "metaphlan"
    stub.write_text("""#!/bin/bash
out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) shift;; esac
done
{
  printf '#mpa_vOct22\\n#clade_name\\tNCBI_tax_id\\trelative_abundance\\n'
  printf 'k__B|s__A|t__SGB1\\t2|1|\\t60.0\\n'
  printf 'k__B|s__B|t__SGB2\\t2|2|\\t40.0\\n'
} > "$out"
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return str(db)


@pytest.mark.parametrize("branch", ["bic", "db_without_metaphlan",
                                    "metaphlan"])
def test_estimate_k_matches_jax(branch, tmp_path, monkeypatch, small_bic):
    X, _ = blobs(n=600, k=5, d=32, spread=1.0, seed=23)
    db = ""
    if branch == "metaphlan":
        db = _stub_metaphlan(tmp_path, monkeypatch)
    elif branch == "db_without_metaphlan":
        db = str(tmp_path / "no_such_db")
    ks = {}
    for name, P, Cfg, kw in (("jax", JaxPipeline, JaxPangaeaConfig, {}),
                             ("port", Pipeline, PangaeaConfig,
                              {"device": "cpu"})):
        out = tmp_path / name
        (out / "2.vae").mkdir(parents=True)
        np.savez(out / "2.vae" / "latent.npz", X)
        reads = tmp_path / "reads.fq"
        reads.write_text("@r\nACGT\n+\nIIII\n")
        cfg = Cfg(interleaved_reads=str(reads), output=str(out),
                  metaphlan_db=db)
        pipe = P(cfg, **kw)
        os.makedirs(pipe.cluster_dir)
        ks[name] = pipe._estimate_k()
    assert ks["port"] == ks["jax"]
    if branch == "metaphlan":
        assert ks["port"] == 5   # int(8 * H(0.6, 0.4))


# ---- the CLI and steps 1-3 without -c --------------------------------------

@pytest.mark.parametrize("argv,ok", [
    ([], True),                                       # no -c
    (["-m", "db"], True),                             # metaphlan
    (["-m", "db", "-c", "4", "-t", "3"], True),
    (["-k", "32"], False),                            # past 31
    (["--cluster_device_min_elems", "10"], False),
    (["--matmul_dtype", "bfloat16"], True),
])
def test_cli_without_c(argv, ok, capsys):
    p = cli.build_parser()
    args = p.parse_args(["-i", "r.fq", "-o", "o", "-st", "1,2,3", *argv])
    if not ok:
        with pytest.raises(SystemExit) as e:
            cli.check_supported(p, args)
        assert e.value.code == 2
        return
    cli.check_supported(p, args)
    cfg = cli.config_from_args(args)
    assert cfg.cluster.n_clusters == (4 if "-c" in argv else None)
    assert cfg.metaphlan_db == ("db" if "-m" in argv else "")
    assert cfg.model.matmul_dtype == ("bfloat16" if "--matmul_dtype" in argv
                                      else "float32")


# 8 species: pangaea_tpu's kmin=4 and its Kneedle (which never picks the
# first k) leave the 4-species tests/test_pipeline.py sim no right answer
SIM8 = dict(n_species=8, genome_len=30_000, n_barcodes=240,
            pairs_per_barcode=30, seed=11, error_rate=0.005,
            low_qual_rate=0.15)


@pytest.fixture(scope="module")
def sim8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sim8") / "reads.fq.gz")
    return path, simulate_linked_reads(out_interleaved=path, **SIM8)


def test_steps_1_to_3_without_c_match_jax(sim8, tmp_path, monkeypatch):
    """Steps 1-3 without -c in both packages, BIC at kmax = 20 in both;
    the port's skeleton fits in two worker processes."""
    _patch_bic(monkeypatch, kmax=20, ske_repeat=2)
    reads, res = sim8
    out = str(tmp_path / "port")
    cfg = _port_config(reads, out).replace(threads=2)
    cfg.cluster.n_clusters = None
    pipe = Pipeline(cfg, device="cpu")
    pipe.run()
    assert check_step_finished(out, "3")
    stats = pipe.cluster_stats
    assert (stats["k_source"], stats["workers"]) == ("bic", 2)
    jout = str(tmp_path / "jax")
    jcfg = small_config(reads, jout)
    jcfg.cluster = JaxClusterConfig(n_clusters=None,
                                    n_init=jcfg.cluster.n_init)
    JaxPipeline(jcfg).run()
    mine, theirs = _clusters(out), _clusters(jout)
    assert len(set(mine.values())) == stats["k"]
    labelled = [bc for bc in mine if bc in res.barcode_species]
    ari = adjusted_rand_score([res.barcode_species[bc] for bc in labelled],
                              [mine[bc] for bc in labelled])
    assert ari > 0.95, f"ARI {ari} at k = {stats['k']}"
    assert set(mine) == set(theirs)
    common = sorted(mine)
    cross = adjusted_rand_score([mine[b] for b in common],
                                [theirs[b] for b in common])
    assert cross >= 0.95, f"cross-ARI {cross}"
