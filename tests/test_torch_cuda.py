"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Run on a machine with a CUDA card: ``python -m pytest tests/test_torch_cuda.py``.
Elsewhere every test skips (there is no CPU mode for a CUDA kernel).
"""

import pytest
import torch

from pangaea_tpu_torch.kernels import scan

pytestmark = pytest.mark.cuda

LENGTHS = [1, 7, 4095, 4096, 4097, 32768 * 3 + 12345, 4096 * 4096 + 1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name,plain", [
    ("cummax", scan.cummax_plain),
    ("cummin_reverse", scan.cummin_reverse_plain),
    ("cumsum", scan.cumsum_plain),
])
@pytest.mark.parametrize("n", LENGTHS)
def test_scan_kernel_bit_equal(cuda, name, plain, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      dtype=torch.int64, device=cuda).to(torch.int32)
    fn = getattr(scan, name)
    before = fn.launches
    got = fn(x)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(x))


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 4097, 32768 * 3 + 12345])
def test_scan_cuda_every_variant(cuda, op, reverse, n):
    gen = torch.Generator(device=cuda).manual_seed(n + 3)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      dtype=torch.int64, device=cuda).to(torch.int32)
    got = scan.scan_cuda(x, op, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, scan.scan_plain(x, op, reverse))


VARIANTS = [(op, rev) for op in ("max", "min", "sum") for rev in (False, True)]
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _random(n, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(I32_MIN, I32_MAX, (n,), generator=gen,
                         dtype=torch.int64, device=device).to(torch.int32)


def _check_variant(x, op, reverse):
    got = scan.scan_cuda(x, op, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, scan.scan_plain(x, op, reverse)), \
        f"({op}, reverse={reverse}) differs at n={x.numel()}"


@pytest.mark.parametrize("op,reverse", VARIANTS)
@pytest.mark.parametrize("edge", ["T-1", "T", "T+1", "33T+1"])
def test_scan_cuda_tile_edges(cuda, op, reverse, edge):
    """Lengths at the kernel's tile edges; 33 tiles make the look-back
    slide past one window of 32 descriptors."""
    t = scan.tile_elems()
    n = {"T-1": t - 1, "T": t, "T+1": t + 1, "33T+1": 33 * t + 1}[edge]
    _check_variant(_random(n, n + 11, cuda), op, reverse)


@pytest.mark.parametrize("op,reverse", VARIANTS)
@pytest.mark.parametrize("offset", [1, 3])
def test_scan_cuda_misaligned_views(cuda, op, reverse, offset):
    """x[offset:] starts off the 16-byte grid; the output does not."""
    t = scan.tile_elems()
    for n in (1, 7, t - 1, t + 3, 33 * t + 1):
        base = _random(n + offset, n * 7 + offset, cuda)
        view = base[offset:]
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        _check_variant(view, op, reverse)


def _adversarial(kind, n, device):
    if kind == "constant":
        return torch.full((n,), 12345, dtype=torch.int32, device=device)
    if kind == "increasing":
        return torch.arange(-(n // 2), n - n // 2, dtype=torch.int32,
                            device=device)
    if kind == "decreasing":
        return torch.arange(-(n // 2), n - n // 2, dtype=torch.int32,
                            device=device).flip(0)
    if kind == "full_range":  # sums wrap many times
        return _random(n, 5, device)
    return torch.full((n,), {"int_min": I32_MIN, "int_max": I32_MAX}[kind],
                      dtype=torch.int32, device=device)


@pytest.mark.parametrize("op,reverse", VARIANTS)
@pytest.mark.parametrize("kind", ["constant", "increasing", "decreasing",
                                  "int_min", "int_max", "full_range"])
def test_scan_cuda_adversarial_inputs(cuda, op, reverse, kind):
    n = 33 * scan.tile_elems() + 7
    _check_variant(_adversarial(kind, n, cuda), op, reverse)


@pytest.mark.parametrize("op,reverse", VARIANTS)
def test_scan_cuda_repeats_bit_equal(cuda, op, reverse):
    """The look-back's memory ordering: 20 runs on one input, each
    bit-equal (a race shows up only now and then)."""
    x = _random((1 << 24) + 13, 99, cuda)
    want = scan.scan_plain(x, op, reverse)
    for i in range(20):
        got = scan.scan_cuda(x, op, reverse)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"repeat {i} differs"


def test_scan_cuda_resources(cuda):
    """Every variant compiles without spills and keeps two or more blocks
    resident per SM."""
    for op, reverse in VARIANTS:
        res = scan.kernel_resources(op, reverse)
        assert res["spill_bytes"] == 0, res
        assert res["blocks_per_sm"] >= 2, res


def test_sortjoin_bins_on_card_equals_cpu(cuda):
    from pangaea_tpu_torch.kernels.features import sortjoin_bins
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 300, (1 << 16,), generator=gen,
                         dtype=torch.int32)
    keys[-100:] = 4 ** 4
    want = sortjoin_bins(keys, k=4, window=3, vector_size=50)
    got = sortjoin_bins(keys.to(cuda), k=4, window=3, vector_size=50)
    assert torch.equal(got.cpu(), want)


def _weighted_keys(n, seed):
    gen = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, 5000, (n,), generator=gen, dtype=torch.int32)
    keys[torch.rand(n, generator=gen) < 0.1] = 4 ** 7
    w = (torch.rand(n, generator=gen) < 0.7).to(torch.int32)
    w[keys == 4 ** 7] = 0
    return keys, w


@pytest.mark.parametrize("n", [1 << 16, (1 << 20) + 12345])
def test_sortjoin_bins_weighted_on_card_equals_cpu(cuda, n):
    """The weighted join runs one scan on the card, the cumsum of the run
    ids (its run weight sums are an int64 index_add_); its bins equal the
    plain run's."""
    from pangaea_tpu_torch.kernels.features import sortjoin_bins_weighted
    keys, w = _weighted_keys(n, n)
    want = sortjoin_bins_weighted(keys, w, k=7, window=2, vector_size=60)
    before = [fn.launches for fn in scan.WRAPPERS]
    got = sortjoin_bins_weighted(keys.to(cuda), w.to(cuda), k=7, window=2,
                                 vector_size=60)
    assert [fn.launches - b for fn, b in zip(scan.WRAPPERS, before)] == \
        [0, 0, 1]
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_spill_aggregate_on_card_equals_cpu(cuda, weighted):
    from pangaea_tpu_torch.kernels import features as kf
    keys, w = _weighted_keys((1 << 20) + 77, 3)
    if weighted:
        want = kf.spill_aggregate_weighted(keys, w, k=7)
        before = scan.cumsum.launches
        got = kf.spill_aggregate_weighted(keys.to(cuda), w.to(cuda), k=7)
        assert scan.cumsum.launches == before + 1
    else:
        want = kf.spill_aggregate(keys, k=7)
        before = scan.cumsum.launches
        got = kf.spill_aggregate(keys.to(cuda), k=7)
        assert scan.cumsum.launches == before + 1
    ids, uniq, uw, n_runs, n_valid = got
    assert (n_runs, n_valid) == want[3:]
    for a, b in zip((ids, uniq, uw), want[:3]):
        assert torch.equal(a.cpu(), b)
    table = torch.randint(-1, 40, (n_runs,), dtype=torch.int32)
    assert torch.equal(kf.map_run_bins(table.to(cuda), ids).cpu(),
                       kf.map_run_bins(table, want[0]))


@pytest.mark.parametrize("k", [15, 21])
def test_weighted_join_past_int32_total_on_card(cuda, k):
    """82 keys whose weights sum to 2,400,000,100: the card gives the
    CPU's bins, 5 for the two keys of weight 50."""
    from pangaea_tpu_torch.kernels.features import sortjoin_bins_weighted
    keys = torch.arange(82, dtype=torch.int64 if k > 15 else torch.int32)
    w = torch.tensor([50] + [30_000_000] * 80 + [50], dtype=torch.int32)
    want = sortjoin_bins_weighted(keys, w, k=k, window=10, vector_size=400)
    got = sortjoin_bins_weighted(keys.to(cuda), w.to(cuda), k=k, window=10,
                                 vector_size=400)
    assert (int(want[0]), int(want[-1])) == (5, 5)
    assert torch.equal(got.cpu(), want)


def _contigs(seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    seq = lambda n: "".join(rng.choice(list("ACGT"), n))  # noqa: E731
    rep = seq(400)
    return [(f"c{i}", seq(3000) + rep + seq(2000)) for i in range(8)], seq


@pytest.mark.parametrize("k", [13, 7])
def test_kmer_mapper_on_card_equals_cpu(cuda, k):
    """The mapper's index table and its (best, votes, nvalid) on the card
    are bit-equal to the CPU's; the run-length scan launches cummax."""
    import numpy as np
    from pangaea_tpu_torch.asm.mapper import KmerMapper
    contigs, seq = _contigs(k)
    maps = {}
    for dev in ("cpu", cuda):
        m = KmerMapper(k=k, max_row_len=256, rows_per_batch=16, device=dev)
        m.index_contigs(contigs)
        maps[str(dev)] = m
    assert torch.equal(maps["cuda"].table.cpu(), maps["cpu"].table)
    reads = [s[i:i + 150] for _, s in contigs for i in range(0, 5000, 97)]
    reads += [seq(150) for _ in range(50)] + ["N" * 150, "", seq(1100)]
    before = scan.cummax.launches
    got = maps["cuda"].map_reads(reads)
    assert scan.cummax.launches == before + 1
    for a, b in zip(got, maps["cpu"].map_reads(reads)):
        np.testing.assert_array_equal(a, b)


def _int64_keys(n, seed, k=21):
    """Duplicated k = 21 keys (int64, above 2^32) with sentinels, and 0/1
    weights."""
    gen = torch.Generator().manual_seed(seed)
    pool = torch.randint(0, 4 ** k, (5000,), generator=gen,
                         dtype=torch.int64)
    keys = pool[torch.randint(0, 5000, (n,), generator=gen)]
    keys[torch.rand(n, generator=gen) < 0.1] = 4 ** k
    w = (torch.rand(n, generator=gen) < 0.7).to(torch.int32)
    w[keys == 4 ** k] = 0
    return keys, w


@pytest.mark.parametrize("weighted", [False, True])
def test_int64_sortjoin_on_card_equals_cpu(cuda, weighted):
    """k = 21 keys: the int64 sort feeds the same int32 scans (the run
    ids' cumsum on the weighted join, the two fills on the unweighted
    one)."""
    from pangaea_tpu_torch.kernels import features as kf
    keys, w = _int64_keys((1 << 20) + 321, 11 + weighted)
    before = [fn.launches for fn in scan.WRAPPERS]
    if weighted:
        want = kf.sortjoin_bins_weighted(keys, w, k=21, window=2,
                                         vector_size=60)
        got = kf.sortjoin_bins_weighted(keys.to(cuda), w.to(cuda), k=21,
                                        window=2, vector_size=60)
    else:
        want = kf.sortjoin_bins(keys, k=21, window=2, vector_size=60)
        got = kf.sortjoin_bins(keys.to(cuda), k=21, window=2, vector_size=60)
    assert [fn.launches - b for fn, b in zip(scan.WRAPPERS, before)] == \
        ([0, 0, 1] if weighted else [1, 1, 0])
    assert torch.equal(got.cpu(), want)


def test_int64_spill_aggregate_on_card_equals_cpu(cuda):
    from pangaea_tpu_torch.kernels import features as kf
    keys, w = _int64_keys((1 << 20) + 77, 5)
    want = kf.spill_aggregate_weighted(keys, w, k=21)
    got = kf.spill_aggregate_weighted(keys.to(cuda), w.to(cuda), k=21)
    assert got[3:] == want[3:]
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)


def test_table_kernels_on_card_equal_cpu(cuda):
    """count_kmers_global (masked index_add_ into the int32 table) and
    the table lookup of abundance_histogram, card vs CPU, at k = 15."""
    from pangaea_tpu_torch.kernels import features as kf
    gen = torch.Generator().manual_seed(3)
    R, L, G, V = 4096, 152, 64, 400
    codes = torch.randint(0, 4, (R, L), generator=gen, dtype=torch.uint8)
    codes[torch.rand(R, L, generator=gen) < 0.01] = 4
    lengths = torch.randint(0, L + 1, (R,), generator=gen, dtype=torch.int32)
    cont = torch.zeros(R, dtype=torch.uint8)
    seg = torch.sort(torch.randint(-1, G, (R,), generator=gen,
                                   dtype=torch.int32)).values
    out = {}
    for dev in ("cpu", cuda):
        args = [t.to(dev) for t in (codes, lengths, seg, cont)]
        table = kf.make_global_table(15, dev)
        for _ in range(3):   # counts above one window per bin
            kf.count_kmers_global(table, args[0], args[1], args[3], k=15,
                                  overlap=14)
        hist = torch.zeros((G, V), dtype=torch.int32, device=dev)
        kf.abundance_histogram(hist, table, *args, k=15, window=1,
                               vector_size=V, overlap=14)
        out[str(dev)] = (int(table.sum()), hist.cpu())
    assert out["cuda"][0] == out["cpu"][0] > 0
    assert torch.equal(out["cuda"][1], out["cpu"][1])
