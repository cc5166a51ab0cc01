"""Unified typed configuration for the whole pipeline.

The same dataclass tree as pangaea_tpu's config, field for field, with the
*effective* reference defaults (the values the reference's Python layer
actually passes down), so a configuration means the same in both
packages. Fields that select a path this port does not run yet are kept
(and rejected where they are read) so that configurations stay
interchangeable; ROADMAP.md queues those paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FeatureConfig:
    """Feature-extraction knobs (reference: src/pangaea.py:138-142)."""

    kmer: int = 15            # abundance k-mer (-k), 1..31
    tnf_kmer: int = 4         # TNF k-mer (-tnf_k); long reads use 3
    window_size: int = 10     # abundance histogram bin width (-s)
    vector_size: int = 400    # abundance histogram bins (-v)
    min_length: int = 2000    # min concatenated barcode length (-l)
    # Replicate the reference's barcode boundary leak: a read pair is
    # appended to the running per-barcode group *before* the barcode-change
    # check (count_kmer.cpp:199-219 paired, :246-270 interleaved), so the
    # first pair of each new barcode lands in the previous barcode's group.
    # Required for byte-identical feature CSVs.
    bug_compat_boundary_leak: bool = True
    # jellyfish --min-qual-char=? is always applied on the paired-reads
    # path (src/feature.py:76-86) and never on the interleaved path
    # (src/feature.py:94); the sort-join reproduces it with the weighted
    # (masked-global) join. None counts paired input unmasked.
    min_qual_char: Optional[str] = "?"
    # Host-side streaming batch geometry.
    reads_per_batch: int = 65536
    max_read_len: int = 256
    # Pre-scan a read-length sample and pack rows at the observed maximum
    # (rounded up to 8) instead of max_read_len: padding windows beyond
    # the read carry the sort/histogram sentinel but still cost work. A
    # longer read appearing later is still exact: the native reader
    # raises and step 1 reruns once at max_read_len (the Python packer
    # splits it across continuation rows).
    auto_row_len: bool = True
    # Group-histogram implementation: 'auto' or 'sortjoin' run the
    # sort-join (every k); 'scatter' or 'segsum' run the dense 4^k table
    # (k <= 15; pangaea_tpu's 'segsum' is a TPU formulation of the same
    # outputs, and the port runs one table path for both).
    hist_impl: str = "auto"
    # Host->device code-matrix transfer packing in pangaea_tpu. The port
    # uploads uint8 codes from pinned memory and does not read this.
    pack_transfers: str = "auto"
    # Device window cap: k-mer windows held and sorted on the device at
    # once. A larger stream spills (decided up front from a sample of the
    # file, or mid-stream) and is still read once.
    sortjoin_max_windows: int = 256 * 1024 * 1024
    # Past-the-cap spill: 'auto'/'on' aggregate each chunk of
    # spill_agg_windows windows on the device (sort + run-length encode)
    # and join only the unique runs; 'off' moves the raw keys to host RAM
    # and joins them one key range at a time.
    spill_agg: str = "auto"
    spill_agg_windows: int = 32 * 1024 * 1024
    # Where the aggregated spill's per-window run ids and unique runs
    # live: 'device', 'host' (RAM) or 'disk' (files under spill_dir, flat
    # host RSS). 'auto' = disk when spill_dir is set, else device until
    # spill_device_budget bytes, then host.
    spill_store: str = "auto"
    spill_dir: Optional[str] = None
    spill_device_budget: int = 4 * 1024 * 1024 * 1024


@dataclass
class ModelConfig:
    """VAE + training knobs (reference: src/pangaea.py:144-152)."""

    latent_dim: int = 32
    hidden_sizes: tuple = (512, 512)
    lr: float = 0.005
    weight_decay: float = 1e-4
    epochs: int = 100
    batch_size: int = 2048
    dropout: float = 0.2
    patience: int = 20
    weight_alpha: float = 0.1   # wa/wt split (VAENET.py:21-22)
    weight_kl: float = 0.015    # w_kl (VAENET.py:20)
    # The reference constructs nn.LeakyReLU(True) (VAENET.py:205,217),
    # which sets negative_slope=1.0, i.e. the activation is the identity.
    # Kept as the default for parity; set to 0.01 for a real LeakyReLU.
    negative_slope: float = 1.0
    eval_every_batches: int = 100  # val pass cadence (VAENET.py:64)
    early_stop_delta: float = 1e-6  # (VAENET.py:36)
    val_fraction: float = 0.7       # test_size = min(0.7*N, 1e6) (pangaea.py:86)
    val_max: int = 1_000_000
    seed: int = 2021                # init_all(seed=2021) (pangaea.py:52)
    # matmul precision: 'float32' (reference numerics) or 'bfloat16'
    # (operands rounded to bfloat16, float32 accumulation and result).
    matmul_dtype: str = "float32"


@dataclass
class ClusterConfig:
    """RPH-KMeans knobs (reference: src/clustering.py:14-19 +
    third_parties/rph_kmeans/rph_kmeans/rph_kmeans_.py:12-15)."""

    n_clusters: Optional[int] = None  # -c; None => diversity-based auto-k
    n_init: int = 20                  # RPHKMeans(n_init=20) (clustering.py:17)
    max_point: int = 2000
    proj_num: int = 5
    max_iter: int = 1000
    sample_dist_num: int = 1000
    w: Optional[float] = None         # None => half median pairwise distance
    # final / skeleton KMeans
    kmeans_max_iter: int = 300
    kmeans_tol: float = 1e-4
    skeleton_n_init: int = 10         # sklearn KMeans default n_init
    # auto-k: k = int(8 * shannon_diversity) (clustering.py:100-101)
    diversity_multiplier: float = 8.0
    # pangaea_tpu sends fits below this many latent elements to the host
    # CPU. The port runs step 3 on the pipeline's device and does not
    # read it (ROADMAP.md queues the decision).
    device_min_elems: int = 8_000_000


@dataclass
class AssemblyConfig:
    """Step-4 knobs (reference: src/pangaea.py:163-164, clustering.py:132-164),
    read by asm/final.py and asm/circularize.py. ``max_concurrent_bins``,
    ``seed_min_len``, ``seed_copies``, ``containment_slack`` and
    ``flye_min_overlap`` are not read (as in pangaea_tpu: the modules
    use their reference defaults)."""

    low_abd_cut: str = "10,30"
    low_assembler: str = "megahit"    # or "spades"
    max_concurrent_bins: int = 5      # bin_assembly.sh:20-27
    max_concurrent_reassembly: int = 5  # clustering.py:156-159
    # extract_unmapped filters (extract_unmapped.cpp:142-144)
    min_aligned_columns: int = 60
    min_identity: float = 0.95
    # merge_olc (scripts/merge_olc.py:79-90)
    seed_min_len: int = 1000
    seed_copies: int = 6
    containment_slack: int = 1000
    flye_min_overlap: int = 1000
    # Lathe circularization (third_parties/Lathe/Snakefile:20-34)
    circularize_min_size: int = 1_700_000
    terminal_window: int = 50_000


@dataclass
class ParallelConfig:
    """Multi-device knobs (the reference is single-node CPU), read by
    ``parallel.initialize_distributed``: one process per device in a
    ``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU).
    ``coordinator_address`` is the rendezvous (``tcp://host:port``,
    ``file://path`` or ``host:port``), ``num_processes`` the world size
    and ``process_id`` this process's rank; without an address the group
    reads torchrun's environment variables. ``data_axis`` and
    ``num_devices`` name pangaea_tpu's mesh and have no use here: the
    world size is the number of processes."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None => all visible devices
    use_distributed: bool = False
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclass
class PangaeaConfig:
    # IO
    reads1: str = ""
    reads2: str = ""
    interleaved_reads: str = ""
    output: str = "pangaea_out"
    threads: int = 0  # 0 => os.cpu_count()

    # ensemble inputs (paths to external assembler outputs)
    spades: str = ""          # -sp seed/template contigs
    local_assembly: str = ""  # -lc athena local contigs (flye-input-contigs.fa)
    athena: str = ""          # -at athena.asm.fa
    metaphlan_db: str = ""

    steps: str = "1,2,3,4"

    feature: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    assembly: AssemblyConfig = field(default_factory=AssemblyConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "PangaeaConfig":
        return dataclasses.replace(self, **kw)
