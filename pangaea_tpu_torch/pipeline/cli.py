"""CLI mirroring the reference's argparse surface (src/pangaea.py:129-175).

Usage: ``python -m pangaea_tpu_torch.pipeline.cli -i reads.fq.gz -o out -c 30``
(without ``-c``, step 3 picks the cluster count: metaphlan's Shannon
diversity with ``-m DB`` when metaphlan is on PATH, else BIC on the
latent, with its skeleton fits in ``-t`` host processes; 0, the default,
means every CPU the process may run on).

The flags are pangaea_tpu's (pipeline/cli.py:17-71) plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions), and the
default steps are the same ``1,2,3,4``. ``--cluster_device_min_elems``
(pangaea_tpu's host routing of small clustering fits) is accepted by the
parser and rejected with an error: step 3 runs on ``--device``. ``-k`` takes 1..31, the reference's uint64 k-mers (k > 15 runs the
sort-join on int64 keys).
"""

from __future__ import annotations

import argparse
import logging
import sys

from pangaea_tpu_torch.config import (AssemblyConfig, ClusterConfig,
                                      FeatureConfig, ModelConfig,
                                      PangaeaConfig)

# (dest, value the port can honour) of the flags it does not honour
_UNPORTED = (
    ("cluster_device_min_elems", None),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pangaea_tpu_torch")
    p.add_argument("-1", "--reads1", default="",
                   help="path to reads1 file (linked-reads)")
    p.add_argument("-2", "--reads2", default="",
                   help="path to reads2 file (linked-reads)")
    p.add_argument("-i", "--interleaved_reads", default="",
                   help="path to interleaved reads file")
    p.add_argument("-o", "--output", required=True, help="output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    # feature
    p.add_argument("-l", "--min_length", type=int, default=2000)
    p.add_argument("-k", "--kmer", type=int, default=15)
    p.add_argument("-tnf_k", "--tnf_kmer", type=int, default=4)
    p.add_argument("-s", "--window_size", type=int, default=10)
    p.add_argument("-v", "--vector_size", type=int, default=400)
    # model
    p.add_argument("-r", "--lr", type=float, default=0.005)
    p.add_argument("-w", "--weight_decay", type=float, default=0.0001)
    p.add_argument("-e", "--epochs", type=int, default=100)
    p.add_argument("-b", "--batch_size", type=int, default=2048)
    p.add_argument("-d", "--dropout", type=float, default=0.2)
    p.add_argument("-p", "--patience", type=int, default=20)
    p.add_argument("-wa", "--weight_alpha", type=float, default=0.1)
    p.add_argument("-wk", "--weight_kl", type=float, default=0.015)
    p.add_argument("-ld", "--latent_dim", type=int, default=32)
    p.add_argument("--matmul_dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="VAE matmul precision: bfloat16 rounds the matmul "
                        "operands, accumulating in float32")
    # others
    p.add_argument("-c", "--clusters", type=int, default=None,
                   help="number of clusters; without it, metaphlan "
                        "diversity (-m) or BIC on the latent picks it")
    p.add_argument("--cluster_device_min_elems", type=int, default=None,
                   help="not ported: step 3 runs on --device")
    p.add_argument("--spill_store",
                   choices=("auto", "device", "host", "disk"),
                   default="auto",
                   help="where past-the-cap spill run ids live "
                        "(FeatureConfig.spill_store)")
    p.add_argument("--spill_dir", default=None,
                   help="directory for disk-backed spill files (flat host "
                        "RSS; implies spill_store=disk under 'auto')")
    p.add_argument("-m", "--metaphlan_db", type=str, default="")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-sp", "--spades", type=str, default="")
    p.add_argument("-lc", "--local_assembly", type=str, default="")
    p.add_argument("-at", "--athena", type=str, default="")
    p.add_argument("-lt", "--low_abd_cut", type=str, default="10,30")
    p.add_argument("-la", "--low_assembler", type=str, default="megahit")
    p.add_argument("-st", "--steps", type=str, default="1,2,3,4")
    return p


def check_supported(p: argparse.ArgumentParser,
                    args: argparse.Namespace) -> None:
    """parser.error() for every flag of a path the port cannot run."""
    for dest, ok in _UNPORTED:
        if getattr(args, dest) != ok:
            p.error(f"--{dest} is not supported by the PyTorch port")
    if not 1 <= args.kmer <= 31:
        p.error(f"-k {args.kmer}: the k-mer length must be 1..31")


def config_from_args(args: argparse.Namespace) -> PangaeaConfig:
    return PangaeaConfig(
        reads1=args.reads1, reads2=args.reads2,
        interleaved_reads=args.interleaved_reads,
        output=args.output, threads=args.threads,
        spades=args.spades, local_assembly=args.local_assembly,
        athena=args.athena, metaphlan_db=args.metaphlan_db,
        steps=args.steps,
        feature=FeatureConfig(
            kmer=args.kmer, tnf_kmer=args.tnf_kmer,
            window_size=args.window_size, vector_size=args.vector_size,
            min_length=args.min_length, spill_store=args.spill_store,
            spill_dir=args.spill_dir),
        model=ModelConfig(
            latent_dim=args.latent_dim, lr=args.lr,
            weight_decay=args.weight_decay, epochs=args.epochs,
            batch_size=args.batch_size, dropout=args.dropout,
            patience=args.patience, weight_alpha=args.weight_alpha,
            weight_kl=args.weight_kl, matmul_dtype=args.matmul_dtype),
        cluster=ClusterConfig(n_clusters=args.clusters),
        assembly=AssemblyConfig(low_abd_cut=args.low_abd_cut,
                                low_assembler=args.low_assembler),
    )


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_supported(parser, args)
    cfg = config_from_args(args)
    from pangaea_tpu_torch.utils import init_all
    init_all(seed=cfg.model.seed, threads=cfg.threads, logfile="log",
             level=logging.INFO, outdir=cfg.output)
    logging.info("command: " + " ".join(sys.argv))
    from pangaea_tpu_torch.pipeline.run import Pipeline
    Pipeline(cfg, device=args.device).run()


if __name__ == "__main__":
    main()
