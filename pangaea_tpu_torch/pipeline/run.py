"""The 4-step resumable pipeline (reference: src/pangaea.py:23-125).

Port of pangaea_tpu/pipeline/run.py. Step layout and resume markers
mirror the reference exactly:

  1.features/feature_finished      feature extraction
  2.vae/model_finished             VAE training + latent dump
  3.clustering/clustering_finished RPH-KMeans + per-bin read extraction
  4.assembly/assemble_finished     multi-threshold reassembly + ensemble

Each step is skipped when its marker exists (check_steps_finish,
src/pangaea.py:23-35) and can be re-run from its artifacts. Every step
runs on the pipeline's device. Without ``-c``, step 3 picks the cluster
count as pangaea_tpu does: from metaphlan's Shannon diversity when
metaphlan is on PATH and a database is given, else by BIC on the latent
(the skeleton reductions on the device, the skeleton fits in a pool of
``threads`` host processes).
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict

import numpy as np

from pangaea_tpu_torch.config import PangaeaConfig
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.io.extract_reads import extract_reads
from pangaea_tpu_torch.profiling import StageTimer, span, trace
from pangaea_tpu_torch.utils import DeviceLike, replacing, resolve_device

log = logging.getLogger(__name__)

_MARKERS = {
    "1": ("1.features", "feature_finished"),
    "2": ("2.vae", "model_finished"),
    "3": ("3.clustering", "clustering_finished"),
    "4": ("4.assembly", "assemble_finished"),
}


def check_step_finished(output: str, step: str) -> bool:
    sub, marker = _MARKERS[step]
    d = os.path.join(output, sub)
    return os.path.isdir(d) and os.path.exists(os.path.join(d, marker))


class Pipeline:
    def __init__(self, cfg: PangaeaConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.feature_dir = os.path.join(cfg.output, "1.features")
        self.model_dir = os.path.join(cfg.output, "2.vae")
        self.cluster_dir = os.path.join(cfg.output, "3.clustering")
        self.assembly_dir = os.path.join(cfg.output, "4.assembly")
        self._fe_pending = None
        # the step-1 extractor of the last run (window counts, phases)
        self.feature_extractor = None
        # step 3's cluster count, where it came from, and the seconds of
        # its final RPH-k-means and its read extraction
        self.cluster_stats: dict = {}
        # step 2's (epoch, batch, val loss) per eval, the fused loop's
        # phase_times, and the seconds of its set-up, fit and latent dump
        self.train_stats: dict = {}
        # step 4's sub-stage seconds, counts and backends (asm/final.py)
        self.assembly_stats: dict = {}
        self.timer = StageTimer()

    # ---- step 1 -----------------------------------------------------------

    def step1_features(self):
        fe = FeatureExtractor(self.cfg.feature, self.feature_dir,
                              device=self.device)
        self.feature_extractor = fe
        out = fe.extract_features(self.cfg.reads1, self.cfg.reads2,
                                  self.cfg.interleaved_reads,
                                  defer_save=True)
        self._fe_pending = fe
        return out

    def finish(self) -> None:
        """Join the deferred step-1 artifact write (extract_features
        defer_save), overlapped behind steps 2/3 and settled before the
        pipeline reports success."""
        fe, self._fe_pending = self._fe_pending, None
        if fe is not None:
            fe.wait_save()

    # ---- step 2 -----------------------------------------------------------

    def step2_train(self, names=None, abd=None, tnf=None):
        from pangaea_tpu_torch.model import BarcodeDataset, VAE, VAETrainer
        import torch
        if names is None or abd is None or tnf is None:
            self.finish()  # the disk load needs step 1's deferred write
            fe = FeatureExtractor(self.cfg.feature, self.feature_dir,
                                  device=self.device)
            names, abd, tnf = fe.load_features()
        os.makedirs(self.model_dir, exist_ok=True)
        with span("step2.setup") as setup:
            ds = BarcodeDataset(names, abd, tnf)
            m = self.cfg.model
            model = VAE(abd_dim=ds.abd_dim, tnf_dim=ds.tnf_dim,
                        hidden_sizes=tuple(m.hidden_sizes),
                        latent_dim=m.latent_dim, dropout=m.dropout,
                        negative_slope=m.negative_slope,
                        matmul_dtype=m.matmul_dtype,
                        generator=torch.Generator().manual_seed(m.seed))
            trainer = VAETrainer(model, m, device=self.device)
            rng = np.random.RandomState(m.seed)
        with span("step2.fit") as fit:
            state = trainer.fit(ds, self.model_dir, rng=rng)
        with span("step2.latent") as latent:
            trainer.dump_latent(ds, self.model_dir, state, rng=rng)
        self.train_stats = {"val_history": list(trainer.val_history),
                            "phase_times": dict(trainer.phase_times),
                            "setup_s": setup.seconds, "fit_s": fit.seconds,
                            "latent_s": latent.seconds}
        with open(os.path.join(self.model_dir, "model_finished"), "w") as f:
            f.write("model finished")

    # ---- step 3 -----------------------------------------------------------

    def _estimate_k(self) -> int:
        """Diversity-based auto-k (src/clustering.py:93-103): metaphlan
        shannon diversity * 8. Falls back to BIC-based selection on the
        latent when metaphlan is unavailable (pangaea_tpu's choice: the
        reference hard-fails without its >25 GB DB)."""
        from pangaea_tpu_torch.utils import cpu_count, which
        cfg = self.cfg
        stats = self.cluster_stats
        if which("metaphlan") and cfg.metaphlan_db:
            from pangaea_tpu_torch.asm.diversity import metaphlan_shannon
            reads = cfg.reads1 or cfg.interleaved_reads
            shannon = metaphlan_shannon(reads, cfg.metaphlan_db,
                                        self.cluster_dir)
            k = int(cfg.cluster.diversity_multiplier * shannon)
            stats.update(k_source="metaphlan", shannon=shannon)
            log.info("estimated num_classes: %d", k)
            return k
        log.info("metaphlan unavailable; selecting k by BIC on the latent")
        from pangaea_tpu_torch.cluster import select_k_with_bic
        emb = np.load(os.path.join(self.model_dir, "latent.npz"))["arr_0"]
        stats["k_source"] = "bic"
        k, _, _ = select_k_with_bic(emb, kmax=100, kmin=4, ske_repeat=5,
                                    k_repeat=2, random_state=0,
                                    device=self.device,
                                    workers=cfg.threads or cpu_count(),
                                    stats=stats)
        log.info("estimated num_classes: %d", k)
        return k

    def step3_cluster(self):
        from pangaea_tpu_torch.cluster import clustering_rph_kmeans
        cfg = self.cfg
        os.makedirs(self.cluster_dir, exist_ok=True)
        out_tsv = os.path.join(self.cluster_dir, "clusters.tsv")
        out_npz = os.path.join(self.cluster_dir, "clusters.npz")
        self.cluster_stats = {}
        if not os.path.isfile(out_tsv):
            emb = np.load(os.path.join(self.model_dir, "latent.npz"))["arr_0"]
            bcs = np.load(os.path.join(self.model_dir, "barcodes.npz"),
                          allow_pickle=True)["arr_0"]
            k = cfg.cluster.n_clusters or self._estimate_k()
            # seeded: the reference's rph_kmeans draws from the GLOBAL
            # np.random that init_all seeds to 2021 (utils.py:84-88)
            with span("step3.rph") as rph:
                clusters = clustering_rph_kmeans(
                    emb, k, n_init=cfg.cluster.n_init,
                    random_state=cfg.model.seed, device=self.device)
            self.cluster_stats.update(k=k, rph_s=rph.seconds)
            np.savez(out_npz, clusters)
            c2b = defaultdict(list)
            for i in range(len(bcs)):
                c2b[clusters[i]].append(str(bcs[i]))
            with replacing(out_tsv) as tmp, open(tmp, "w") as tsv:
                for cid, bclist in c2b.items():
                    tsv.write("{}\t{}\n".format(cid, ",".join(bclist)))
        else:
            log.info("existing clustering result found")
        with span("step3.extract") as extract:
            extract_reads(out_tsv, os.path.join(self.cluster_dir, "cluster"),
                          reads1=cfg.reads1, reads2=cfg.reads2,
                          interleaved=cfg.interleaved_reads)
        self.cluster_stats["extract_s"] = extract.seconds
        with open(os.path.join(self.cluster_dir, "clustering_finished"),
                  "w") as f:
            f.write("finished")

    # ---- step 4 -----------------------------------------------------------

    def step4_assemble(self):
        from pangaea_tpu_torch.asm.final import final_assemble
        self.assembly_stats = {}
        final_assemble(self.cfg, self.cluster_dir, self.assembly_dir,
                       device=self.device, stats=self.assembly_stats)

    # ---- run --------------------------------------------------------------

    def run(self) -> None:
        cfg = self.cfg
        steps = cfg.steps.split(",")
        timer = self.timer
        feats = None
        with trace("pipeline"):
            if "1" not in steps:
                log.info("skip step 1: feature extraction")
            elif check_step_finished(cfg.output, "1"):
                log.info("step 1: feature extraction finished")
            else:
                with timer.stage("step1_features"):
                    feats = self.step1_features()

            if "2" not in steps:
                log.info("skip step 2: training")
            elif check_step_finished(cfg.output, "2"):
                log.info("step 2: training finished")
            else:
                with timer.stage("step2_train"):
                    self.step2_train(*(feats or (None, None, None)))

            if "3" not in steps:
                log.info("skip step 3: clustering")
            elif check_step_finished(cfg.output, "3"):
                log.info("step 3: clustering finished")
            else:
                log.info("start clustering")
                with timer.stage("step3_cluster"):
                    self.step3_cluster()

            if "4" not in steps:
                log.info("skip step 4: assembly")
            elif check_step_finished(cfg.output, "4"):
                log.info("step 4: assembly finished")
            else:
                log.info("start assembly")
                with timer.stage("step4_assemble"):
                    self.step4_assemble()
            self.finish()
        timer.dump(os.path.join(cfg.output, "metrics.json"))
        log.info("program finished successfully")
