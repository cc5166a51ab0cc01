"""The control, the plain reference with TF32 matmuls put in the
program's place, fails the comparison's latent limit; the float32
reference run twice passes it."""

import json
import os

import numpy as np
import torch

from benchmark import compare, gen, reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0])
    assert reference._round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9,
                                                 -3.0]


def test_tf32_control_fails_the_latent_limit():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "10x-atcc.json")) as f:
        cfg = json.load(f)
    cfg.update(genome_len=30000, molecule_len=8000)
    cfg["binning"].update(epochs=30, batch=64)
    inp = gen.simulate(cfg, {"barcodes": 200, "pairs_per_barcode": 10}, 3)
    ref = compare.build_reference(inp, cfg["binning"], "cpu")
    again = reference.latent(ref.names, ref.abd, ref.tnf, cfg["binning"],
                             "cpu")
    assert compare.latent_gap(*again, ref) == 0.0
    ctrl = reference.latent(ref.names, ref.abd, ref.tnf, cfg["binning"],
                            "cpu", precision="tf32")
    gap = compare.latent_gap(*ctrl, ref)
    assert np.isfinite(gap) and gap > cfg["limits"]["latent_gap"]
