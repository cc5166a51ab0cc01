"""Operations and bytes of the work the program was asked to do, from its
shapes: step 2's matmuls and the scan kernel's traffic."""

from __future__ import annotations

from typing import Sequence


def vae_layers(in_dim: int, hidden: Sequence[int], latent: int):
    """(fan_in, fan_out) of every matmul of the VAE: the encoder, the mu
    and sigma heads, the decoder and the output layer."""
    enc = list(zip((in_dim,) + tuple(hidden)[:-1], hidden))
    heads = [(hidden[-1], latent)] * 2
    rsizes = (latent,) + tuple(hidden)[::-1]
    dec = list(zip(rsizes[:-1], rsizes[1:]))
    return enc + heads + dec + [(hidden[0], in_dim)]


def step2_flops(in_dim: int, hidden: Sequence[int], latent: int,
                train_rows: int, val_rows: int, embed_rows: int) -> int:
    """Matmul FLOPs of a training run: 2 per multiply-add. A train row
    costs the forward, the weight gradients and the input gradients of
    every layer but the first (the features take no gradient); a val row
    the forward; a latent-dump row the encoder and the mu head."""
    layers = vae_layers(in_dim, hidden, latent)
    macs = [a * b for a, b in layers]
    fwd = sum(macs)
    train = fwd + sum(macs) + sum(macs[1:])
    embed = sum(macs[:len(hidden)]) + macs[len(hidden)]
    return 2 * (train * train_rows + fwd * val_rows + embed * embed_rows)


def scan_bytes(lengths: Sequence[int]) -> int:
    """An int32 scan reads and writes each element once: 8 bytes."""
    return 8 * sum(lengths)
