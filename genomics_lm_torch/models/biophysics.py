"""Biophysics shape encoder (twin of ``genomics_lm_tpu/models/biophysics.py``).

A small 1D CNN (4→32 conv k=5 same-pad, exact GELU, 32→d_shape conv k=3
stride 3) compresses (B, 3L, 4) one-hot DNA to (B, L, d_shape)
codon-aligned shape features (MGW/Roll/EP), the input of the model's
``shape_proj`` under shape guidance. The weights keep the JAX layout:
``conv_general_dilated`` with ("NCH", "OIH", "NCH") is a cross-correlation
over an (out, in, k) kernel, which is what ``F.conv1d`` computes on the
same tensor. ``shape_lookup_table`` turns token ids into the nucleotide
one-hots from the port's own vocabulary copy. ``get_theoretical_shape``,
``one_hot_dna`` and ``generate_shape_training_data`` are numpy copies.

``train_encoder`` fits the encoder to the synthetic shape targets by MSE
with AdamW, as JAX's does: the batch order from
``np.random.default_rng(seed).permutation`` each epoch, and optax
``adamw``'s defaults passed to ``torch.optim.AdamW`` explicitly (b1 0.9, b2
0.999, eps 1e-8 and weight decay 1e-4, where torch's own default decay is
1e-2). ``encoder_tree`` and ``encoder_from_tree`` move the weights to and
from the JAX layout ``{"conv1": {"w", "b"}, "conv2": {"w", "b"}}``, which
is the layout of the encoder checkpoint both trainers read.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BASE_TO_IDX = {"A": 0, "C": 1, "G": 2, "T": 3}


def get_theoretical_shape(dna_seq: str) -> dict[str, list[float]]:
    """Heuristic DNAshape parameters (pentamer-window approximations)."""
    mgw, roll, ep = [], [], []
    for i in range(len(dna_seq)):
        window = dna_seq[max(0, i - 2) : min(len(dna_seq), i + 3)]
        if "AAAA" in window:
            m_val = 3.5
        elif "GGGG" in window or "CCCC" in window:
            m_val = 5.8
        else:
            m_val = 4.5
        if "GC" in window or "CG" in window:
            r_val = 5.0
        elif "AA" in window or "TT" in window:
            r_val = 0.0
        else:
            r_val = 2.5
        if "AAAA" in window:
            e_val = -10.0
        elif "GGCC" in window:
            e_val = -2.0
        else:
            e_val = -5.0
        mgw.append(m_val)
        roll.append(r_val)
        ep.append(e_val)
    return {"MGW": mgw, "Roll": roll, "EP": ep}


class ShapeEncoder(nn.Module):
    """The encoder's weights: ``conv1`` (32, 4, 5) and ``conv2`` (d_shape,
    32, 3), each with a bias, initialized as the JAX ``init_encoder``:
    U(±1/√(in·k)) kernels and zero biases."""

    def __init__(self, d_shape: int = 3, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv1d(4, 32, 5, padding=2)
        self.conv2 = nn.Conv1d(32, d_shape, 3, stride=3)
        for conv, bound in ((self.conv1, 1.0 / math.sqrt(4 * 5)),
                            (self.conv2, 1.0 / math.sqrt(32 * 3))):
            with torch.no_grad():
                conv.weight.uniform_(-bound, bound, generator=generator)
                conv.bias.zero_()

    def forward(self, one_hot: torch.Tensor) -> torch.Tensor:
        return encode(self, one_hot)


def encode(encoder: ShapeEncoder, one_hot: torch.Tensor) -> torch.Tensor:
    """(B, 3L, 4) one-hot nucleotides → (B, L, d_shape) codon shapes."""
    x = one_hot.transpose(1, 2)  # (B, 4, 3L): channels first
    x = F.conv1d(x, encoder.conv1.weight, encoder.conv1.bias, padding=2)
    x = F.gelu(x)
    x = F.conv1d(x, encoder.conv2.weight, encoder.conv2.bias, stride=3)
    return x.transpose(1, 2)


def one_hot_dna(seq: str) -> np.ndarray:
    out = np.zeros((len(seq), 4), np.float32)
    for i, base in enumerate(seq.upper()):
        idx = BASE_TO_IDX.get(base)
        if idx is not None:
            out[i, idx] = 1.0
    return out


def generate_shape_training_data(
    num_samples: int = 5000, seq_len_codons: int = 50, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Random DNA + codon-averaged theoretical shape targets (ref parity)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    seq_len_nt = 3 * seq_len_codons
    one_hots, targets = [], []
    for _ in range(num_samples):
        seq = "".join(rng.choice(bases, seq_len_nt))
        one_hots.append(one_hot_dna(seq))
        shapes = get_theoretical_shape(seq)
        nt_shapes = np.stack(
            [shapes["MGW"], shapes["Roll"], shapes["EP"]], axis=-1
        ).astype(np.float32)
        targets.append(nt_shapes.reshape(seq_len_codons, 3, 3).mean(axis=1))
    return np.stack(one_hots), np.stack(targets)


def encoder_tree(encoder: ShapeEncoder) -> dict:
    """The encoder's weights in the JAX layout, as float32 numpy arrays."""
    return {conv: {"w": getattr(encoder, conv).weight.detach().cpu().numpy().copy(),
                   "b": getattr(encoder, conv).bias.detach().cpu().numpy().copy()}
            for conv in ("conv1", "conv2")}


def encoder_from_tree(tree: dict, device: str | torch.device = "cpu") -> ShapeEncoder:
    """A ``ShapeEncoder`` holding the JAX-layout weights ``tree``."""
    encoder = ShapeEncoder(int(np.shape(tree["conv2"]["w"])[0])).to(device)
    with torch.no_grad():
        for conv in ("conv1", "conv2"):
            for leaf, name in (("w", "weight"), ("b", "bias")):
                getattr(getattr(encoder, conv), name).copy_(
                    torch.from_numpy(np.array(tree[conv][leaf], np.float32)))
    return encoder


def train_encoder(
    *, num_samples: int = 2000, seq_len_codons: int = 32, epochs: int = 5,
    batch_size: int = 64, lr: float = 1e-3, seed: int = 0,
    init: dict | None = None, device: str | torch.device | None = None,
) -> tuple[ShapeEncoder, list[float]]:
    """Fit the encoder to the synthetic shape targets (MSE, AdamW) on
    ``device`` (default: the CUDA card). ``init`` is a JAX-layout tree to
    start from (e.g. JAX's ``init_encoder``); without it the encoder starts
    from ``ShapeEncoder``'s init on a generator seeded with ``seed``.
    Returns the encoder and each epoch's mean batch loss."""
    from genomics_lm_torch.utils.device import resolve_device

    device = resolve_device(device)
    X, Y = generate_shape_training_data(num_samples, seq_len_codons, seed)
    if init is not None:
        encoder = encoder_from_tree(init, device)
    else:
        encoder = ShapeEncoder(generator=torch.Generator().manual_seed(seed)).to(device)
    opt = torch.optim.AdamW(encoder.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    X = torch.from_numpy(X).to(device)
    Y = torch.from_numpy(Y).to(device)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(epochs):
        order = rng.permutation(len(X))
        batch_losses = []
        for start in range(0, len(order), batch_size):
            rows = torch.from_numpy(order[start : start + batch_size]).to(device)
            loss = (encode(encoder, X[rows]) - Y[rows]).pow(2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            batch_losses.append(loss.detach())
        # one read of the epoch's losses, summed in order on the host as JAX's
        losses.append(float(sum(float(v) for v in torch.stack(batch_losses).cpu()))
                      / max(len(batch_losses), 1))
    return encoder, losses


def shape_lookup_table() -> np.ndarray:
    """(vocab, 3, 4) one-hot LUT: token id → its 3 nucleotide one-hots
    (special tokens: zeros)."""
    from genomics_lm_torch.tokenizers.codon import CODON_BASE_ID, CODONS, VOCAB

    table = np.zeros((len(VOCAB), 3, 4), np.float32)
    for i, codon in enumerate(CODONS):
        for pos, base in enumerate(codon):
            table[CODON_BASE_ID + i, pos, BASE_TO_IDX[base]] = 1.0
    return table


__all__ = [
    "ShapeEncoder",
    "encode",
    "encoder_from_tree",
    "encoder_tree",
    "generate_shape_training_data",
    "get_theoretical_shape",
    "one_hot_dna",
    "shape_lookup_table",
    "train_encoder",
]
