"""Motif mining (twin of ``genomics_lm_tpu/evals/motifs.py``): sliding-window
hidden states, clustering, consensus, PWMs and the known-motif library.

``extract_window_embeddings`` runs the port's ``codon_gpt.hidden_states``
(the flash forward on the card under ``attention_impl="flash"``) once over
all rows and pools on the model's device: each window's mean over its
block states, with the windows holding an excluded id dropped by a
windowed count, so only the kept embeddings cross to the host, once. The
clustering runs on the host with the port's PCA, KMeans and HDBSCAN
(``evals/clustering.py``, sklearn 1.9.0's arithmetic without sklearn); the
consensus, the PWM functions and the library are numpy copies.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from genomics_lm_torch.evals.clustering import HDBSCAN, PCA, KMeans
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.utils.device import module_device

KNOWN_MOTIFS = {
    "Shine-Dalgarno": {
        "sequence": "AGGAGG",
        "type": "ribosome_binding_site",
        "description": "Recruits the ribosome to the mRNA for translation initiation.",
        "location": "5-10 bp upstream of START",
    },
    "Pribnow_Box": {
        "sequence": "TATAAT",
        "type": "promoter_10",
        "description": "Core promoter element (-10 box) that facilitates DNA melting.",
        "location": "~10 bp upstream of Transcription Start",
    },
    "TTGACA_Box": {
        "sequence": "TTGACA",
        "type": "promoter_35",
        "description": "Promoter element (-35 box) for initial RNA polymerase binding.",
        "location": "~35 bp upstream of Transcription Start",
    },
    "START_Codon": {
        "sequence": "ATG",
        "type": "initiation",
        "description": "The most common translation start signal.",
        "location": "Start of CDS",
    },
    "Poly-U_Tract": {
        "sequence": "TTTTTT",
        "type": "terminator",
        "description": "U-rich region for Rho-independent transcription termination.",
        "location": "Downstream of STOP",
    },
}


@torch.no_grad()
def extract_window_embeddings(
    model: codon_gpt.CodonGPT,
    cfg: CodonGPTConfig,
    input_ids: np.ndarray,
    *,
    window_size: int = 9,
    stride: int = 1,
    layer_idx=-1,
    exclude_ids=None,
):
    """Mean-pooled sliding-window block states → (N, D·L_sel), metadata.

    ``layer_idx`` selects one or several block outputs 1..L (concatenated on
    the feature axis in layer order); windows containing any
    ``exclude_ids`` token are skipped. Rows come out in JAX's order (by
    row, then window start) with JAX's ``(row, start, end)`` metadata; the
    means are float32 (a bf16 model's states are averaged in float32).
    """
    device = module_device(model)
    idx = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
    states = codon_gpt.hidden_states(model, cfg, idx)
    block_states = [h for tag, h in states if isinstance(tag, int) and tag >= 1]
    n_layers = len(block_states)
    if isinstance(layer_idx, int):
        targets = [layer_idx % n_layers]
    else:
        targets = sorted(i % n_layers for i in layer_idx)
    all_states = torch.cat([block_states[i].float() for i in targets], dim=-1)
    del states, block_states

    B, T, D = all_states.shape
    if T < window_size:
        return np.zeros((0, D), np.float32), []
    means = all_states.unfold(1, window_size, stride).mean(dim=-1)  # (B, windows, D)
    if exclude_ids:
        excluded = torch.isin(idx, torch.as_tensor(sorted(set(exclude_ids)), device=device))
        hits = excluded.to(torch.int32).unfold(1, window_size, stride).sum(dim=-1)
        keep = hits == 0
    else:
        keep = torch.ones(means.shape[:2], dtype=torch.bool, device=device)
    rows, windows = (t.tolist() for t in torch.nonzero(keep, as_tuple=True))
    if not rows:
        return np.zeros((0, D), np.float32), []
    embeddings = means[keep].cpu().numpy()
    metadata = [(b, w * stride, w * stride + window_size) for b, w in zip(rows, windows)]
    return embeddings, metadata


class MotifClusterer:
    """KMeans/HDBSCAN clustering of window embeddings (optional PCA)."""

    def __init__(self, method="kmeans", n_clusters=10, pca_components=None, random_state=42):
        self.method = method
        self.n_clusters = n_clusters
        self.pca_components = pca_components
        self.random_state = random_state
        self.model = None
        self.pca = None
        self.labels = None

    def fit_predict(self, embeddings: np.ndarray) -> np.ndarray:
        X = embeddings
        if self.pca_components:
            n_comp = min(self.pca_components, X.shape[1], X.shape[0])
            self.pca = PCA(n_components=n_comp, random_state=self.random_state)
            X = self.pca.fit_transform(X)
        if self.method == "kmeans":
            self.model = KMeans(n_clusters=self.n_clusters, random_state=self.random_state)
        elif self.method == "hdbscan":
            self.model = HDBSCAN(min_cluster_size=max(2, self.n_clusters))
        else:
            raise ValueError(f"Unknown clustering method: {self.method}")
        self.labels = self.model.fit_predict(X)
        return self.labels

    def get_centers(self, embeddings: np.ndarray) -> np.ndarray:
        if self.method == "kmeans":
            return self.model.cluster_centers_
        centers = []
        for label in sorted(set(self.labels)):
            if label == -1:
                continue
            centers.append(embeddings[self.labels == label].mean(axis=0))
        return np.asarray(centers)


def cluster_consensus(
    input_ids: np.ndarray,
    metadata: list[tuple[int, int, int]],
    labels: np.ndarray,
    itos: dict[int, str],
) -> dict[int, str]:
    """Per-cluster positionwise majority-token consensus (mine_motifs.py)."""
    consensus: dict[int, str] = {}
    for label in sorted(set(int(l) for l in labels)):
        if label == -1:
            continue
        members = [m for m, l in zip(metadata, labels) if int(l) == label]
        if not members:
            continue
        width = members[0][2] - members[0][1]
        columns: list[Counter] = [Counter() for _ in range(width)]
        for b, start, end in members:
            for offset in range(width):
                columns[offset][int(input_ids[b, start + offset])] += 1
        consensus[label] = " ".join(
            itos.get(col.most_common(1)[0][0], "?") for col in columns
        )
    return consensus


def position_weight_matrix(sequences, vocab: list[str]) -> np.ndarray:
    """PWM over aligned token sequences → (len(vocab), L) probability matrix.

    Parity: reference ``src/eval/motif_analysis.py:4-33`` (``calculate_pwm``)
    — per-position token frequencies normalized by the number of sequences;
    tokens outside ``vocab`` contribute no counts (so columns may sum to <1
    if unknown tokens appear). Returns a plain ndarray with rows following
    ``vocab`` order instead of a DataFrame.
    """
    vocab = list(vocab)
    if not len(sequences):
        return np.zeros((len(vocab), 0), dtype=np.float64)
    width = len(sequences[0])
    index = {token: i for i, token in enumerate(vocab)}
    counts = np.zeros((len(vocab), width), dtype=np.float64)
    for seq in sequences:
        for pos, token in enumerate(seq):
            row = index.get(token)
            if row is not None:
                counts[row, pos] += 1.0
    return counts / len(sequences)


def pwm_consensus(pwm: np.ndarray, vocab: list[str], sep: str = "") -> str:
    """Highest-probability token per PWM column, ``sep``-joined.

    Parity: reference ``src/eval/motif_analysis.py:35-41`` (``get_consensus``).
    """
    if pwm.size == 0:
        return ""
    return sep.join(vocab[i] for i in np.argmax(pwm, axis=0))


def pwm_entropy(pwm: np.ndarray) -> np.ndarray:
    """Shannon entropy (bits) per PWM column, ``-Σ p·log2(p + 1e-9)``.

    Parity: reference ``src/eval/motif_analysis.py:43-53``
    (``get_shannon_entropy``), including the 1e-9 log guard.
    """
    if pwm.size == 0:
        return np.array([])
    return -np.sum(pwm * np.log2(pwm + 1e-9), axis=0)


def pwm_information_content(pwm: np.ndarray, vocab_size: int) -> np.ndarray:
    """Per-position information content in bits: log2(V) − H(position).

    Repo addition on top of the reference's entropy scoring — the standard
    sequence-logo height, useful for ranking positions by conservation.
    """
    entropy = pwm_entropy(pwm)
    if entropy.size == 0:
        return entropy
    return np.log2(float(vocab_size)) - entropy


def cluster_pwm_report(
    input_ids: np.ndarray,
    metadata: list[tuple[int, int, int]],
    labels: np.ndarray,
    itos: dict[int, str],
) -> dict[int, dict]:
    """Per-cluster PWM consensus + entropy summary over member windows.

    Builds each cluster's aligned member token strings from the window
    metadata, then reports the PWM consensus, mean/min per-position Shannon
    entropy (bits), and total information content — the quantities the
    reference's motif benchmark derives from ``motif_analysis.py``.
    """
    vocab = [itos.get(i, "?") for i in range(max(itos) + 1 if itos else 0)]
    report: dict[int, dict] = {}
    for label in sorted(set(int(l) for l in labels)):
        if label == -1:
            continue
        members = [m for m, l in zip(metadata, labels) if int(l) == label]
        if not members:
            continue
        sequences = [
            [vocab[int(t)] if int(t) < len(vocab) else "?"
             for t in input_ids[b, start:end]]
            for b, start, end in members
        ]
        pwm = position_weight_matrix(sequences, vocab)
        entropy = pwm_entropy(pwm)
        info = pwm_information_content(pwm, len(vocab))
        report[label] = {
            "pwm_consensus": pwm_consensus(pwm, vocab, sep=" "),
            "mean_entropy_bits": float(entropy.mean()) if entropy.size else 0.0,
            "min_entropy_bits": float(entropy.min()) if entropy.size else 0.0,
            "information_content_bits": float(info.sum()) if info.size else 0.0,
            "per_position_entropy_bits": [float(e) for e in entropy],
        }
    return report


def match_known_motifs(consensus_dna: str, motifs: dict | None = None) -> list[str]:
    """Names of curated motifs whose DNA appears in a consensus string."""
    motifs = motifs or KNOWN_MOTIFS
    seq = consensus_dna.replace(" ", "").upper()
    return [name for name, info in motifs.items() if info["sequence"] in seq]


__all__ = [
    "KNOWN_MOTIFS",
    "MotifClusterer",
    "cluster_consensus",
    "cluster_pwm_report",
    "extract_window_embeddings",
    "match_known_motifs",
    "position_weight_matrix",
    "pwm_consensus",
    "pwm_entropy",
    "pwm_information_content",
]
