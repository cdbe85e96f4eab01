"""Protein tokenizer: 28-token amino-acid + condition vocabulary (the port's
copy of ``genomics_lm_tpu/tokenizers/protein.py``, numpy only).

Id layout matches the reference (``src/protein_lm/tokenizer.py:3-38``):
``<PAD>=0, <BOS>=1, <EOS>=2``, 20 amino acids (ARNDCQEGHILKMFPSTWYV order),
``X`` unknown, then 4 condition tokens (FUNC:ENZYME, FUNC:NON_ENZYME,
TOPO:TM, TOPO:GLOBULAR).
"""

from __future__ import annotations

import numpy as np

AMINO_ACIDS = list("ARNDCQEGHILKMFPSTWYV")
UNKNOWN = "X"
SPECIALS = {"PAD": "<PAD>", "BOS": "<BOS>", "EOS": "<EOS>"}
CONDITIONS = {
    "FUNC_ENZYME": "<FUNC:ENZYME>",
    "FUNC_NON_ENZYME": "<FUNC:NON_ENZYME>",
    "TOPO_TM": "<TOPO:TM>",
    "TOPO_GLOBULAR": "<TOPO:GLOBULAR>",
}


class ProteinTokenizer:
    """Amino-acid sequence ↔ id conversion with conditional control tokens."""

    def __init__(self) -> None:
        self.amino_acids = list(AMINO_ACIDS)
        self.unknown_token = UNKNOWN
        self.special_tokens = dict(SPECIALS)
        self.condition_tokens = dict(CONDITIONS)
        self.vocab = (
            [SPECIALS["PAD"], SPECIALS["BOS"], SPECIALS["EOS"]]
            + self.amino_acids
            + [UNKNOWN]
            + list(CONDITIONS.values())
        )
        self.token_to_id = {tok: i for i, tok in enumerate(self.vocab)}
        self.id_to_token = {i: tok for i, tok in enumerate(self.vocab)}
        # Vectorized encode table: ASCII byte → id (unknown AA → X).
        self._lut = np.full(256, self.token_to_id[UNKNOWN], dtype=np.int32)
        for aa in self.amino_acids:
            self._lut[ord(aa)] = self.token_to_id[aa]

    def encode_sequence(self, seq: str) -> list[int]:
        """AA string → ids (no BOS/EOS wrapping; unknowns map to X)."""
        raw = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
        return self._lut[raw].tolist()

    def decode_sequence(self, ids) -> str:
        """Ids → AA string, dropping special and condition tokens."""
        skip = set(self.special_tokens.values()) | set(self.condition_tokens.values())
        return "".join(
            self.id_to_token[int(i)]
            for i in ids
            if self.id_to_token[int(i)] not in skip
        )

    def encode_conditions(self, cond_list) -> list[int]:
        """Condition token strings → ids (fails on unknown condition)."""
        return [self.token_to_id[cond] for cond in cond_list]

    @property
    def bos_token_id(self) -> int:
        return self.token_to_id[SPECIALS["BOS"]]

    @property
    def eos_token_id(self) -> int:
        return self.token_to_id[SPECIALS["EOS"]]

    @property
    def pad_token_id(self) -> int:
        return self.token_to_id[SPECIALS["PAD"]]

    def __len__(self) -> int:
        return len(self.vocab)
