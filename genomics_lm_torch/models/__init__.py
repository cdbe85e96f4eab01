"""CodonGPT for PyTorch: config and the inference forward."""

from genomics_lm_torch.models.config import CodonGPTConfig  # noqa: F401
from genomics_lm_torch.models.codon_gpt import CodonGPT  # noqa: F401
