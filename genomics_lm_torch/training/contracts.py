"""Fail-closed contract of the corrected primary codon-LM training configs.

A copy of ``genomics_lm_tpu/training/contracts.py`` (plain Python, no JAX):
the pinned values (dataset ids, freeze sha, hyperparameters of the 10L8H
d384 block-512 runs, b4 x 32, lr 3e-4, cosine 5000 steps, label smoothing
0.05, bf16 flash attention with remat) and the validation engine, which
synthesizes the one config a (role, protocol, seed) identity may be and
reports every deviation of the submitted one at once. The same config
gives the same result or the same violations in both packages; the port's
trainer binds it as the JAX trainer does. The execution keys keep the JAX
names (``attention_impl: flash``, ``compute_dtype: bfloat16``,
``use_checkpoint: true``), which the port reads with the same meaning.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

SCHEMA_NAME = "codonlm_primary_training_config"
SCHEMA_VERSION = 3
RELEASE = "corrected-codonlm-v1"
DATASET_FREEZE_ID = "1582505ae40445422711fa15918ee9c229caf84b1b3feba1a71f078259892249"

DATASETS = {
    "genome": {
        "dataset_id": "da3dfce28b7a46b8640d75c7cb417c867137a99e004ea359d85784ff0c269db9",
        "root": "data/processed/corrected/corrected-codonlm-v1/genome",
    },
    "genus": {
        "dataset_id": "10f41e818182704bbe4f95fbd81eb8696047762a32f84d167a4101675945ab95",
        "root": "data/processed/corrected/corrected-codonlm-v1/genus",
    },
}

# reference execution keys → TPU-native equivalents
EXECUTION_KEY_MAPPING = {
    "device: mps": "(implicit: jax.devices())",
    "force_gpu: true": "(implicit)",
    "amp: true": "compute_dtype: bfloat16",
    "use_sdpa: true": "attention_impl: flash",
    "compile: false": "(always jit-compiled)",
    "use_mmap: true": "use_mmap_dataset: true",
    "num_workers/pin_memory": "(host-side numpy pipeline)",
}

# Pinned hyperparameters, grouped by concern; COMMON_VALUES below is their
# union (the flat shape the configs and the reference contract use).
_PINNED_ARCHITECTURE = {
    "block_size": 512, "vocab_size": 68,
    "n_layer": 10, "n_head": 8, "n_embd": 384, "n_kv_head": None,
    "tie_embeddings": True, "use_rope": False, "use_swiglu": False,
    "sep_mask_enabled": True,
}
_PINNED_OBJECTIVES = {
    "dropout": 0.1, "label_smoothing": 0.05, "eos_loss_weight": 1.0,
    "multi_offset_loss_enabled": False, "multi_offset_targets": [],
    "termination_loss_enabled": False, "replay_loss_enabled": False,
    "use_shape_guidance": False, "unfreeze_encoder": False,
    "freeze_backbone": False, "transfer_from": None,
}
_PINNED_OPTIMIZATION = {
    "batch_size": 4, "grad_accum_steps": 32,
    "optimizer": "adamw", "lr": 0.0003, "lr_embedding": 0.0003,
    "min_lr": 0.00003, "weight_decay": 0.05,
    "scheduler": "cosine", "scheduler_total_steps": 5000, "warmup_steps": 100,
    "early_stop_patience": 0, "max_nonfinite_accumulation_groups": 0,
}
_PINNED_CHECKPOINTING = {
    "checkpoint_every_steps": 0, "checkpoint_every_minutes": 30,
    "save_epochs": False,
}
_PINNED_TPU_EXECUTION = {
    "attention_impl": "flash", "compute_dtype": "bfloat16",
    "use_checkpoint": True, "use_mmap_dataset": True, "bucket_batching": False,
}

COMMON_VALUES: dict[str, Any] = {
    **_PINNED_ARCHITECTURE,
    **_PINNED_OBJECTIVES,
    **_PINNED_OPTIMIZATION,
    **_PINNED_CHECKPOINTING,
    **_PINNED_TPU_EXECUTION,
}

# Dataset-artifact filenames relative to each protocol root.
_ARTIFACTS = {
    "dataset_manifest": "manifest.json",
    "itos_path": "itos.txt",
    "train_npz": "train_bs512.npz",
    "val_npz": "val_bs512.npz",
    "test_npz": "test_bs512.npz",
}

# Identity table: everything a (role, protocol) pair pins beyond COMMON_VALUES.
# ``run_id`` is a template over the seed; a missing (role, protocol) key means
# the combination itself is disallowed (e.g. a genus pilot).
_IDENTITIES: dict[tuple[str, str], dict[str, Any]] = {
    ("pilot", "genome"): {
        "seeds": frozenset({1337}),
        "epochs": 1,
        "max_time_minutes": 30,
        "run_id": "corrected-codonlm-v1-pilot-genome-seed{seed}",
    },
    ("primary", "genome"): {
        "seeds": frozenset({1337, 2027}),
        "epochs": 10,
        "max_time_minutes": None,
        "run_id": "corrected-codonlm-v1-genome-seed{seed}",
    },
    ("primary", "genus"): {
        "seeds": frozenset({1337}),
        "epochs": 10,
        "max_time_minutes": None,
        "run_id": "corrected-codonlm-v1-genus-seed{seed}",
    },
}

# Keys whose values the identity does not pin (seed is validated against the
# identity's allowlist separately; TPU execution keys are performance-only).
_FREE_KEYS = frozenset(
    {
        "primary_training_contract",
        "seed",
        "mesh_devices",
        "shard_optimizer_state",
        "fused_qkv",
        "flash_block_q",
        "flash_block_k",
        "scan_unroll",
        "async_checkpointing",
    }
)

ALLOWED_KEYS = frozenset(_FREE_KEYS | set(_ARTIFACTS) | set(COMMON_VALUES)) | {
    "run_id",
    "dataloader_seed",
    "epochs",
    "max_time_minutes",
}


class ContractViolation(ValueError):
    """One or more deviations from the frozen primary-training contract."""

    def __init__(self, violations: list[str]):
        self.violations = list(violations)
        super().__init__(
            "primary training contract violated:\n  - " + "\n  - ".join(violations)
        )


def _resolve_identity(cfg: Mapping[str, Any]) -> tuple[str, str, int]:
    """Extract and allowlist-check (role, protocol, seed) from the header.

    The header block must carry the exact frozen schema/release/freeze ids and
    the dataset_id matching its protocol; anything else fails closed before
    the full-config diff runs (a wrong identity makes the diff meaningless).
    """
    header = cfg.get("primary_training_contract")
    if not isinstance(header, Mapping):
        raise ContractViolation(
            ["missing or non-mapping primary_training_contract block"]
        )
    problems: list[str] = []
    frozen_header = {
        "schema": SCHEMA_NAME,
        "version": SCHEMA_VERSION,
        "release": RELEASE,
        "dataset_freeze_id": DATASET_FREEZE_ID,
    }
    problems.extend(
        f"primary_training_contract.{name}: expected {want!r}, got {header.get(name)!r}"
        for name, want in frozen_header.items()
        if header.get(name) != want
    )

    role = str(header.get("role"))
    protocol = str(header.get("protocol"))
    identity = _IDENTITIES.get((role, protocol))
    if identity is None:
        problems.append(
            f"no frozen identity for role={role!r} protocol={protocol!r} "
            f"(allowed: {sorted(_IDENTITIES)})"
        )
        raise ContractViolation(problems)

    want_dataset_id = DATASETS[protocol]["dataset_id"]
    if header.get("dataset_id") != want_dataset_id:
        problems.append(
            f"primary_training_contract.dataset_id does not match the frozen "
            f"{protocol} protocol dataset_id"
        )

    try:
        seed = int(cfg.get("seed"))
    except (TypeError, ValueError):
        seed = None
    if seed not in identity["seeds"]:
        problems.append(
            f"seed {cfg.get('seed')!r} is not in the allowed set "
            f"{sorted(identity['seeds'])} for role={role} protocol={protocol}"
        )
    if problems:
        raise ContractViolation(problems)
    return role, protocol, seed


def expected_primary_config(role: str, protocol: str, seed: int) -> dict[str, Any]:
    """Synthesize the single config a frozen identity permits.

    This is the contract stated positively: the union of the pinned common
    values, the protocol's dataset-artifact paths, and the identity row's
    schedule/run-id pins. Validation is then a diff against this mapping.
    """
    identity = _IDENTITIES[(role, protocol)]
    root = DATASETS[protocol]["root"]
    expected = dict(COMMON_VALUES)
    expected.update(
        {key: f"{root}/{name}" for key, name in _ARTIFACTS.items()}
    )
    expected.update(
        {
            "dataloader_seed": seed,
            "epochs": identity["epochs"],
            "max_time_minutes": identity["max_time_minutes"],
            "run_id": identity["run_id"].format(seed=seed),
        }
    )
    return expected


def validate_primary_training_config(cfg: Mapping[str, Any]) -> dict[str, Any]:
    """Validate a corrected pilot/primary config without local data.

    Fails closed with a :class:`ContractViolation` listing *every* deviation:
    undeclared keys, missing pinned keys, and value drift, in one report.
    """
    role, protocol, seed = _resolve_identity(cfg)
    expected = expected_primary_config(role, protocol, seed)

    undeclared = sorted(set(cfg) - ALLOWED_KEYS)
    missing = sorted(set(expected) - set(cfg))
    drift = sorted(
        key for key in set(expected) & set(cfg) if cfg[key] != expected[key]
    )
    problems = (
        [f"undeclared keys are not allowed: {undeclared}"] if undeclared else []
    )
    problems.extend(f"missing pinned key {key!r}" for key in missing)
    problems.extend(
        f"pinned key {key!r} must be {expected[key]!r}, got {cfg[key]!r}"
        for key in drift
    )
    if problems:
        raise ContractViolation(problems)
    return {
        "role": role,
        "protocol": protocol,
        "seed": seed,
        "run_id": expected["run_id"],
        "dataset_id": DATASETS[protocol]["dataset_id"],
        "dataset_freeze_id": DATASET_FREEZE_ID,
    }


def load_and_validate_primary_training_config(path: str | Path) -> dict[str, Any]:
    import json

    config_path = Path(path)
    text = config_path.read_text()
    if config_path.suffix == ".json":
        # not yaml.safe_load: YAML 1.1 reads JSON floats like 3e-05 (no dot
        # before the exponent) as strings, which breaks frozen-value checks
        cfg = json.loads(text) or {}
    else:
        import yaml

        cfg = yaml.safe_load(text) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"training config must contain a mapping: {config_path}")
    return validate_primary_training_config(cfg)


__all__ = [
    "ALLOWED_KEYS",
    "COMMON_VALUES",
    "ContractViolation",
    "DATASETS",
    "DATASET_FREEZE_ID",
    "EXECUTION_KEY_MAPPING",
    "RELEASE",
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "expected_primary_config",
    "load_and_validate_primary_training_config",
    "validate_primary_training_config",
]
