"""Latent Langevin dynamics for EBM-guided protein design (twin of
``genomics_lm_tpu/protein/sampler.py``).

Continuous optimization in the critic's token-embedding space:

    z ← z − lr·∇_z[E(latent(z)) + λ·softmin-distance(z, AA embeddings)] − noise

then each interior position is projected to the nearest amino-acid
embedding. The gradient is ``torch.autograd.grad`` of the summed energy
with respect to ``z`` through the frozen critic and EBM (their parameters
have ``requires_grad=False``, so no weight gradient is formed); the noise is
``noise_std`` times a normal draw from a ``torch.Generator`` seeded with
``seed`` on the critic's device (JAX draws from ``PRNGKey(seed)``: the
streams differ, so the two are compared at ``noise_std`` 0).
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_lm_torch.models.protein import (
    ProteinClassifierConfig,
    ebm_energy,
    extract_latent,
)


def latent_langevin_sample(
    ebm,
    critic,
    critic_cfg: ProteinClassifierConfig,
    tokenizer,
    initial_seq: str,
    *,
    steps: int = 50,
    lr: float = 0.05,
    noise_std: float = 0.01,
    lambda_reg: float = 0.0,
    temperature_reg: float = 1.0,
    normalize_grad: bool = False,
    seed: int = 0,
) -> tuple[str, list[float]]:
    """Optimize ``initial_seq`` in latent space; returns (sequence, energies)."""
    for module in (ebm, critic):
        for p in module.parameters():
            p.requires_grad_(False)
    device = critic.backbone.token_embedding.device
    tokens = (
        [tokenizer.bos_token_id]
        + tokenizer.encode_sequence(initial_seq)
        + [tokenizer.eos_token_id]
    )
    ids = torch.as_tensor([tokens], dtype=torch.int32, device=device)
    emb_matrix = critic.backbone.token_embedding.detach()
    z = emb_matrix[ids[0].long()][None].clone()  # (1, T, D)
    aa_indices = torch.as_tensor(
        [tokenizer.token_to_id[aa] for aa in tokenizer.amino_acids], device=device)
    aa_embeds = emb_matrix[aa_indices]  # (V_aa, D)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def loss_fn(z):
        latent = extract_latent(critic, critic_cfg, ids, inputs_embeds=z)
        energy = ebm_energy(ebm, latent)
        loss = energy.sum()
        if lambda_reg > 0.0:
            z_valid = z[:, 1:-1]
            z_sq = (z_valid**2).sum(dim=-1, keepdim=True)
            aa_sq = (aa_embeds**2).sum(dim=-1)[None, None, :]
            dists_sq = z_sq + aa_sq - 2.0 * (z_valid @ aa_embeds.T)
            soft_min = -temperature_reg * torch.logsumexp(-dists_sq / temperature_reg, dim=-1)
            loss = loss + lambda_reg * soft_min.mean()
        return loss, energy

    energy_history: list[float] = []
    for _ in range(int(steps)):
        z = z.detach().requires_grad_(True)
        loss, energy = loss_fn(z)
        (grad,) = torch.autograd.grad(loss, z)
        if normalize_grad:
            grad = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-8)
        noise = noise_std * torch.randn(z.shape, generator=generator, device=device)
        z = z.detach() - lr * grad - noise
        energy_history.append(float(energy.detach()[0]))

    # project interior positions to the nearest amino-acid embedding
    z_np = z.detach().cpu().numpy()[0]
    aa_np = aa_embeds.cpu().numpy()
    aa_ids = aa_indices.cpu().numpy()
    optimized = []
    for pos in range(1, z_np.shape[0] - 1):
        dists = np.linalg.norm(aa_np - z_np[pos], axis=1)
        optimized.append(int(aa_ids[int(np.argmin(dists))]))
    return tokenizer.decode_sequence(optimized), energy_history


__all__ = ["latent_langevin_sample"]
