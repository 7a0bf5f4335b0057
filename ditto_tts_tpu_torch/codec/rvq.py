"""Residual vector quantization (EnCodec semantics) and the reference's
single-codebook VectorQuantizer (the JAX ``codec/rvq.py``).

Nearest codebook entry by euclidean distance: one [N, D] x [D, K] product
summed in fp32 and a row argmax of 2 x.c - ||c||^2; ``ref_exact`` rounds
the reference's own expression (||x||^2 - 2 x.c) + ||c||^2 with argmin.
``vq_indices`` is the reference's VQ (indices only, quirk #4);
``vq_straight_through`` the trainable one (straight-through estimator,
codebook and commitment losses), the NAC step's default.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..params import fill_spec, vq_spec


def nearest_codebook_indices(x, codebook, *, ref_exact: bool = False):
    """x: [..., D]; codebook: [K, D] -> int64 indices [...]."""
    flat = x.reshape(-1, x.shape[-1]).float()
    cb = codebook.float()
    dots = torch.matmul(flat, cb.t())
    c2 = cb.square().sum(dim=-1)
    if ref_exact:
        x2 = flat.square().sum(dim=-1, keepdim=True)
        idx = torch.argmin((x2 - 2.0 * dots) + c2[None, :], dim=-1)
    else:
        idx = torch.argmax(2.0 * dots - c2[None, :], dim=-1)
    return idx.reshape(x.shape[:-1])


def num_quantizers_for_bandwidth(codebook_size: int, frame_rate: int,
                                 bandwidth_kbps: Optional[float],
                                 max_quantizers: int) -> int:
    if bandwidth_kbps is None or bandwidth_kbps <= 0:
        return max_quantizers
    bw_per_q = math.log2(codebook_size) * frame_rate
    return max(1, int(math.floor(bandwidth_kbps * 1000 / bw_per_q)))


def rvq_encode(codebooks, latents, num_quantizers: int):
    """codebooks: [NQ, K, D]; latents: [B, D, T] -> codes [B, nq, T]."""
    residual = latents.transpose(1, 2)          # [B, T, D]
    codes = []
    for q in range(num_quantizers):
        idx = nearest_codebook_indices(residual, codebooks[q])
        residual = residual - codebooks[q][idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def rvq_decode(codebooks, codes):
    """codes: [B, nq, T] -> latents [B, D, T] (sum over stages)."""
    out = codebooks[0][codes[:, 0]]
    for q in range(1, codes.shape[1]):
        out = out + codebooks[q][codes[:, q]]
    return out.transpose(1, 2)


def vq_indices(params, latents, *, ref_exact: bool = False):
    """L2-argmin codebook indices; latents [..., D] -> [...]."""
    return nearest_codebook_indices(latents, params["codebook"],
                                    ref_exact=ref_exact)


def init_vector_quantizer(codebook_size: int, latent_dim: int,
                          seed: int = 0):
    """A Xavier-uniform codebook [codebook_size, latent_dim] (CPU fp32,
    from a numpy seed; ref VectorQuantizer.py:19-20)."""
    return {"codebook": torch.from_numpy(
        fill_spec(vq_spec(codebook_size, latent_dim), seed)["codebook"])}


def vq_straight_through(params, latents, *, commitment_cost: float = 0.25):
    """(quantized, indices, losses): the straight-through output
    ``latents + (quant - latents).detach()``, the nearest entries' indices,
    and ``codebook_loss`` (codes pulled toward the detached latents) and
    ``commitment_loss`` (``commitment_cost`` x latents pulled toward the
    detached codes). Each ``.detach()`` stands where JAX stops the
    gradient."""
    codebook = params["codebook"]
    idx = nearest_codebook_indices(latents, codebook)
    quant = F.embedding(idx, codebook)   # a deterministic backward
    codebook_loss = torch.mean(torch.square(quant - latents.detach()))
    commit_loss = torch.mean(torch.square(quant.detach() - latents))
    ste = latents + (quant - latents).detach()
    return ste, idx, {"codebook_loss": codebook_loss,
                      "commitment_loss": commitment_cost * commit_loss}
