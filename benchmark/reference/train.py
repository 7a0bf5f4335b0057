"""The DiTTo training step in plain fp32 PyTorch: the frozen EnCodec encode
at 1.5 kbps, the embedding head, the latents meaned over the two
codebooks; GPT2 wte of the text cut to the latents' frames; t ~ U[0, T),
noise, the forward diffusion sqrt(abar_t) x0 + sqrt(1 - abar_t) noise;
the DiT with cross-attention dropout; the MSE against the noise; AdamW as
optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay
added after the moments, bias correction from the step count).

Draws follow the chain's order on one generator on the device: each step
draws t, the noise, then one keep mask a block.
"""

from __future__ import annotations

import torch

from . import codec as codec_ref
from . import dit as dit_ref
from .precision import exact


def leaves(tree, prefix=""):
    """(path, tensor) in sorted-key, list-index order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def unflatten(template, values: dict, prefix=""):
    if isinstance(template, dict):
        return {k: unflatten(v, values, f"{prefix}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten(v, values, f"{prefix}/{i}")
                for i, v in enumerate(template)]
    return values[prefix]


def encode_latents(frozen, codec: dict, audio, mask, n_positions: int,
                   prec="float32"):
    """audio [B, 1, L] -> latents [B, T, H]."""
    z = codec_ref.encode(frozen["codec"]["encoder"], codec,
                         audio * mask[:, None].float(), prec)
    codes = codec_ref.rvq_encode(frozen["codec"]["quantizer"]["codebooks"],
                                 z, codec_ref.codes_per_bandwidth(codec, 1.5),
                                 prec)
    lat = frozen["embedding_head"]["weight"][codes]        # [B, nq, T, H]
    return lat[:, :, :n_positions].float().mean(dim=1)


def steps(params0, frozen, cfg: dict, batches, seed_gen, prec):
    """Run len(batches) steps from params0 (a tree of fp32 tensors).
    Returns (losses, first gradient by leaf path, final params by leaf
    path)."""
    pipe, tr = cfg["pipeline"], cfg["train"]
    dit = dict(pipe["dit"], cross_attn_dropout=tr["cross_attn_dropout"])
    rate = dit["cross_attn_dropout"]
    _, ac = dit_ref.cosine_schedule(dit["diffusion_steps"])
    p = {k: v.detach().float().clone() for k, v in leaves(params0)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, lr, wd = 0.9, 0.999, 1e-8, tr["learning_rate"], \
        tr["weight_decay"]
    losses, first = [], None
    bp = {"blocks": prec["dit_blocks"], "carry": prec["dit_carry"],
          "other": prec["dit_other"]}
    with exact():
        for n, batch in enumerate(batches, start=1):
            with torch.no_grad():
                lat = encode_latents(frozen, pipe["codec"], batch["audio"],
                                     batch["padding_mask"],
                                     cfg["gpt2"]["n_positions"],
                                     prec["codec"])
                ids = batch["text_ids"][:, :lat.shape[1]]
                emb = frozen["gpt2"]["wte"]["weight"][ids].float()
            b, t_len, h = lat.shape
            dev = lat.device
            t = torch.randint(0, dit["diffusion_steps"], (b,),
                              generator=seed_gen, device=dev)
            noise = torch.randn((b, t_len, h), generator=seed_gen,
                                dtype=torch.float32, device=dev)
            keeps = [torch.rand((b, t_len, h), generator=seed_gen,
                                device=dev) >= rate
                     for _ in range(dit["num_layers"])] if rate > 0 else None
            c = ac.to(dev)[t][:, None, None]
            noisy = torch.sqrt(c) * lat + torch.sqrt(1.0 - c) * noise
            leaf = {k: v.clone().requires_grad_() for k, v in p.items()}
            tree = unflatten(params0, leaf)
            pred = dit_ref.forward(tree, dit, noisy, emb, t, bp, keeps)
            loss = torch.mean(torch.square(pred - noise))
            names = list(leaf)
            grads = torch.autograd.grad(loss, [leaf[k] for k in names],
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p[k]) if g is None else g)
                     for k, g in zip(names, grads)}
            losses.append(float(loss.detach()))
            if first is None:
                first = grads
            with torch.no_grad():
                for k in names:
                    g = grads[k]
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * g * g + b2 * nu[k]
                    upd = (mu[k] / (1 - b1 ** n)) / (
                        torch.sqrt(nu[k] / (1 - b2 ** n)) + eps)
                    p[k] = p[k] - lr * (upd + wd * p[k])
            del tree, leaf, pred, loss, grads
    return losses, first, p


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The largest |‖got‖ - ‖want‖| over leaves, each against the larger
    of its reference norm and the median leaf's."""
    names = [k for k in want if keep is None or keep(k)]
    norms = {k: float(want[k].double().norm()) for k in names}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(got[k].double().norm()) - norms[k])
               / max(norms[k], med, 1e-300) for k in names)
