"""The DiTTo serving chain in plain fp32 PyTorch, and the comparison that
decides a serving cell's ``correct``.

  GPT2 wte(text) -> DDPM over the DiT from x_init (the chain's noise:
  prompt noise, x_init, one draw a step, from one generator on the
  device) -> refined latents -> the VQ's nearest codes (the latents
  repeated on 2 codebooks) -> EnCodec decode -> log-mel -> BigVGAN.

The prompt's codec encode gives the latents' length and nothing else:
the configuration (``cond_by_audio`` off) starts the sampler from x_init.

Each stage is judged on its own: the refined latents against the
reference's from the same weights, text and noise; each later stage's
output against the reference applied to the same stage input, which is
the judged side's previous output (a nearest code is a discrete choice:
the reference judges the choice made: a code counts as a right choice
where the stated fp32 arithmetic could have made it). So the numbers are the same whether the judged side is the
program or the control, which is this reference in lower precision
(``precision.control_of``) put in the program's place.
"""

from __future__ import annotations

import torch

from ..work import act_conv as act_conv_work
from ..work import codec as codec_work
from . import codec as codec_ref
from . import dit as dit_ref
from . import vocoder as voc_ref
from .precision import exact, matmul

PARTS = ("dit_blocks", "dit_carry", "dit_other", "vq", "codec", "mel",
         "vocoder")
FP32 = {k: "float32" for k in PARTS}


def text_embedding(p, dit: dict, ids):
    return p["gpt2"]["wte"]["weight"][ids[:, :dit["max_token_length"]]].float()


def latent_frames(pipe: dict, samples: int) -> int:
    return min(codec_work.frames(pipe["codec"], samples),
               pipe["dit"]["max_token_length"])


def refined(p, pipe: dict, text_ids, noise_seed: int, frames: int, prec):
    dit = pipe["dit"]
    dev = text_ids.device
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    shape = (text_ids.shape[0], frames, dit["hidden_dim"])

    def draw():
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    draw()                                   # the prompt's noise
    x = draw()
    emb = text_embedding(p, dit, text_ids)
    return dit_ref.ddpm(p["dit"], dit, emb, x, draw,
                        pipe["sampler"]["num_steps"],
                        {"blocks": prec["dit_blocks"],
                         "carry": prec["dit_carry"],
                         "other": prec["dit_other"]})


def indices(p, pipe: dict, lat, prec):
    """The nearest codes by the configuration's expression: the largest
    2 x.c - |c|^2, or under ``ref_compat`` (the reference's quirk) the
    smallest (|x|^2 - 2 x.c) + |c|^2, both in fp32."""
    cb = p["vector_quantizer"]["codebook"].float()
    x = lat.reshape(-1, lat.shape[-1])
    dots = matmul(x, cb.t(), prec["vq"])
    c2 = cb.square().sum(-1)[None]
    if pipe["dit"]["ref_compat"]:
        idx = ((x.square().sum(-1, keepdim=True) - 2.0 * dots) + c2).argmin(-1)
    else:
        idx = (2.0 * dots - c2).argmax(-1)
    idx = idx.reshape(lat.shape[:-1])
    return torch.stack([idx, idx], dim=1)                    # [B, 2, T]


def codec_wav(p, pipe: dict, idx, length: int, prec):
    z = codec_ref.rvq_decode(p["codec"]["quantizer"]["codebooks"], idx)
    return codec_ref.decode(p["codec"]["decoder"], pipe["codec"], z,
                            prec["codec"], length)


def mel(pipe: dict, wav, prec):
    return codec_ref.log_mel(pipe["vocoder"], wav[:, 0], prec["mel"])


def wave(p, pipe: dict, m, prec):
    voc = pipe["vocoder"]
    fused = [w for w, _ in act_conv_work.fused_stage_widths(voc, m.shape[-1])]
    return voc_ref.forward(p["vocoder"], voc, m, prec["vocoder"], fused)


def chain(p, pipe: dict, text_ids, noise_seed: int, samples: int, prec):
    """Every stage's output of the whole chain at ``prec``."""
    with exact():
        lat = refined(p, pipe, text_ids, noise_seed,
                      latent_frames(pipe, samples), prec)
        idx = indices(p, pipe, lat, prec)
        cw = codec_wav(p, pipe, idx, samples, prec)
        m = mel(pipe, cw, prec)
        return {"refined": lat, "indices": idx, "codec_wav": cw, "mel": m,
                "wave": wave(p, pipe, m, prec)}


def vq_excess(p, pipe: dict, lat, idx) -> float:
    """How far any chosen code's squared distance (in float64) lies above
    the nearest code's beyond what fp32 rounding of the configuration's
    expression can account for, as a share of how far the median code's
    lies above the nearest at that position; the largest over positions.
    0 for every choice the stated fp32 arithmetic could make.

    The rounding allowance of a code k is (D + 2) 2^-24 times the sum of
    the magnitudes the expression adds up: 2 |x|.|c_k| + |c_k|^2, plus
    |x|^2 under ``ref_compat`` (the reference's (|x|^2 - 2 x.c) + |c|^2),
    taken for the chosen and the nearest code."""
    cb = p["vector_quantizer"]["codebook"].double()
    x = lat.reshape(-1, lat.shape[-1]).double()
    d = codec_ref.sq_distances(x, cb, dtype=torch.float64)
    mag = 2.0 * (x.abs() @ cb.abs().t()) + cb.square().sum(-1)[None]
    if pipe["dit"]["ref_compat"]:
        mag = mag + x.square().sum(-1, keepdim=True)
    ulp = (x.shape[-1] + 2) * 2.0 ** -24
    best, at = d.min(-1)
    spread = (d.median(-1).values - best).clamp(min=1e-300)
    worst = torch.zeros_like(best)
    for c in range(idx.shape[1]):
        k = idx[:, c].reshape(-1, 1).long()
        chosen = d.gather(1, k)[:, 0]
        allow = ulp * (mag.gather(1, k)[:, 0] + mag.gather(1, at[:, None])[:, 0])
        worst = torch.maximum(worst, (chosen - best - allow).clamp(min=0)
                              / spread)
    return float(worst.max())


def judge(p, pipe: dict, text_ids, noise_seed: int, out: dict) -> dict:
    """The numbers compared for one request whose stage outputs are
    ``out`` (refined [B, T, H], indices [B, 2, T], codec_wav [B, 1, L],
    mel [B, M, F], wave [B, L'])."""
    from ..core import rel_rms
    with exact():
        want = refined(p, pipe, text_ids, noise_seed,
                       out["refined"].shape[1], FP32)
        nums = {"refined_rel": rel_rms(out["refined"], want)}
        del want
        nums["vq_excess"] = vq_excess(p, pipe, out["refined"].float(),
                                      out["indices"])
        nums["codec_rel"] = rel_rms(out["codec_wav"], codec_wav(
            p, pipe, out["indices"], out["codec_wav"].shape[-1], FP32))
        nums["mel_rel"] = rel_rms(out["mel"], mel(pipe, out["codec_wav"],
                                                  FP32))
        nums["wave_rel"] = rel_rms(out["wave"], wave(p, pipe, out["mel"],
                                                     FP32))
    return nums
