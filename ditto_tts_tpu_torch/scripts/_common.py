"""Shared plumbing of the training, synthesis and evaluation CLIs (the JAX
package's ``scripts/_common.py``): the common flags, the pretrained
weights and the GPT2 tokenizer.

Every path comes by flag. Frozen pretrained weights load from local files
(``--encodec``, ``--gpt2``, ``--byt5``, ``--bigvgan``: a ``.safetensors``
file, a directory of them, or a torch ``.pth``); a tree whose flag is not
given is random, drawn from ``--seed`` with the JAX init trees' shapes and
distributions (``params.init_nac_frozen`` / ``init_slp_frozen`` /
``init_generator_params``), with a warning: a smoke run, useless for
quality. The trainable trees draw from ``--seed + 1`` (the DiTTo CLI's
random embedding head from ``--seed + 2``) and ``Trainer.fit``'s CPU
generator from ``--seed + 3``. ``generator_params`` assembles the serving
trees of ``synthesize`` and ``evaluate`` (``--ditto`` and ``--nac`` are
checkpoints of the training CLIs).

The CLIs run on ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions). They have no mesh flags: parallelism is not
ported yet.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..codec import encodec as codec_mod
from ..models import vocoder as voc_mod
from ..params import GeneratorParams, init_generator_params, tree_map
from ..text import byt5 as byt5_mod
from ..text import gpt2 as gpt2_mod
from ..train.checkpoint import load_checkpoint
from ..utils.weights import load_state_dict


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--train-path", required=True,
                   help="MLS split dir with transcripts.txt + audio_clean/")
    p.add_argument("--dev-path", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--nb-samples", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-path", default=None)
    p.add_argument("--encodec", default=None,
                   help="local facebook/encodec_24khz snapshot (safetensors)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")


def device_of(args) -> torch.device:
    """``--device``, resolved: raises without CUDA unless it is ``cpu``."""
    return resolve_device(args.device)


def imported_frozen(names, *, codec_cfg=None, encodec=None, gpt2_cfg=None,
                    gpt2=None, byt5_cfg=None, byt5=None, vocoder_cfg=None,
                    bigvgan=None) -> dict:
    """The frozen trees among ``names`` whose weights path is given,
    imported from it (CPU tensors), for the ``given`` of
    ``init_nac_frozen`` / ``init_slp_frozen`` (which draw only the others)
    and ``init_generator_params``; a warning for each that stays random."""
    loaded = {"codec": (encodec, "--encodec", lambda p: codec_mod.
                        import_hf_state_dict(load_state_dict(p), codec_cfg)),
              "gpt2": (gpt2, "--gpt2", lambda p: gpt2_mod.
                       import_hf_state_dict(load_state_dict(p), gpt2_cfg)),
              "byt5": (byt5, "--byt5", lambda p: byt5_mod.
                       import_hf_state_dict(load_state_dict(p), byt5_cfg)),
              "vocoder": (bigvgan, "--bigvgan", lambda p: voc_mod.
                          import_bigvgan_state_dict(load_state_dict(p),
                                                    vocoder_cfg))}
    out = {}
    for name in names:
        path, flag, importer = loaded[name]
        if path:
            out[name] = importer(path)
        else:
            print(f"[warn] {flag} not given: random {name} weights (smoke "
                  "only)")
    return out


def gpt2_tokenizer(args):
    """Real GPT2 BPE when --gpt2-vocab/--gpt2-merges are given; otherwise
    the package's byte-level mini vocabulary (runs out of the box; its ids
    are not the real gpt2 mapping)."""
    from ..text.tokenizers import GPT2Tokenizer
    if getattr(args, "gpt2_vocab", None):
        return GPT2Tokenizer(args.gpt2_vocab, args.gpt2_merges)
    from .. import assets
    print("[warn] --gpt2-vocab not given: byte-level mini vocab "
          "(valid BPE, not the real gpt2 id mapping)")
    return assets.gpt2_mini_tokenizer()


def add_weight_args(p: argparse.ArgumentParser) -> None:
    """The weight flags of ``synthesize`` and ``evaluate``."""
    p.add_argument("--encodec", default=None)
    p.add_argument("--gpt2", default=None)
    p.add_argument("--gpt2-vocab", default=None)
    p.add_argument("--gpt2-merges", default=None)
    p.add_argument("--bigvgan", default=None)
    p.add_argument("--ditto", default=None, help="DiTTO .npz checkpoint")
    p.add_argument("--nac", default=None, help="NAC .npz checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")


def checkpoint_params(path: str) -> dict:
    """The ``params`` of a training CLI's checkpoint (or a bare tree) as
    CPU tensors."""
    st, _ = load_checkpoint(path)
    return tree_map(torch.from_numpy, st.get("params", st))


def generator_params(args, cfg, gpt2_cfg, device, *,
                     smoke=None) -> GeneratorParams:
    """The serving trees on ``device``: EnCodec, GPT2 and BigVGAN imported
    from ``--encodec`` / ``--gpt2`` / ``--bigvgan``, the DiT from the
    ``--ditto`` checkpoint, the embedding head and VQ codebook from the
    ``--nac`` one; the rest drawn from ``--seed`` (``init_generator_params``)
    with a warning each. ``smoke(tree)``, when given, re-initializes the
    random (not the imported) codec and vocoder trees."""
    given = imported_frozen(("codec", "gpt2", "vocoder"),
                            codec_cfg=cfg.codec, encodec=args.encodec,
                            gpt2_cfg=gpt2_cfg, gpt2=args.gpt2,
                            vocoder_cfg=cfg.vocoder, bigvgan=args.bigvgan)
    if args.ditto:
        given["dit"] = checkpoint_params(args.ditto)
    else:
        print("[warn] --ditto not given: random DiT weights (smoke only)")
    if args.nac:
        nac = checkpoint_params(args.nac)
        given["embedding_head"] = nac["embedding_head"]
        given["vector_quantizer"] = nac["vector_quantizer"]
    else:
        print("[warn] --nac not given: random NAC head (smoke only)")
    params = init_generator_params(cfg, args.seed, gpt2_cfg=gpt2_cfg,
                                   given=given)
    if smoke is not None:
        for name in ("codec", "vocoder"):
            if name not in given:
                setattr(params, name, smoke(getattr(params, name)))
    return params.to(device)
