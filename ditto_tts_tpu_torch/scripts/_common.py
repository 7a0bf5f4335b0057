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
kernels' plain versions). The training CLIs take the JAX CLIs' mesh flags,
``--mesh-data`` and ``--mesh-model``, plus ``--dist-backend`` (``nccl`` by
default; ``gloo`` for several ranks on one card or on the CPU), and run
one process per rank under ``python -m torch.distributed.run
--nproc-per-node N -m ditto_tts_tpu_torch.scripts.train_ditto ...``
(``open_mesh``, ``setup_mesh``). They keep the semantics of JAX's
single-process mesh CLI: every rank builds the same global batches from
the same seed, in the same order, and keeps its data rank's rows;
``--batch-size`` must divide over ``--mesh-data``.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..config import MeshConfig
from ..codec import encodec as codec_mod
from ..models import vocoder as voc_mod
from ..params import GeneratorParams, init_generator_params, tree_map
from ..parallel import mesh as mesh_mod
from ..parallel.sharding import whole_attention
from ..parallel.train_setup import setup_mesh_training
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
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel mesh axis size")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis size")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"),
                   default="nccl",
                   help="torch.distributed backend of a mesh (gloo for "
                        "several ranks on one card, or on the CPU)")


def device_of(args) -> torch.device:
    """``--device``, resolved: raises without CUDA unless it is ``cpu``."""
    return resolve_device(args.device)


def open_mesh(args, batch_size: int):
    """(mesh or None, this rank's device) for ``--mesh-data`` x
    ``--mesh-model`` (None below two ranks, as JAX's ``setup_mesh``):
    joins the launcher's process group with ``--dist-backend`` and builds
    the mesh, which must cover the world; ``batch_size`` must divide over
    the data axis."""
    dev = device_of(args)
    if args.mesh_data * args.mesh_model <= 1:
        return None, dev
    if batch_size % args.mesh_data:
        raise ValueError(f"--batch-size {batch_size} does not split over "
                         f"--mesh-data {args.mesh_data}")
    mesh_mod.initialize_distributed(args.dist_backend)
    mesh = mesh_mod.make_mesh(MeshConfig(data=args.mesh_data,
                                         model=args.mesh_model))
    return mesh, mesh_mod.local_device(dev)


def setup_mesh(args, mesh, state, frozen, model_name, param_specs=None,
               note=""):
    """The JAX ``setup_mesh``: (state, frozen, shard_state, wrap). ``wrap``
    maps a batch iterator factory to one that yields this rank's rows of
    each global batch; everything passes through unchanged without a mesh.
    ``param_specs`` picks the layout (default: the DiT rules;
    ``parallel/train_setup.py``); ``note`` ends the mesh line."""
    if mesh is None:
        return state, frozen, None, (lambda it: it)
    state, frozen, shard_state, shard_batch = setup_mesh_training(
        mesh, state, frozen, param_specs)
    if mesh.rank == 0:
        print(f"[{model_name}] mesh {mesh.shape} ({args.dist_backend}): DP "
              f"batches, sharded trainables; checkpoints gather on save"
              f"{note}", flush=True)

    def wrap(it_factory):
        def it():
            for b in it_factory():
                yield shard_batch(b)
        return it

    return state, frozen, shard_state, wrap


def whole_attention_note(num_heads: int, model: int,
                         ref_compat: bool = False) -> str:
    """The mesh line's words for attention that stays whole on every rank
    of the model group (``parallel.sharding.whole_attention``)."""
    if whole_attention(num_heads, model, ref_compat) is None:
        return ""
    if num_heads % model:
        return (f"; attention whole on each rank ({num_heads} head(s) do "
                f"not split over model {model}), the MLP split")
    return ("; the self-attention whole on each rank (ref_compat: no "
            "out_proj), the rest split")


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
