"""Train the DiTTo diffusion transformer (the JAX package's
``scripts/train_ditto.py``; parity: ref src/TrainDiTTO.py).

Example:
  python -m ditto_tts_tpu_torch.scripts.train_ditto --train-path /data/mls/train \
      --encodec /weights/encodec_24khz --gpt2 /weights/gpt2 \
      --nac-checkpoint checkpoints/NAC_final.npz --epochs 20

On a (data, model) mesh, one process per rank:
  python -m torch.distributed.run --nproc-per-node 4 \
      -m ditto_tts_tpu_torch.scripts.train_ditto --mesh-data 2 \
      --mesh-model 2 --train-path /data/mls/train ...
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config import (CodecConfig, DiTConfig, GPT2Config, NACConfig,
                      ref_trained_dit_config)
from ..data import latents as lat_mod
from ..data.mls import MLSDataset, batches, default_buckets
from ..models import nac as nac_mod
from ..params import init_dit_train_state, init_nac_frozen, tree_map
from ..parallel.sharding import dit_param_specs
from ..train import steps as steps_mod
from ..train.checkpoint import load_checkpoint
from ..train.trainer import Trainer
from ._common import (add_common_args, gpt2_tokenizer, imported_frozen,
                      open_mesh, setup_mesh, whole_attention_note)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--gpt2", default=None)
    p.add_argument("--gpt2-vocab", default=None, help="vocab.json path")
    p.add_argument("--gpt2-merges", default=None, help="merges.txt path")
    p.add_argument("--nac-checkpoint", default=None,
                   help="trained NAC .npz (embedding head + VQ)")
    p.add_argument("--ref-config", action="store_true",
                   help="use the reference's trained config "
                        "(5 layers, 1 head, ref-compat quirks)")
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--latent-cache", default=None, metavar="DIR",
                   help="precompute the frozen EnCodec latents once into "
                        "DIR and train from the cache (skips the frozen "
                        "encode in every step; see data/latents.py)")
    args = p.parse_args(argv)

    # remat: per-block recompute in the backward, the training memory
    # setup of the JAX CLI (scan_blocks changes nothing in eager PyTorch)
    dit_cfg = ref_trained_dit_config() if args.ref_config else DiTConfig(
        num_layers=args.layers, num_heads=args.heads,
        scan_blocks=True, remat_blocks=True)
    batch_size = args.batch_size or dit_cfg.batch_size
    mesh, dev = open_mesh(args, batch_size)

    codec_cfg, gpt2_cfg = CodecConfig(), GPT2Config()
    frozen = init_nac_frozen(
        codec_cfg, gpt2_cfg, seed=args.seed, device=dev,
        given=imported_frozen(("codec", "gpt2"), codec_cfg=codec_cfg,
                              encodec=args.encodec, gpt2_cfg=gpt2_cfg,
                              gpt2=args.gpt2))
    if args.nac_checkpoint:
        nac_trainable, _ = load_checkpoint(args.nac_checkpoint)
        nac_trainable = nac_trainable.get("params", nac_trainable)
        head = tree_map(lambda a: torch.from_numpy(a).to(dev),
                        nac_trainable["embedding_head"])
    else:
        print("[warn] --nac-checkpoint not given: random embedding head")
        head = tree_map(lambda t: t.to(dev), nac_mod.init_nac_trainable(
            NACConfig(), seed=args.seed + 2)["embedding_head"])
    frozen["embedding_head"] = head

    tokenizer = gpt2_tokenizer(args)
    buckets = default_buckets()

    def make_ds(path):
        return MLSDataset(path, tokenizer, dit_cfg.max_token_length,
                          nb_samples=args.nb_samples, tokenizer_name="gpt2")

    train_ds = make_ds(args.train_path)
    val_ds = make_ds(args.dev_path) if args.dev_path else None

    # one-shot frozen-latent precompute, a cache directory per split (the
    # JAX CLI's names for its one process: shard 0 of 1); on a mesh rank 0
    # writes it while the others wait, and every rank reads it
    lat_dirs = {}
    if args.latent_cache:
        for name, ds in (("train", train_ds), ("val", val_ds)):
            if ds is None:
                continue
            d = os.path.join(args.latent_cache, f"{name}_shard0of1")
            if mesh is None or mesh.rank == 0:
                lat_mod.precompute(ds, frozen, codec_cfg, cache_dir=d,
                                   batch_size=batch_size, buckets=buckets,
                                   progress=True, device=dev)
            lat_dirs[id(ds)] = d
        if mesh is not None:
            mesh.barrier()

    # flat single-vector AdamW except under TP, where mu / nu shard with
    # the parameters (parallel/train_setup.py)
    flat = args.mesh_model <= 1
    _, step_fn, eval_fn = steps_mod.build_ditto_train_step(
        dit_cfg, codec_cfg, gpt2_cfg, learning_rate=args.learning_rate,
        flat_opt=flat, device=dev, mesh=mesh)
    state = init_dit_train_state(dit_cfg, seed=args.seed + 1, flat_opt=flat,
                                 device=dev)
    state, frozen, shard_state, wrap = setup_mesh(
        args, mesh, state, frozen, "train_ditto",
        dit_param_specs(state["params"], dit_cfg, args.mesh_model),
        whole_attention_note(dit_cfg.num_heads, args.mesh_model,
                             dit_cfg.ref_compat))

    def batch_iter(ds, shuffle, seed=None):
        if id(ds) in lat_dirs:
            return wrap(lambda: lat_mod.latent_batches(
                lat_dirs[id(ds)], ds, batch_size, shuffle=shuffle,
                seed=seed if seed is not None else 0))
        return wrap(lambda: batches(ds, batch_size, buckets=buckets,
                                    shuffle=shuffle, seed=seed))

    Trainer(step_fn, eval_fn).fit(
        state, frozen,
        train_batches=batch_iter(train_ds, True, args.seed),
        val_batches=batch_iter(val_ds, False) if val_ds else None,
        epochs=args.epochs,
        generator=torch.Generator().manual_seed(args.seed + 3),
        model_name="DiTTO",
        learning_rate=args.learning_rate or dit_cfg.learning_rate,
        checkpoint_dir=args.checkpoint_dir, checkpoint_interval=1,
        log_path=args.log_path, shard_state=shard_state)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
