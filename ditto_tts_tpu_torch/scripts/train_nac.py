"""Train the Neural Audio Codec (the JAX package's ``scripts/train_nac.py``;
parity: ref src/TrainNAC.py).

Example:
  python -m ditto_tts_tpu_torch.scripts.train_nac --train-path /data/mls/train \
      --encodec /weights/encodec_24khz --gpt2 /weights/gpt2 \
      --gpt2-vocab /weights/gpt2/vocab.json --gpt2-merges /weights/gpt2/merges.txt
"""

from __future__ import annotations

import argparse

import torch

from ..config import CodecConfig, GPT2Config, NACConfig
from ..data.mls import MLSDataset, batches, default_buckets
from ..params import init_nac_frozen, init_nac_train_state
from ..train import steps as steps_mod
from ..train.trainer import Trainer
from ._common import (add_common_args, device_of, gpt2_tokenizer,
                      imported_frozen)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--gpt2", default=None)
    p.add_argument("--gpt2-vocab", default=None)
    p.add_argument("--gpt2-merges", default=None)
    p.add_argument("--lambda-factor", type=float, default=0.1)
    p.add_argument("--ref-compat", action="store_true",
                   help="reference VQ semantics (argmin only, no STE)")
    args = p.parse_args(argv)
    dev = device_of(args)

    nac_cfg = NACConfig(lambda_factor=args.lambda_factor)
    codec_cfg, gpt2_cfg = CodecConfig(), GPT2Config()
    frozen = init_nac_frozen(
        codec_cfg, gpt2_cfg, seed=args.seed, device=dev,
        given=imported_frozen(("codec", "gpt2"), codec_cfg=codec_cfg,
                              encodec=args.encodec, gpt2_cfg=gpt2_cfg,
                              gpt2=args.gpt2))

    tokenizer = gpt2_tokenizer(args)
    batch_size = args.batch_size or nac_cfg.batch_size
    buckets = default_buckets()

    def make_ds(path):
        return MLSDataset(path, tokenizer, nac_cfg.max_token_length,
                          nb_samples=args.nb_samples, tokenizer_name="gpt2")

    train_ds = make_ds(args.train_path)
    val_ds = make_ds(args.dev_path) if args.dev_path else None

    _, step_fn, eval_fn = steps_mod.build_nac_train_step(
        nac_cfg, codec_cfg, gpt2_cfg, ref_compat=args.ref_compat,
        learning_rate=args.learning_rate, device=dev)
    state = init_nac_train_state(nac_cfg, seed=args.seed + 1, device=dev)

    Trainer(step_fn, eval_fn).fit(
        state, frozen,
        train_batches=lambda: batches(train_ds, batch_size, buckets=buckets,
                                      seed=args.seed),
        val_batches=(lambda: batches(val_ds, batch_size, buckets=buckets,
                                     shuffle=False)) if val_ds else None,
        epochs=args.epochs,
        generator=torch.Generator().manual_seed(args.seed + 3),
        model_name="NAC",
        learning_rate=args.learning_rate or nac_cfg.learning_rate,
        checkpoint_dir=args.checkpoint_dir, checkpoint_interval=5,
        log_path=args.log_path)


if __name__ == "__main__":
    main()
