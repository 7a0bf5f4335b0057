"""Train the Speech Length Predictor (the JAX package's
``scripts/train_slp.py``; parity: ref src/TrainSLP.py).

Example:
  python -m ditto_tts_tpu_torch.scripts.train_slp --train-path /data/mls/train \
      --encodec /weights/encodec_24khz --byt5 /weights/byt5-small
"""

from __future__ import annotations

import argparse

import torch

from ..config import CodecConfig, SLPConfig, byt5_small_config
from ..data.mls import MLSDataset, batches, default_buckets
from ..params import init_slp_frozen, init_slp_train_state
from ..text.tokenizers import ByT5Tokenizer
from ..train import steps as steps_mod
from ..train.trainer import Trainer
from ._common import add_common_args, device_of, imported_frozen


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--byt5", default=None)
    args = p.parse_args(argv)
    dev = device_of(args)

    slp_cfg = SLPConfig()
    codec_cfg, byt5_cfg = CodecConfig(), byt5_small_config()
    frozen = init_slp_frozen(
        codec_cfg, byt5_cfg, seed=args.seed, device=dev,
        given=imported_frozen(("byt5", "codec"), codec_cfg=codec_cfg,
                              encodec=args.encodec, byt5_cfg=byt5_cfg,
                              byt5=args.byt5))

    tokenizer = ByT5Tokenizer()
    batch_size = args.batch_size or slp_cfg.batch_size
    buckets = default_buckets()

    def make_ds(path):
        return MLSDataset(path, tokenizer, slp_cfg.max_token_length,
                          nb_samples=args.nb_samples, tokenizer_name="byt5")

    train_ds = make_ds(args.train_path)
    val_ds = make_ds(args.dev_path) if args.dev_path else None

    _, step_fn, eval_fn = steps_mod.build_slp_train_step(
        slp_cfg, codec_cfg, byt5_cfg, learning_rate=args.learning_rate,
        device=dev)
    state = init_slp_train_state(slp_cfg, codec_cfg.codebook_size,
                                 seed=args.seed + 1, device=dev)

    Trainer(step_fn, eval_fn).fit(
        state, frozen,
        train_batches=lambda: batches(train_ds, batch_size, buckets=buckets,
                                      seed=args.seed),
        val_batches=(lambda: batches(val_ds, batch_size, buckets=buckets,
                                     shuffle=False)) if val_ds else None,
        epochs=args.epochs,
        generator=torch.Generator().manual_seed(args.seed + 3),
        model_name="SLP",
        learning_rate=args.learning_rate or slp_cfg.learning_rate,
        checkpoint_dir=args.checkpoint_dir, checkpoint_interval=5,
        log_path=args.log_path)


if __name__ == "__main__":
    main()
