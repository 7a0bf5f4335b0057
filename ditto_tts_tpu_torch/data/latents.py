"""One-shot frozen-latent precompute and the cached-latent batch iterator
(the JAX package's ``data/latents.py``).

The DiTTo step's frozen encode (EnCodec, the embedding head's gather, the
channel mean) is a pure function of the audio. ``precompute`` runs it once
per utterance on the device (kernel B on the card, under ``no_grad``) and
stores the latents; ``latent_batches`` serves train batches from them, and
the step (``train/steps.py``) takes ``batch["latents"]`` and skips the
encode.

Exactness: each utterance is encoded padded to its own duration bucket
(``mls.bucket_for``), and ``latent_batches`` groups utterances of one
bucket only, so a cached batch is the encode of that batch's audio (on the
CPU bit for bit; on the card a chunk and a batch of other sizes may take
other GEMM algorithms).

Storage, the layout JAX writes, so a cache from either package reads in
the other: fp32 ``bucket_{len}.npy`` [n, T_bucket, H] per bucket under
``cache_dir`` and an ``index.json`` mapping dataset indices to (bucket,
row), with each utterance's seconds and the encode's dtype.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import CodecConfig
from ..models import nac as nac_mod
from ..params import tree_map
from .mls import MLSDataset, bucket_for, default_buckets

_INDEX = "index.json"


def make_encode_fn(codec_cfg: CodecConfig, encode_dtype: str = "bfloat16"):
    """``encode(frozen, audio [B, 1, L], mask [B, L]) -> fp32 [B, T, H]``
    without gradients, on the tensors' device: the frozen codec encode in
    ``encode_dtype`` (the codec's fp32 leaves and the audio cast; convs sum
    in fp32), the embedding head's gather and the channel mean (the audio
    branch of the DiTTo step's encode; ref TrainDiTTO.py:67-73)."""
    enc_dt = getattr(torch, encode_dtype)

    @torch.no_grad()
    def encode(frozen, audio, padding_mask):
        codec = frozen["codec"]
        if enc_dt != torch.float32:
            codec = tree_map(lambda a: a.to(enc_dt)
                             if a.dtype == torch.float32 else a, codec)
            audio = audio.to(enc_dt)
        latents, _ = nac_mod.audio_encoder(
            {"embedding_head": frozen["embedding_head"]}, codec, codec_cfg,
            audio, padding_mask)
        return latents.float().mean(dim=1)

    return encode


def precompute(dataset: MLSDataset, frozen, codec_cfg: CodecConfig, *,
               cache_dir: str, batch_size: int = 8,
               buckets: Optional[Sequence[int]] = None,
               encode_dtype: str = "bfloat16",
               progress: bool = False, device=None) -> Dict:
    """Encode every utterance once (padded to its own bucket) on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; ``frozen``'s ``codec``
    and ``embedding_head`` are moved there) and write the per-bucket
    latent memmaps and the index. Returns the index dict. Re-running over
    an existing complete cache is a no-op."""
    dev = resolve_device(device)
    os.makedirs(cache_dir, exist_ok=True)
    idx_path = os.path.join(cache_dir, _INDEX)
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            index = json.load(f)
        if index.get("n_items") == len(dataset):
            return index

    buckets = list(buckets if buckets is not None
                   else default_buckets(dataset.sample_rate))
    encode = make_encode_fn(codec_cfg, encode_dtype)
    frozen = {k: tree_map(lambda t: t.to(dev), frozen[k])
              for k in ("codec", "embedding_head")}

    # pass 1 decodes for the lengths only (a large corpus does not fit in
    # host memory); pass 2 decodes again, chunk by chunk
    by_bucket: Dict[int, list] = {}
    seconds = [0.0] * len(dataset)
    for i in range(len(dataset)):
        n = len(dataset[i]["audio"])
        seconds[i] = n / dataset.sample_rate
        by_bucket.setdefault(bucket_for(n, buckets), []).append(i)

    rows = {}
    for blen, idxs in sorted(by_bucket.items()):
        mm = None
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            audio = np.zeros((len(chunk), 1, blen), np.float32)
            mask = np.zeros((len(chunk), blen), np.int32)
            for r, di in enumerate(chunk):
                wav = dataset[di]["audio"]
                audio[r, 0, :len(wav)] = wav
                mask[r, :len(wav)] = 1
            lat = encode(frozen, torch.from_numpy(audio).to(dev),
                         torch.from_numpy(mask).to(dev)).cpu().numpy()
            if mm is None:
                mm = np.lib.format.open_memmap(
                    os.path.join(cache_dir, f"bucket_{blen}.npy"), mode="w+",
                    dtype=np.float32,
                    shape=(len(idxs),) + lat.shape[1:])
            mm[start:start + len(chunk)] = lat
            for r, di in enumerate(chunk):
                rows[di] = (blen, start + r)
            if progress:
                print(f"# latents bucket {blen}: "
                      f"{min(start + batch_size, len(idxs))}/{len(idxs)}",
                      flush=True)
        mm.flush()

    index = {"n_items": len(dataset), "buckets": sorted(by_bucket),
             "rows": {str(k): list(v) for k, v in rows.items()},
             "seconds": seconds, "encode_dtype": encode_dtype}
    with open(idx_path, "w") as f:
        json.dump(index, f)
    return index


def latent_batches(cache_dir: str, dataset: MLSDataset, batch_size: int, *,
                   shuffle: bool = True, seed: int = 0,
                   drop_remainder: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Train batches straight from the latent cache (no audio is read):
    utterances of one bucket a batch, shuffled within buckets and across
    batches; text ids and masks from the manifest, ``label`` (the SLP's
    duration class) from the cached seconds."""
    with open(os.path.join(cache_dir, _INDEX)) as f:
        index = json.load(f)
    if index["n_items"] != len(dataset):
        raise ValueError(f"latent cache at {cache_dir} indexes "
                         f"{index['n_items']} items, dataset has "
                         f"{len(dataset)}; re-run precompute()")
    mms = {b: np.load(os.path.join(cache_dir, f"bucket_{b}.npy"),
                      mmap_mode="r") for b in index["buckets"]}
    rows = {int(k): tuple(v) for k, v in index["rows"].items()}
    seconds = index["seconds"]

    rng = np.random.default_rng(seed)
    by_bucket: Dict[int, list] = {}
    for di, (blen, _) in rows.items():
        by_bucket.setdefault(blen, []).append(di)

    batches = []
    for blen, idxs in sorted(by_bucket.items()):
        idxs = list(idxs)
        if shuffle:
            rng.shuffle(idxs)
        n = len(idxs) - (len(idxs) % batch_size if drop_remainder else 0)
        for s in range(0, n, batch_size):
            batches.append(idxs[s:s + batch_size])
    if shuffle:
        rng.shuffle(batches)

    for chunk in batches:
        blen = rows[chunk[0]][0]
        lat = np.stack([mms[blen][rows[di][1]] for di in chunk])
        yield {
            "indices": np.asarray(chunk, np.int32),
            "latents": lat,
            "text_ids": np.stack(
                [np.asarray(dataset.entries[di][1], np.int32)
                 for di in chunk]),
            "text_mask": np.stack(
                [np.asarray(dataset.entries[di][2], np.int32)
                 for di in chunk]),
            "label": np.asarray(
                [np.clip(int(seconds[di]) - 10, 0, 10) for di in chunk],
                np.int32),
        }
