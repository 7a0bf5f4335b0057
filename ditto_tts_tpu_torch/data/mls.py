"""MLS-layout corpus: manifest, tokenize cache, bucketed batches, host
sharding (the JAX package's ``data/mls.py``; ref src/utils/MLS.py:10-154).

  * ``transcripts.txt`` (``{id}\t{text}``) -> audio at
    ``audio_clean/{speaker}/{book}/{id}.opus``;
  * the tokenized manifest cached as ``tokenized_{name}_{len}.json`` in the
    corpus directory, a JSON list of ``[path, ids, mask]``, the file and
    format JAX writes, so a cache written by either package reads in the
    other;
  * duration label ``clip(int(seconds) - 10, 0, 10)``, a strict 10-20 s
    bound;
  * ``collate`` pads to a bucket and marks the padding 0 in the mask (the
    reference padded it with True, quirk #6, corrected);
  * padding buckets (``default_buckets``: 10, 12.5, 15, 17.5 and 20 s) so
    a batch takes one of a few shapes; each process takes items
    ``[i::n]``.

Batches are numpy; the train steps move them to the device.
``batches_native`` takes the C++ prefetching loader (``native_loader``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .processing import decode_audio


def default_buckets(sample_rate: int = 24000,
                    min_s: float = 10.0, max_s: float = 20.0,
                    num: int = 5) -> Tuple[int, ...]:
    """Bucket boundaries in samples, covering [min_s, max_s]."""
    edges = np.linspace(min_s, max_s, num)
    return tuple(int(e * sample_rate) for e in edges)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class MLSDataset:
    """Manifest + tokenization; items decoded lazily on access."""

    def __init__(self, data_dir: str, tokenizer, max_text_token_length: int,
                 *, sample_rate: int = 24000, nb_samples: Optional[int] = None,
                 tokenizer_name: str = "tok", strict_duration: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        self.data_dir = data_dir
        self.audio_dir = os.path.join(data_dir, "audio_clean")
        self.sample_rate = sample_rate
        self.tokenizer = tokenizer
        self.max_len = max_text_token_length
        self.strict_duration = strict_duration

        cache = os.path.join(
            data_dir, f"tokenized_{tokenizer_name}_{max_text_token_length}.json")
        if os.path.exists(cache):
            with open(cache, encoding="utf-8") as f:
                self.entries = json.load(f)
        else:
            self.entries = self._build_manifest()
            # written whole under another name, then renamed: a process that
            # opens the cache (another rank) never finds it half written
            tmp = f"{cache}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(self.entries, f)
                os.replace(tmp, cache)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)

        self.entries = self.entries[shard_index::num_shards]
        if nb_samples is not None:
            self.entries = self.entries[:nb_samples]

    def _build_manifest(self) -> List:
        transcripts = os.path.join(self.data_dir, "transcripts.txt")
        if not os.path.exists(transcripts):
            raise FileNotFoundError(transcripts)
        entries = []
        with open(transcripts, encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 2:
                    continue
                utt_id, text = parts
                pieces = utt_id.split("_")
                if len(pieces) < 2:
                    continue
                path = os.path.join(self.audio_dir, pieces[0], pieces[1],
                                    utt_id + ".opus")
                if not os.path.exists(path):
                    continue
                out = self.tokenizer(text, max_length=self.max_len,
                                     padding="max_length", truncation=True)
                entries.append([path,
                                out["input_ids"][0].tolist(),
                                out["attention_mask"][0].tolist()])
        return entries

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path, ids, mask = self.entries[idx]
        wav = decode_audio(path, self.sample_rate)
        seconds = len(wav) / self.sample_rate
        if self.strict_duration and not (10.0 <= seconds <= 20.0):
            raise ValueError(
                f"duration {seconds:.2f}s out of [10, 20] for {path}")
        label = int(np.clip(int(seconds) - 10, 0, 10))
        return {
            "audio": wav.astype(np.float32),
            "text_ids": np.asarray(ids, np.int32),
            "text_mask": np.asarray(mask, np.int32),
            "label": np.int32(label),
        }


def collate(items: List[Dict[str, np.ndarray]],
            buckets: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """Pad audio to the bucket length; masks mark real samples as 1."""
    max_len = max(len(it["audio"]) for it in items)
    target = bucket_for(max_len, buckets) if buckets else max_len
    b = len(items)
    audio = np.zeros((b, 1, target), np.float32)
    mask = np.zeros((b, target), np.int32)
    for i, it in enumerate(items):
        n = min(len(it["audio"]), target)
        audio[i, 0, :n] = it["audio"][:n]
        mask[i, :n] = 1
    return {
        "audio": audio,
        "padding_mask": mask,
        "text_ids": np.stack([it["text_ids"] for it in items]),
        "text_mask": np.stack([it["text_mask"] for it in items]),
        "label": np.asarray([it["label"] for it in items], np.int32),
    }


def batches_native(dataset: MLSDataset, batch_size: int, *,
                   buckets: Sequence[int], workers: int = 4,
                   shuffle: bool = True, seed: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches through the C++ prefetching loader: decode, resample and
    pad on its worker threads; the text fields are joined here by item
    index."""
    from .native_loader import NativeLoader

    paths = [e[0] for e in dataset.entries]
    loader = NativeLoader(paths, sample_rate=dataset.sample_rate,
                          batch_size=batch_size, buckets=list(buckets),
                          workers=workers, seed=seed, shuffle=shuffle)
    try:
        for b in loader:
            idxs = b.pop("indices")
            b["text_ids"] = np.stack(
                [np.asarray(dataset.entries[i][1], np.int32) for i in idxs])
            b["text_mask"] = np.stack(
                [np.asarray(dataset.entries[i][2], np.int32) for i in idxs])
            secs = b["padding_mask"].sum(axis=1) / dataset.sample_rate
            b["label"] = np.clip(secs.astype(np.int32) - 10, 0, 10)
            yield b
    finally:
        loader.close()


def batches(dataset: MLSDataset, batch_size: int, *,
            buckets: Optional[Sequence[int]] = None,
            shuffle: bool = True, seed: int = 0,
            drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yield collated batches; length-sorted within shuffle windows so each
    batch pads to a single bucket."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order) - (len(order) % batch_size if drop_remainder else 0)
    for start in range(0, n, batch_size):
        idxs = order[start:start + batch_size]
        yield collate([dataset[i] for i in idxs], buckets)
