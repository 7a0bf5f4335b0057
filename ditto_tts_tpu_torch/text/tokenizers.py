"""The tokenizers of the JAX package's ``text/tokenizers.py``.

  * ``ByT5Tokenizer``: ids are UTF-8 bytes + 3 (pad 0, eos 1, unk 2), eos
    appended, as HF ByT5 counts them;
  * ``GPT2Tokenizer``: GPT2's byte-level BPE from a ``vocab.json`` and a
    ``merges.txt`` (HF's pre-tokenizer pattern and byte-to-unicode map;
    pad = eos, ref MLS.py:31-32); ``assets.gpt2_mini_tokenizer()`` is the
    package's own byte-level mini vocabulary.

``__call__`` returns numpy ``input_ids`` / ``attention_mask`` in the HF
calling convention.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def _pad_and_mask(ids_list: List[List[int]], max_length: Optional[int],
                  padding: str, truncation: bool, pad_id: int):
    if truncation and max_length is not None:
        ids_list = [ids[:max_length] for ids in ids_list]
    if padding == "max_length" and max_length is not None:
        target = max_length
    else:
        target = max(len(ids) for ids in ids_list) if ids_list else 0
    out_ids = np.full((len(ids_list), target), pad_id, np.int32)
    mask = np.zeros((len(ids_list), target), np.int32)
    for i, ids in enumerate(ids_list):
        out_ids[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1
    return {"input_ids": out_ids, "attention_mask": mask}


class ByT5Tokenizer:
    """HF ByT5 semantics: id = byte + 3; pad=0, eos=1, unk=2."""

    pad_token_id = 0
    eos_token_id = 1
    offset = 3

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = [b + self.offset for b in text.encode("utf-8")]
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self.offset for i in ids if i >= self.offset)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: Union[str, Sequence[str]],
                 max_length: Optional[int] = None,
                 padding: str = "max_length",
                 truncation: bool = True) -> Dict[str, np.ndarray]:
        texts = [text] if isinstance(text, str) else list(text)
        ids = [self.encode(t) for t in texts]
        return _pad_and_mask(ids, max_length, padding, truncation,
                             self.pad_token_id)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT2's reversible byte<->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_GPT2_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE)


class GPT2Tokenizer:
    """Byte-level BPE. Requires vocab.json + merges.txt file paths."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, List[str]] = {}
        self.eos_token_id = self.encoder.get("<|endoftext|>",
                                             len(self.encoder) - 1)
        self.pad_token_id = self.eos_token_id  # ref: MLS.py:31-32

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _GPT2_PAT.findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytes(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: Union[str, Sequence[str]],
                 max_length: Optional[int] = None,
                 padding: str = "max_length",
                 truncation: bool = True) -> Dict[str, np.ndarray]:
        texts = [text] if isinstance(text, str) else list(text)
        ids = [self.encode(t) for t in texts]
        return _pad_and_mask(ids, max_length, padding, truncation,
                             self.pad_token_id)
