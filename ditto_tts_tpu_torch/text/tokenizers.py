"""The byte-level ByT5 tokenizer (the JAX package's ``text/tokenizers.py``).

ids are UTF-8 bytes + 3 (pad 0, eos 1, unk 2), eos appended, as HF ByT5
counts them. ``__call__`` returns numpy ``input_ids`` / ``attention_mask``
in the HF calling convention. The GPT2 BPE tokenizer needs vocabulary
files and belongs to the CLI.
"""

from __future__ import annotations

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
