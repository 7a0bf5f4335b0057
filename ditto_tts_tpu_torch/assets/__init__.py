"""The package's own tokenizer files, so the training entry points run
with no download (the JAX package keeps the same two files in its
``assets/``; the reference fetches the real vocabulary from the HF hub,
ref src/utils/MLS.py:29-32).

GPT2 mini: a byte-level vocabulary (ids 0-255 in byte order, end of text
256) and no merges, a valid byte-level BPE whose ids stay inside GPT2's
50257-row embedding. Its ids are not the real GPT2 ones; the CLIs take
real ``vocab.json`` / ``merges.txt`` files by flag.
"""

from __future__ import annotations

import os

_DIR = os.path.dirname(os.path.abspath(__file__))

GPT2_MINI_VOCAB = os.path.join(_DIR, "gpt2_mini_vocab.json")
GPT2_MINI_MERGES = os.path.join(_DIR, "gpt2_mini_merges.txt")


def gpt2_mini_tokenizer():
    from ..text.tokenizers import GPT2Tokenizer
    return GPT2Tokenizer(GPT2_MINI_VOCAB, GPT2_MINI_MERGES)
