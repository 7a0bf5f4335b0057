"""The package's own tokenizer files, so the training and evaluation entry
points run with no download (the JAX package keeps the same three files in
its ``assets/``; the reference fetches the real vocabulary from the HF hub,
ref src/utils/MLS.py:29-32).

GPT2 mini: a byte-level vocabulary (ids 0-255 in byte order, end of text
256) and no merges, a valid byte-level BPE whose ids stay inside GPT2's
50257-row embedding. Its ids are not the real GPT2 ones; the CLIs take
real ``vocab.json`` / ``merges.txt`` files by flag.

S2T mini: HF Speech2Text's special tokens (<s>, <pad>, </s>, <unk> and the
``<lang:xx>`` codes, so ``lang_code_to_id["fr"]`` works) and character
pieces, 122 entries, for transcript decoding without the sentencepiece
files.
"""

from __future__ import annotations

import os

_DIR = os.path.dirname(os.path.abspath(__file__))

GPT2_MINI_VOCAB = os.path.join(_DIR, "gpt2_mini_vocab.json")
GPT2_MINI_MERGES = os.path.join(_DIR, "gpt2_mini_merges.txt")
S2T_MINI_VOCAB = os.path.join(_DIR, "s2t_mini_vocab.json")


def gpt2_mini_tokenizer():
    from ..text.tokenizers import GPT2Tokenizer
    return GPT2Tokenizer(GPT2_MINI_VOCAB, GPT2_MINI_MERGES)


def s2t_mini_tokenizer():
    from ..text.s2t_tokenizer import S2TTokenizer
    return S2TTokenizer.from_file(S2T_MINI_VOCAB)
