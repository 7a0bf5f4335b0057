"""Speech2Text (S2T) transcript decoding in pure Python, no sentencepiece
(the JAX package's ``text/s2t_tokenizer.py``).

Behavioural spec: HF ``Speech2TextTokenizer`` as the reference uses it for
ASR transcripts (ref src/model/Speech2Text.py:19-21 ``batch_decode`` and
:11 ``forced_bos_token_id=tokenizer.lang_code_to_id['fr']``). Decoding a
SentencePiece unigram model needs only the id -> piece table: the pieces
are joined and the word-boundary marker ``▁`` becomes a space (s2t-medium
has no byte fallback). The spm binary is needed only to encode, which
evaluation never does.

  * ``S2TTokenizer(vocab)``: id -> piece decode and special-token
    filtering, as ``Speech2TextTokenizer.convert_tokens_to_string``;
  * ``lang_code_to_id``: the ``<lang:xx>`` ids (the forced BOS);
  * ``S2TTokenizer.from_file(path)``: a ``vocab.json``;
  * ``S2TTokenizer.placeholder(n)``: a stand-in vocabulary with HF S2T's
    special layout and synthetic word pieces, so hypotheses are text, but
    not the trained model's mapping.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

SPIECE_UNDERLINE = "▁"
MUSTC_LANGS = ("pt", "fr", "ru", "nl", "ro", "it", "es", "de")


class S2TTokenizer:
    def __init__(self, vocab: Dict[str, int], *, do_upper_case: bool = False,
                 langs: Sequence[str] = MUSTC_LANGS):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.do_upper_case = do_upper_case
        self.special_tokens = {"<s>", "<pad>", "</s>", "<unk>"} | {
            f"<lang:{lang}>" for lang in langs}
        self.eos_token_id = self.vocab.get("</s>", 2)
        self.pad_token_id = self.vocab.get("<pad>", 1)
        self.lang_code_to_id = {
            lang: self.vocab[f"<lang:{lang}>"] for lang in langs
            if f"<lang:{lang}>" in self.vocab}

    @classmethod
    def from_file(cls, vocab_json_path: str, **kw) -> "S2TTokenizer":
        with open(vocab_json_path, encoding="utf-8") as f:
            return cls(json.load(f), **kw)

    @classmethod
    def placeholder(cls, vocab_size: int = 10000,
                    langs: Sequence[str] = MUSTC_LANGS) -> "S2TTokenizer":
        """HF S2T's special layout (<s>=0 <pad>=1 </s>=2 <unk>=3, then the
        language codes); every other id is a synthetic word piece."""
        vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
        for i, lang in enumerate(langs):
            vocab[f"<lang:{lang}>"] = 4 + i
        for i in range(4 + len(langs), vocab_size):
            vocab[f"{SPIECE_UNDERLINE}tok{i}"] = i
        return cls(vocab, langs=langs)

    def convert_tokens_to_string(self, tokens: List[str]) -> str:
        """``Speech2TextTokenizer.convert_tokens_to_string`` with the piece
        decode in Python (join, ``▁`` to a space, strip)."""
        def sp_decode(pieces: List[str]) -> str:
            return "".join(pieces).replace(SPIECE_UNDERLINE, " ").strip()

        def case(s: str) -> str:
            return s.upper() if self.do_upper_case else s

        out, current = "", []
        for token in tokens:
            if token in self.special_tokens:
                out += case(sp_decode(current)) + token + " "
                current = []
            else:
                current.append(token)
        out += case(sp_decode(current))
        return out.strip()

    def decode(self, ids: Sequence[int], *,
               skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        # a generated sequence starts with the decoder-start token, </s> for
        # S2T: drop it before cutting at the first EOS, as generate() does
        if ids and ids[0] == self.eos_token_id:
            ids = ids[1:]
        if self.eos_token_id in ids:
            ids = ids[:ids.index(self.eos_token_id) + 1]
        tokens = [self.id_to_token.get(i, "<unk>") for i in ids]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in self.special_tokens]
        return self.convert_tokens_to_string(tokens)

    def batch_decode(self, batch_ids, **kw) -> List[str]:
        return [self.decode(ids, **kw) for ids in batch_ids]
