"""GPT-2 byte-level BPE detokenizer, offline, dependency-free (the port's
own copy, pure Python).

Serving only turns generated ids back into text, so this keeps GPT-2's
vocabulary and byte mapping, not the BPE merges: `from_dir` reads the
standard `vocab.json` from a local directory; pad == bos == eos ==
<|endoftext|>.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, List, Optional

ENDOFTEXT = "<|endoftext|>"


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
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
    return dict(zip(bs, map(chr, cs)))


class GPT2Tokenizer:
    """GPT-2 ids -> text. Load with `GPT2Tokenizer.from_dir(path)`."""

    def __init__(self, encoder: Dict[str, int]):
        self.decoder = {v: k for k, v in encoder.items()}
        self.byte_decoder = {v: k for k, v in _bytes_to_unicode().items()}
        self.eos_token_id = encoder.get(ENDOFTEXT, len(encoder) - 1)
        self.bos_token_id = self.eos_token_id
        self.pad_token_id = self.eos_token_id
        self._decode_table: Optional[List[bytes]] = None  # built lazily

    @classmethod
    def from_dir(cls, path: str) -> "GPT2Tokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def dummy(cls) -> "GPT2Tokenizer":
        """Tiny self-consistent tokenizer for tests: byte-level vocab (no
        merges) + <|endoftext|>; ids are NOT GPT-2-compatible."""
        byte_vocab = list(_bytes_to_unicode().values())
        encoder = {tok: i for i, tok in enumerate(sorted(byte_vocab))}
        encoder[ENDOFTEXT] = len(encoder)
        return cls(encoder)

    @staticmethod
    def clean_up_tokenization(text: str) -> str:
        """Undo BPE artifacts around punctuation/contractions (the
        clean_up_tokenization_spaces=True decode)."""
        return (text.replace(" .", ".").replace(" ?", "?")
                .replace(" !", "!").replace(" ,", ",")
                .replace(" ' ", "'").replace(" n't", "n't")
                .replace(" 'm", "'m").replace(" 's", "'s")
                .replace(" 've", "'ve").replace(" 're", "'re"))

    def _build_decode_table(self) -> List[bytes]:
        """id -> raw bytes: byte-decoder chars map to their byte, anything
        else (special tokens) keeps its utf-8."""
        size = max(self.decoder) + 1 if self.decoder else 0
        table = [b""] * size
        for i, tok in self.decoder.items():
            buf = bytearray()
            for ch in tok:
                if ch in self.byte_decoder:
                    buf.append(self.byte_decoder[ch])
                else:
                    buf.extend(ch.encode("utf-8"))
            table[i] = bytes(buf)
        return table

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True,
               clean_up_tokenization_spaces: bool = True) -> str:
        if self._decode_table is None:
            self._decode_table = self._build_decode_table()
        table = self._decode_table
        n = len(table)
        eos = self.eos_token_id
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        if skip_special_tokens:
            parts = [table[i] for i in ids if 0 <= i < n and i != eos]
        else:
            parts = [table[i] for i in ids if 0 <= i < n]
        out = b"".join(parts).decode("utf-8", errors="replace")
        if clean_up_tokenization_spaces:
            out = self.clean_up_tokenization(out)
        return out
