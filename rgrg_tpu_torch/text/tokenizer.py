"""Byte-level BPE tokenizer (GPT-2 algorithm), offline, dependency-free (the
port's own copy, pure Python).

Loads the standard `vocab.json` + `merges.txt` from a local directory;
pad == bos == eos == <|endoftext|>. Region phrases are encoded as
"<|endoftext|>" + phrase + "<|endoftext|>" (`encode(add_special=True)`).

GPT-2 pre-tokenizes with the `regex` pattern
  's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
The port does without `regex`: `pretokenize` is a scanner that takes the
same alternatives in the same order, with the classes read from
`unicodedata` (L* categories are letters, N* numbers) and `\\s` as the
Unicode White_Space set below. It agrees with `regex` on every character
that the interpreter's Unicode tables assign; a newer `regex` also classes
characters assigned after them, which are "other" here.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

ENDOFTEXT = "<|endoftext|>"

# `regex`'s \s: the Unicode White_Space property (not str.isspace, which
# also takes the separators U+001C-U+001F)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=4096)
def _char_class(ch: str) -> str:
    """'S' whitespace, 'L' letter, 'N' number, 'O' anything else."""
    if ch in _WHITESPACE:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else "O"


def pretokenize(text: str) -> List[str]:
    """GPT-2's pre-tokenization of `text` (module docstring): the pieces
    `regex.findall` gives for the pattern, in order."""
    out: List[str] = []
    n = len(text)
    pos = 0
    while pos < n:
        ch = text[pos]
        if ch == "'":
            suffix = next((s for s in _CONTRACTIONS if text.startswith(s, pos + 1)), None)
            if suffix is not None:
                out.append(text[pos:pos + 1 + len(suffix)])
                pos += 1 + len(suffix)
                continue
        # ` ?\p{L}+`, ` ?\p{N}+`, ` ?[^\s\p{L}\p{N}]+`: one optional space
        # (U+0020 only) before a run of one class
        start = pos
        head = pos + 1 if ch == " " and pos + 1 < n and _char_class(text[pos + 1]) != "S" else pos
        kind = _char_class(text[head])
        if kind != "S":
            end = head + 1
            while end < n and _char_class(text[end]) == kind:
                end += 1
            out.append(text[start:end])
            pos = end
            continue
        # `\s+(?!\S)` backs off one character when the run is followed by
        # a non-space; a single whitespace before one falls to `\s+`
        end = pos + 1
        while end < n and text[end] in _WHITESPACE:
            end += 1
        if end < n and end - pos > 1:
            end -= 1
        out.append(text[pos:end])
        pos = end
    return out


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


def _get_pairs(word: Sequence[str]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2Tokenizer:
    """Exact GPT-2 BPE. Load with `GPT2Tokenizer.from_dir(path)` where path
    holds vocab.json and merges.txt."""

    def __init__(self, encoder: Dict[str, int], merges: Sequence[tuple] = ()):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, str] = {}
        self.eos_token_id = encoder.get(ENDOFTEXT, len(encoder) - 1)
        self.bos_token_id = self.eos_token_id
        self.pad_token_id = self.eos_token_id
        self._decode_table: Optional[List[bytes]] = None  # built lazily

    @classmethod
    def from_dir(cls, path: str) -> "GPT2Tokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            encoder = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(encoder, merges)

    @classmethod
    def dummy(cls, extra_words: Iterable[str] = ()) -> "GPT2Tokenizer":
        """Tiny self-consistent tokenizer for tests: byte-level vocab (no
        merges) + <|endoftext|>; ids are NOT GPT-2-compatible.
        `extra_words` is accepted and unused, as in the JAX package."""
        byte_vocab = list(_bytes_to_unicode().values())
        encoder = {tok: i for i, tok in enumerate(sorted(byte_vocab))}
        encoder[ENDOFTEXT] = len(encoder)
        return cls(encoder, [])

    # -------------------- BPE --------------------

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str, add_special: bool = False) -> List[int]:
        """Plain text -> ids. With add_special, wrapped in eos ids the way
        the reference wraps region phrases."""
        ids: List[int] = []
        for token in pretokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        if add_special:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    # -------------------- decode --------------------

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

    def batch_decode(self, batch: Iterable[Iterable[int]],
                     skip_special_tokens: bool = True,
                     clean_up_tokenization_spaces: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens,
                            clean_up_tokenization_spaces) for row in batch]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def pad_batch(self, sequences: List[List[int]], max_len: Optional[int] = None):
        """Right-pad to max length; returns (ids [N, L], mask [N, L]) lists
        (HF tokenizer.pad with pad_token = eos)."""
        if max_len is None:
            max_len = max((len(s) for s in sequences), default=1)
        ids, mask = [], []
        for s in sequences:
            s = list(s)[:max_len]
            pad = max_len - len(s)
            ids.append(s + [self.pad_token_id] * pad)
            mask.append([1] * len(s) + [0] * pad)
        return ids, mask
