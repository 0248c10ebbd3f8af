"""BERT WordPiece tokenizer (offline, dependency-free; the port's own copy).

Used by the BERTScore soft-dedup scorer (eval/bertscore.py) and, later, the
CheXbert CE labeler; mirrors HF BertTokenizer (bert-base-uncased
conventions) for the inputs CheXbert sees: lowercase, accent-strip, CJK and
punctuation splitting, greedy longest-match WordPiece with "##"
continuations, [CLS]/[SEP] wrapping, 512-token truncation with a forced
final [SEP] (reference bert_tokenizer.py:31-33).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    # clean: drop control chars, normalize whitespace
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        out.append(" " if ch in "\t\n\r" or unicodedata.category(ch) == "Zs" else ch)
    text = "".join(out)
    # CJK spacing
    text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)

    tokens = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        # split punctuation
        cur = []
        for ch in tok:
            if _is_punct(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 unk: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.unk = unk
        self.max_chars = max_chars_per_word
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.pad_id = vocab.get("[PAD]", 0)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for w in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(w))
        return out

    def encode(self, text: str, max_len: int = 512) -> List[int]:
        """[CLS] tokens [SEP], truncated at max_len with forced final [SEP]
        (reference bert_tokenizer.py:31-33)."""
        ids = [self.cls_id] + [self.vocab.get(t, self.vocab.get(self.unk, 100))
                               for t in self.tokenize(text)] + [self.sep_id]
        if len(ids) > max_len:
            ids = ids[:max_len - 1] + [self.sep_id]
        return ids

    def encode_batch(self, texts: List[str], max_len: int = 512):
        """Returns (ids [N, L], mask [N, L]) numpy-friendly lists, padded to
        the batch max."""
        seqs = [self.encode(t, max_len) for t in texts]
        longest = max(len(s) for s in seqs)
        ids = [s + [self.pad_id] * (longest - len(s)) for s in seqs]
        mask = [[1] * len(s) + [0] * (longest - len(s)) for s in seqs]
        return ids, mask
