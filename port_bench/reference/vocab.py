"""The benchmark's vocabulary: id i (but EOS) is the word ' ' + word(i),
so that text maps to ids and back one to one, without the program's
tokenizer."""

from __future__ import annotations

from typing import List


def word(i: int) -> str:
    """The i-th word: 'q' and four base-26 letters."""
    letters = []
    for _ in range(4):
        i, r = divmod(i, 26)
        letters.append(chr(97 + r))
    return "q" + "".join(letters)


def text_ids(text: str) -> List[int]:
    """Text -> ids (the inverse of `word`); an unknown word maps to -1."""
    out = []
    for w in text.split():
        ok = len(w) == 5 and w[0] == "q" and all("a" <= c <= "z" for c in w[1:])
        out.append(sum((ord(c) - 97) * 26 ** k for k, c in enumerate(w[1:])) if ok else -1)
    return out
