"""Porter stemmer in NLTK's default mode (NLTK_EXTENSIONS), pure Python.

The evaluation path stems words for METEOR's stem stage. The JAX package
takes `nltk.stem.porter.PorterStemmer()` for it; the port carries its own
stemmer so that evaluation needs no nltk. It follows the published
algorithm (M. F. Porter, "An algorithm for suffix stripping", 1980, steps
1a-5b) with the departures NLTK documents for its default mode:

  * words of at most two characters, and a small table of irregular forms
    (sky/skies, dying, lying, tying, news, innings, outings, cannings,
    howe, proceed, exceed, succeed), are answered before the steps;
  * step 1a: a four-letter word ending in -ies keeps -ie (ties -> tie);
  * step 1b: -ied becomes -ie in a four-letter word and -i otherwise;
  * *o also holds for a two-letter stem vowel + consonant;
  * step 1c: y -> i only after a consonant that is not the stem's first
    letter (happy -> happi, enjoy -> enjoy, spy -> spi);
  * step 2: -alli -> -al is applied first and step 2 repeated on the
    result; -bli -> -ble replaces -abli -> -able; -fulli -> -ful and
    -logi -> -log (its measure taken on the word without -ogi) are added.

A rule list applies its first rule whose suffix the word ends with; when
that rule's condition fails, the word is left as it is. Input is
lowercased first. Pinned word for word to NLTK's stemmer by
tests/test_torch_porter.py.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

_VOWELS = frozenset("aeiou")

_IRREGULAR = {"skies": "sky", "sky": "sky", "dying": "die", "lying": "lie",
              "tying": "tie", "news": "news", "innings": "inning",
              "inning": "inning", "outings": "outing", "outing": "outing",
              "cannings": "canning", "canning": "canning", "howe": "howe",
              "proceed": "proceed", "exceed": "exceed", "succeed": "succeed"}

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _consonant(word: str, i: int) -> bool:
    """A letter other than a, e, i, o, u, and other than a y that follows a
    consonant."""
    if word[i] in _VOWELS:
        return False
    # a run of y's alternates, starting from the letter before it
    flip = False
    while i > 0 and word[i] == "y":
        flip = not flip
        i -= 1
    return (word[i] not in _VOWELS) != flip


def measure(stem: str) -> int:
    """m in [C](VC)^m[V]: the number of vowel-consonant transitions."""
    m, prev_vowel = 0, False
    for i in range(len(stem)):
        cons = _consonant(stem, i)
        m += prev_vowel and cons
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _consonant(stem, i) for i in range(len(stem)))


def _double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _consonant(word, len(word) - 1)


def _cvc(word: str) -> bool:
    """*o: consonant-vowel-consonant at the end, the last not w, x or y; or
    (an NLTK addition) a two-letter word vowel + consonant."""
    n = len(word)
    if n >= 3:
        return (_consonant(word, n - 3) and not _consonant(word, n - 2)
                and _consonant(word, n - 1) and word[-1] not in "wxy")
    return n == 2 and not _consonant(word, 0) and _consonant(word, 1)


def _m_gt(k: int) -> Callable[[str], bool]:
    return lambda stem: measure(stem) > k


def _apply(word: str, rules: Sequence[Rule]) -> str:
    """The first rule whose suffix ends `word` decides: its replacement when
    its condition holds for the stem, else the word unchanged."""
    for suffix, replacement, cond in rules:
        if word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
            return stem + replacement if cond is None or cond(stem) else word
    return word


def _step1a(word: str) -> str:
    if len(word) == 4 and word.endswith("ies"):
        return word[:-3] + "ie"
    return _apply(word, [("sses", "ss", None), ("ies", "i", None),
                         ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = word[:-3]
        return stem + "ee" if measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _has_vowel(word[:-len(suffix)]):
            stem = word[:-len(suffix)]
            break
    else:
        return word
    for end, full in (("at", "ate"), ("bl", "ble"), ("iz", "ize")):
        if stem.endswith(end):
            return stem[:-2] + full
    if _double_consonant(stem):
        return stem[:-1] if stem[-1] not in "lsz" else stem
    return stem + "e" if measure(stem) == 1 and _cvc(stem) else stem


def _step1c(word: str) -> str:
    if word.endswith("y") and len(word) > 2 and _consonant(word, len(word) - 2):
        return word[:-1] + "i"
    return word


_STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
          ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"),
          ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
          ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
          ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
          ("fulli", "ful")]


def _step2(word: str) -> str:
    if word.endswith("alli") and measure(word[:-4]) > 0:
        return _step2(word[:-4] + "al")
    rules: list = [(s, r, _m_gt(0)) for s, r in _STEP2]
    rules.append(("logi", "log", lambda _stem: measure(word[:-3]) > 0))
    return _apply(word, rules)


def _step3(word: str) -> str:
    return _apply(word, [(s, r, _m_gt(0)) for s, r in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""))])


def _step4(word: str) -> str:
    rules: list = [(s, "", _m_gt(1)) for s in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent")]
    rules.append(("ion", "", lambda stem: measure(stem) > 1 and stem[-1:] in ("s", "t")))
    rules += [(s, "", _m_gt(1)) for s in ("ou", "ism", "ate", "iti", "ous", "ive", "ize")]
    return _apply(word, rules)


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = word[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    if word.endswith("ll") and measure(word[:-1]) > 1:
        return word[:-1]
    return word


class PorterStemmer:
    """`stem(word)` as nltk.stem.porter.PorterStemmer().stem(word)."""

    def stem(self, word: str) -> str:
        w = word.lower()
        if w in _IRREGULAR:
            return _IRREGULAR[w]
        if len(word) <= 2:
            return w
        for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5a, _step5b):
            w = step(w)
        return w
