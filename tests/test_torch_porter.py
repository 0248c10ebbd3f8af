"""The port's Porter stemmer (rgrg_tpu_torch/eval/porter.py) against NLTK's
`PorterStemmer()` (its default NLTK_EXTENSIONS mode, which the JAX
package's METEOR uses), word for word.

Corpus: every distinct word of the repository's Markdown files and of the
report sentences in the tests, in their own case, lowercased and
capitalised, plus edge words for each rule NLTK departs on (-ies, -ied,
-ational, -alli, -logi, -ing after a double consonant, the y rules, one-
and two-letter words, the irregular forms, non-ASCII letters).
"""

import pathlib
import re

import pytest
from nltk.stem.porter import PorterStemmer as NltkPorter

from rgrg_tpu_torch.eval.porter import PorterStemmer

ROOT = pathlib.Path(__file__).resolve().parent.parent
EDGE_WORDS = [
    "a", "i", "y", "ab", "is", "as", "us", "ox", "yy", "ies", "ied", "ing", "eed",
    "ties", "lies", "dies", "pies", "ponies", "caresses", "cats", "caress", "skies", "sky",
    "died", "tied", "cried", "spied", "studied", "agreed", "feed", "bleed", "plastered",
    "bled", "motoring", "sing", "conflated", "troubled", "sized", "hopping", "tanned",
    "falling", "hissing", "fizzed", "failing", "filing", "happy", "enjoy", "spy", "fly",
    "try", "say", "syzygy", "toy", "yearly", "boyish", "relational", "conditional",
    "rational", "valenci", "hesitanci", "digitizer", "conformabli", "radicalli",
    "generalli", "differentli", "vileli", "analogousli", "vietnamization", "predication",
    "operator", "feudalism", "decisiveness", "hopefulness", "callousness", "formaliti",
    "sensitiviti", "sensibiliti", "hopefulli", "analogi", "logi", "triplicate",
    "formative", "formalize", "electriciti", "electrical", "hopeful", "goodness",
    "revival", "allowance", "inference", "airliner", "gyroscopic", "adjustable",
    "defensible", "irritant", "replacement", "adjustment", "dependent", "adoption",
    "homologou", "communism", "activate", "angulariti", "homologous", "effective",
    "bowdlerize", "probate", "rate", "cease", "controll", "roll", "dying", "lying",
    "tying", "news", "innings", "outings", "cannings", "howe", "proceed", "exceed",
    "succeed", "opacities", "effusions", "cardiomegaly", "atelectasis", "pneumothorax",
    "consolidation", "unremarkable", "hyperinflated", "bibasilar", "mediastinal",
    "naïve", "café", "röntgen", "İstanbul", "ÄRZTE", "x²", "___", "12", "it's",
]


def corpus():
    text = []
    for path in sorted(ROOT.glob("*.md")) + sorted((ROOT / "docs").rglob("*.md")):
        text.append(path.read_text(encoding="utf-8", errors="ignore"))
    for path in sorted((ROOT / "tests").glob("test_*.py")):
        body = path.read_text(encoding="utf-8", errors="ignore")
        text += re.findall(r'"([A-Z][^"\n]{3,}[.!?])"', body)  # report sentences
    words = set(re.findall(r"[^\W\d_]+(?:'[^\W\d_]+)?", " ".join(text)))
    words |= {w.lower() for w in words} | {w.capitalize() for w in words}
    return sorted(words | set(EDGE_WORDS))


def test_corpus_is_large():
    assert len(corpus()) >= 5000


@pytest.mark.parametrize("part", range(4))
def test_stem_matches_nltk(part):
    words = corpus()[part::4]
    port, ref = PorterStemmer(), NltkPorter()
    bad = [(w, port.stem(w), ref.stem(w)) for w in words if port.stem(w) != ref.stem(w)]
    assert not bad, bad[:20]


@pytest.mark.parametrize("word", EDGE_WORDS)
def test_stem_edge_words(word):
    assert PorterStemmer().stem(word) == NltkPorter().stem(word)
