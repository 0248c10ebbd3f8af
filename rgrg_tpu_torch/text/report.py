"""Report assembly: sentence splitting + exact & soft dedup (host side;
the port's own copy).

Reference behavior (generate_reports_for_images.py:42-104):
  1. join per-region generated sentences with spaces,
  2. sentence-split (spacy in the reference; a rule-based splitter here —
     generated region sentences are simple declaratives ending in '.'),
  3. exact dedup via insertion-ordered dict,
  4. soft dedup: pairwise BERTScore-F1 > 0.9 removes the SHORTER sentence
     (ties remove the first), with the reference's exact loop semantics —
     once sentence i is marked removed its inner loop breaks; removed j's
     are skipped.

The similarity scorer is pluggable and receives ALL candidate pairs at once
(one batched encoder call) — the reference calls the scorer once per pair
(O(n^2) model invocations), a known inefficiency fixed here without changing
results.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

# Candidate boundary: after . ! ? when followed by whitespace + a plausible
# sentence start (uppercase letter, digit, or '('); never splits decimals
# like "1.5 cm" (no whitespace after the '.').
_SENT_BOUNDARY = re.compile(
    r"(?:(?<=[.!?])|(?<=[.!?][)\"']))\s+(?=[A-Z0-9(])")

# Abbreviations whose trailing '.' is not a sentence end (spacy's
# en_core_web_trf parses these through; the reference splits with it,
# evaluate_language_model.py:1180 / create_dataset.py:371). Multi-dot
# abbreviations ("e.g.", "i.e.", "a.m.") are matched on their full lowered
# form with the final dot stripped.
_ABBREVIATIONS = {
    "dr", "mr", "mrs", "ms", "prof", "st", "jr", "sr",
    "vs", "no", "fig", "approx", "cf", "al",   # "et al."
    "e.g", "i.e", "a.m", "p.m",
}
# A standalone 1-2 digit enumerator at the start of a segment ("2. Stable
# appearance.") is a list marker, not a sentence of its own.
_ENUMERATOR = re.compile(r"\d{1,2}")
# A single letter before '.' MAY be a name initial ("A. Smith") — but
# single-letter medical terms end sentences too ("hepatitis B.",
# "vitamin D."), so the initial reading only wins when the next word
# doesn't look like a sentence opener (see _SENTENCE_STARTERS).
_INITIAL = re.compile(r"[A-Za-z]")
_WORD = re.compile(r"[A-Za-z]+")
# Words that open sentences but essentially never follow a name initial:
# "hepatitis B. The lungs ..." splits, "A. Jones" doesn't. Function words +
# the common radiology sentence openers (anatomy, change-language) — on the
# constructed-boundary corpus (scripts/measure_sentencizer_divergence.py)
# the radiology set removes the "vitamin D. Lungs are clear." class of
# merges while surnames after an initial stay unsplit (surnames are not
# openers).
_SENTENCE_STARTERS = frozenset({
    "The", "There", "This", "That", "These", "Those", "No", "A", "An",
    "It", "In", "On", "At", "Of", "Is", "Are", "Was", "Were", "If", "As",
    "For", "With", "By", "To", "Not", "Again", "Otherwise", "Overall",
    # radiology openers
    "Lungs", "Lung", "Heart", "Pulmonary", "Osseous", "Cardiomediastinal",
    "Mediastinal", "Interval", "Unchanged", "Stable", "Persistent",
    "Improving", "Worsening", "Increased", "Decreased", "New", "Mild",
    "Moderate", "Severe", "Small", "Large", "Right", "Left", "Bilateral",
    "Bibasilar", "Patient", "Comparison", "Lines", "Findings",
    "Degenerative", "History", "Low", "Normal", "Redemonstration",
})


def split_sentences(text: str) -> List[str]:
    """Rule-based sentence splitter approximating the reference's spacy
    en_core_web_trf pipeline on MIMIC-style report text.

    Decisions pinned in tests/test_text.py (the divergence corpus):
      - split after [.!?] + whitespace + [A-Z0-9(];
      - do NOT split after known abbreviations, single-letter initials, or
        a leading numbered-list marker;
      - a '.'-less final fragment is kept as its own sentence;
      - period + whitespace + lowercase is treated as a continuation (the
        trf parser usually agrees on MIMIC phrasing; divergence is possible
        on genuinely lowercase sentence starts, which the tokenizer's
        capitalized region sentences don't produce).
    """
    text = text.strip()
    if not text:
        return []
    parts: List[str] = []
    start = 0
    for m in _SENT_BOUNDARY.finditer(text):
        segment = text[start:m.start()]
        words = segment.split()
        last = words[-1] if words else ""
        if last.endswith("."):
            word = last[:-1].lower()
            if word in _ABBREVIATIONS:
                continue
            if _INITIAL.fullmatch(word) and last[:-1].isupper():
                # uppercase single letter: initial ("A. Jones") unless the
                # next word opens a sentence ("hepatitis B. The lungs...")
                nxt = _WORD.match(text[m.end():])
                if not nxt or nxt.group(0) not in _SENTENCE_STARTERS:
                    continue
            if len(words) == 1 and _ENUMERATOR.fullmatch(word):
                continue  # "2." opening the segment: list marker
        parts.append(segment)
        start = m.end()
    parts.append(text[start:])
    return [p for p in parts if p]


SimilarityFn = Callable[[List[Tuple[str, str]]], List[float]]


def remove_duplicate_sentences(sentences: Sequence[str],
                               similarity_fn: Optional[SimilarityFn] = None,
                               threshold: float = 0.9) -> List[str]:
    """Exact + soft dedup with the reference's removal-loop semantics."""
    sents = list(dict.fromkeys(sentences))  # ordered exact dedup
    if similarity_fn is None or len(sents) < 2:
        return sents

    pairs = [(sents[i], sents[j])
             for i in range(len(sents)) for j in range(i + 1, len(sents))]
    scores = similarity_fn(pairs)
    score = {}
    k = 0
    for i in range(len(sents)):
        for j in range(i + 1, len(sents)):
            score[(i, j)] = scores[k]
            k += 1

    removed = defaultdict(list)

    def is_removed(s: str) -> bool:
        return any(s in v for v in removed.values())

    for i in range(len(sents)):
        s1 = sents[i]
        for j in range(i + 1, len(sents)):
            if is_removed(s1):
                break
            s2 = sents[j]
            if is_removed(s2):
                continue
            if score[(i, j)] > threshold:
                # remove the shorter (equal lengths remove s1, matching the
                # reference's `len(s1) > len(s2)` branch)
                if len(s1) > len(s2):
                    removed[s1].append(s2)
                else:
                    removed[s2].append(s1)

    kept = [s for s in sents if not is_removed(s)]
    return kept


def assemble_report(region_sentences: Sequence[str],
                    similarity_fn: Optional[SimilarityFn] = None,
                    threshold: float = 0.9) -> str:
    """Per-region generated sentences -> deduplicated report string."""
    joined = " ".join(s for s in region_sentences if s)
    return " ".join(remove_duplicate_sentences(split_sentences(joined),
                                               similarity_fn, threshold))
