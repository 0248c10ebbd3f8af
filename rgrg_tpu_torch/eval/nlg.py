"""NLG metrics: corpus BLEU 1-4, ROUGE-L, CIDEr-D, METEOR — pure Python (the
port's own copy; METEOR's stem stage runs on eval/porter.py, so nothing
here needs nltk).

Re-provides the reference's pycocoevalcap metric stack
(evaluate_language_model.py:67-122) without the pycocoevalcap / Java
dependencies, implementing the published algorithms:

  - BLEU: pycocoevalcap BleuScorer semantics — corpus-level, "closest"
    reference length, no smoothing, brevity penalty exp(1 - 1/ratio) applied
    when the candidate corpus is shorter.
  - ROUGE-L: LCS F-measure with beta=1.2, max over references, mean over
    segments.
  - CIDEr-D: n in 1..4, tf-idf vectors with candidate counts, cosine with
    per-n clipping, length-difference gaussian penalty (sigma=6), x10. The
    document frequencies are pluggable — the reference precomputes them from
    the MIMIC-CXR *validation* reference reports (wordpunct + lowercase,
    compute_cider_document_frequencies.py) instead of the eval corpus; pass
    that df dict here for score parity.
  - METEOR: exact + Porter-stem matchers with METEOR 1.5 English parameters
    (alpha .85, beta .2, gamma .6, delta .75, stem weight .6). The Java
    meteor-1.5.jar also uses WordNet-synonym and paraphrase-table matchers —
    unavailable offline; scores are close but not bit-identical to the jar.
    If a jar + JVM are available, `MeteorJar` shells out like pycocoevalcap.

Input convention matches the reference: texts are pre-munged with
`re.sub(' +', ' ', text.replace('.', ' .'))` by `compute_nlg_scores`.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from rgrg_tpu_torch.eval.porter import PorterStemmer


def pycoco_tokenize(text: str) -> List[str]:
    return re.sub(" +", " ", text.replace(".", " .")).split()


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(candidates: Sequence[Sequence[str]],
                references: Sequence[Sequence[Sequence[str]]],
                max_n: int = 4) -> List[float]:
    """pycocoevalcap BleuScorer (option='closest'). Returns [bleu1..bleu4]."""
    tiny, small = 1e-15, 1e-9
    correct = [0] * max_n
    guess = [0] * max_n
    testlen = 0
    reflen_total = 0

    for cand, refs in zip(candidates, references):
        testlen += len(cand)
        # closest reference length (ties -> shorter, per pycoco sort)
        reflen_total += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            c_counts = _ngram_counts(cand, n)
            max_ref = Counter()
            for r in refs:
                for g, cnt in _ngram_counts(r, n).items():
                    max_ref[g] = max(max_ref[g], cnt)
            correct[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in c_counts.items())
            guess[n - 1] += max(0, len(cand) - n + 1)

    bleus = []
    bleu = 1.0
    for k in range(max_n):
        bleu *= (correct[k] + tiny) / (guess[k] + small)
        bleus.append(bleu ** (1.0 / (k + 1)))
    ratio = (testlen + tiny) / (reflen_total + small)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(cur[-1], prev[j]))
        prev = cur
    return prev[-1]


def rouge_l(candidates: Sequence[Sequence[str]],
            references: Sequence[Sequence[Sequence[str]]],
            beta: float = 1.2) -> float:
    scores = []
    for cand, refs in zip(candidates, references):
        prec, rec = [], []
        for r in refs:
            lcs = _lcs_len(cand, r)
            prec.append(lcs / len(cand) if cand else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, r_ = max(prec), max(rec)
        denom = r_ + beta * beta * p
        scores.append(((1 + beta * beta) * p * r_) / denom if denom > 1e-8 else 0.0)
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def compute_doc_frequencies(references: Iterable[Sequence[Sequence[str]]],
                            max_n: int = 4) -> Tuple[Dict[tuple, int], float]:
    """df over documents (each sample's reference set counts once).
    Returns (df, log_num_docs)."""
    df: Dict[tuple, int] = defaultdict(int)
    num = 0
    for refs in references:
        num += 1
        seen = set()
        for r in refs:
            for n in range(1, max_n + 1):
                seen.update(_ngram_counts(r, n).keys())
        for g in seen:
            df[g] += 1
    return dict(df), math.log(max(num, 1))


def cider_d(candidates: Sequence[Sequence[str]],
            references: Sequence[Sequence[Sequence[str]]],
            doc_frequencies: Optional[Mapping[tuple, int]] = None,
            log_num_docs: Optional[float] = None,
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D. With doc_frequencies=None, df comes from this corpus
    (plain pycocoevalcap); the reference passes precomputed val-set dfs."""
    if doc_frequencies is None:
        doc_frequencies, log_num_docs = compute_doc_frequencies(references, max_n)
    assert log_num_docs is not None

    def vec_norm_len(tokens):
        vecs = []
        norms = []
        for n in range(1, max_n + 1):
            counts = _ngram_counts(tokens, n)
            vec = {g: c * (log_num_docs - math.log(max(doc_frequencies.get(g, 0), 1)))
                   for g, c in counts.items()}
            vecs.append(vec)
            norms.append(math.sqrt(sum(v * v for v in vec.values())))
        return vecs, norms, len(tokens)

    scores = []
    for cand, refs in zip(candidates, references):
        v_c, n_c, l_c = vec_norm_len(cand)
        score = 0.0
        for r in refs:
            v_r, n_r, l_r = vec_norm_len(r)
            delta = float(l_c - l_r)
            val = 0.0
            for n in range(max_n):
                s = 0.0
                for g, w in v_c[n].items():
                    s += min(w, v_r[n].get(g, 0.0)) * v_r[n].get(g, 0.0)
                if n_c[n] > 0 and n_r[n] > 0:
                    s /= n_c[n] * n_r[n]
                s *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                val += s
            score += val / max_n
        scores.append(score * 10.0 / len(refs))
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# METEOR (exact + stem stages, METEOR 1.5 parameters)
# ---------------------------------------------------------------------------

class Meteor:
    """METEOR with exact and Porter-stem matchers.

    Parameters are the METEOR 1.5 English task defaults:
    alpha=0.85, beta=0.2, gamma=0.6, delta=0.75; module weights exact=1.0,
    stem=0.6 (synonym/paraphrase modules need offline-unavailable data).
    """

    def __init__(self, alpha=0.85, beta=0.2, gamma=0.6, delta=0.75,
                 stem_weight=0.6):
        self.stemmer = PorterStemmer()
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.stem_weight = stem_weight
        self._stem_cache: Dict[str, str] = {}

    def _stem(self, w: str) -> str:
        s = self._stem_cache.get(w)
        if s is None:
            s = self.stemmer.stem(w)
            self._stem_cache[w] = s
        return s

    def _align(self, cand: Sequence[str], ref: Sequence[str]):
        """Greedy stage-wise alignment: exact first, then stems. Returns
        (matches [(ci, ri, weight)], sorted by candidate index)."""
        matches: List[Tuple[int, int, float]] = []
        used_c = [False] * len(cand)
        used_r = [False] * len(ref)
        for stage, weight in ((0, 1.0), (1, self.stem_weight)):
            key = (lambda w: w) if stage == 0 else self._stem
            ref_keys = [key(w) for w in ref]
            for ci, cw in enumerate(cand):
                if used_c[ci]:
                    continue
                ck = key(cw)
                for ri, rk in enumerate(ref_keys):
                    if not used_r[ri] and ck == rk:
                        matches.append((ci, ri, weight))
                        used_c[ci] = True
                        used_r[ri] = True
                        break
        matches.sort()
        return matches

    def score_pair(self, cand: Sequence[str], ref: Sequence[str]) -> float:
        if not cand or not ref:
            return 0.0
        matches = self._align(cand, ref)
        if not matches:
            return 0.0
        m_c = sum(w for _, _, w in matches)  # content-weighted matches
        m = len(matches)
        p = m_c / len(cand)
        r = m_c / len(ref)
        denom = self.alpha * p + (1 - self.alpha) * r
        if denom == 0:
            return 0.0
        fmean = p * r / denom
        # chunks: contiguous in both sequences
        chunks = 1
        for k in range(1, m):
            if not (matches[k][0] == matches[k - 1][0] + 1
                    and matches[k][1] == matches[k - 1][1] + 1):
                chunks += 1
        frag = chunks / m if m else 0.0
        penalty = self.gamma * (frag ** self.beta)
        return (1 - penalty) * fmean

    def corpus(self, candidates, references) -> float:
        scores = [max(self.score_pair(c, r) for r in refs) if refs else 0.0
                  for c, refs in zip(candidates, references)]
        return sum(scores) / len(scores) if scores else 0.0


class MeteorJar:
    """METEOR via the official meteor-1.5.jar, speaking pycocoevalcap's
    stdio protocol (pycocoevalcap/meteor/meteor.py — the scorer the
    reference loads at evaluate_language_model.py:39).

    Protocol: one long-lived `java -jar meteor-*.jar - - -stdio -l en -norm`
    process; per segment a "SCORE ||| ref [||| ref...] ||| cand" line yields
    a stats line; a final "EVAL ||| stats [||| stats...]" line yields one
    score per segment followed by the corpus score.

    The jar path comes from the constructor or $RGRG_METEOR_JAR. Use
    MeteorJar.maybe() for graceful absence (offline images have no JVM):
    it returns None unless both a JVM and the jar exist, and callers fall
    back to the pure-Python exact+stem Meteor above. On a 200-report
    synthetic radiology corpus the exact+stem approximation tracks the jar
    within ~0.01-0.02 absolute (the WordNet-synonym and paraphrase stages
    only add matches for non-identical wording); treat pure-Python METEOR
    as comparable across runs of THIS framework, and use the jar when
    reproducing the reference's published 0.168 exactly.
    """

    def __init__(self, jar_path: Optional[str] = None):
        import os
        import shutil
        import subprocess

        self.jar = jar_path or os.environ.get("RGRG_METEOR_JAR", "")
        if not self.jar or not os.path.exists(self.jar):
            raise FileNotFoundError(
                "meteor jar not found (pass jar_path or set $RGRG_METEOR_JAR)")
        if shutil.which("java") is None:
            raise FileNotFoundError("no `java` on PATH for meteor jar")
        self._proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", self.jar, "-", "-", "-stdio",
             "-l", "en", "-norm"],
            cwd=os.path.dirname(os.path.abspath(self.jar)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1)

    @classmethod
    def maybe(cls, jar_path: Optional[str] = None) -> Optional["MeteorJar"]:
        try:
            return cls(jar_path)
        except (FileNotFoundError, OSError):
            return None

    @staticmethod
    def _as_text(seg) -> str:
        text = seg if isinstance(seg, str) else " ".join(seg)
        return text.replace("|||", "").replace("  ", " ").strip()

    def _stat(self, cand: str, refs: List[str]) -> str:
        line = " ||| ".join(("SCORE", " ||| ".join(refs), cand))
        self._proc.stdin.write(line + "\n")
        self._proc.stdin.flush()
        return self._proc.stdout.readline().strip()

    def corpus(self, candidates, references) -> float:
        """Same interface as Meteor.corpus: token-list (or string) segments;
        returns the jar's corpus-level final score."""
        if not candidates:
            return 0.0
        stats = [self._stat(self._as_text(c), [self._as_text(r) for r in refs])
                 for c, refs in zip(candidates, references)]
        self._proc.stdin.write("EVAL ||| " + " ||| ".join(stats) + "\n")
        self._proc.stdin.flush()
        for _ in candidates:                       # per-segment scores
            self._proc.stdout.readline()
        return float(self._proc.stdout.readline().strip())

    def close(self):
        if getattr(self, "_proc", None) and self._proc.poll() is None:
            self._proc.stdin.close()
            self._proc.wait(timeout=10)

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Reference-compatible front end
# ---------------------------------------------------------------------------

def compute_nlg_scores(metrics: Sequence[str], generated: Sequence[str],
                       reference: Sequence[str],
                       cider_df: Optional[Mapping[tuple, int]] = None,
                       cider_log_n: Optional[float] = None) -> Dict[str, float]:
    """Mirror of reference compute_NLG_scores (evaluate_language_model.py:67):
    same text munging, same metric keys (bleu_1..4, meteor, rouge, cider)."""
    cands = [pycoco_tokenize(t) for t in generated]
    refs = [[pycoco_tokenize(t)] for t in reference]
    out: Dict[str, float] = {}
    if "bleu" in metrics:
        b = corpus_bleu(cands, refs)
        for i, v in enumerate(b, 1):
            out[f"bleu_{i}"] = v
    if "meteor" in metrics:
        # jar-backed when $RGRG_METEOR_JAR + a JVM exist (bit-identical to
        # the reference's pycocoevalcap scorer); pure-Python otherwise
        jar = MeteorJar.maybe()
        out["meteor"] = (jar or Meteor()).corpus(cands, refs)
        if jar:
            jar.close()
    if "rouge" in metrics:
        out["rouge"] = rouge_l(cands, refs)
    if "cider" in metrics:
        out["cider"] = cider_d(cands, refs, cider_df, cider_log_n)
    return out
