"""The port's BPE encoder and report assembly against the JAX package.

`encode` (its `regex`-free pre-tokenizer and the BPE merges) must give the
JAX tokenizer's ids, which come from `regex` in Python and, where
native/bpe.cc is built, from its C++ encoder for ASCII text; both JAX paths
are compared (the C++ one built here with g++ into a temp dir). Inputs:
hypothesis text over a mixed alphabet, fully random text and hand cases
(`___`, `_x`, digits, `²`, `Ⅻ`, non-ASCII letters, runs of spaces and
newlines, contractions), on a synthesized GPT-2-style vocab with merges
and on the dummy tokenizer.
"""

import json
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import regex
from hypothesis import given, settings, strategies as st

import rgrg_tpu.text.native_bpe as jnative
from rgrg_tpu.text.report import assemble_report as j_assemble
from rgrg_tpu.text.report import remove_duplicate_sentences as j_dedup
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.text.report import assemble_report, remove_duplicate_sentences
from rgrg_tpu_torch.text.tokenizer import (ENDOFTEXT, GPT2Tokenizer, _bytes_to_unicode,
                                           pretokenize)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GPT2_PATTERN = regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
HAND_CASES = [
    "", " ", "   ", "\n", "\n\n", " \n ", "a", "The heart is normal.",
    "___", "_x", "x_", "a___b", " ___ ", "Dr. ___ was notified at ___ on ___.",
    "12", "1.5 cm", "T12-L1", " 2,300 ", "x²", "² Ⅻ ½ ①", "mm³",
    "naïve café röntgen São Paulo", "Ärzte", "İstanbul", "日本語のテキスト",
    "é", "it's 'll 've n't mixed!?", "I'M YOU'RE", "'s's'", "''s",
    "a  b", "a   b", "a\t\tb", "a \n b", "a\n\nb", "end   ", "  start", " nbsp x",
    "　ideographic", "tab\tsep\x0bvt", "(left) [right] {x}", "--->", "...",
]
MIXED_ALPHABET = list("ab Zé1²Ⅻ_ '\t\n.,;-()xsdmltvre") + ["'s", "'ll", "  ", "___", " "]
# merges that build common pieces, GPT-2 style ("Ġ" is the space byte)
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("Ġ", "."), ("e", "r"),
          ("a", "r"), ("Ġ", "a"), ("_", "_"), ("__", "_"), ("Ġ", "_"), ("1", "2"),
          ("he", "ar"), ("hear", "t"), ("Ġ", "heart"), ("i", "n"), ("Ġ", "n"), ("o", "r")]


def vocab_dir(path):
    encoder = {t: i for i, t in enumerate(sorted(set(_bytes_to_unicode().values())))}
    for a, b in MERGES:
        encoder.setdefault(a + b, len(encoder))
    encoder[ENDOFTEXT] = len(encoder)
    (path / "vocab.json").write_text(json.dumps(encoder), encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES), encoding="utf-8")
    return path


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """native/bpe.cc built as the repository's Makefile builds it."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build native/bpe.cc")
    path = tmp_path_factory.mktemp("native") / "librgrg_host.so"
    subprocess.run([cxx, "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
                    "-pthread", "-o", str(path), str(ROOT / "native" / "bpe.cc"),
                    str(ROOT / "native" / "preprocess.cc")], check=True)
    return str(path)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory, native_lib):
    """(port, JAX on its Python path, JAX on its C++ path) over one vocab."""
    d = vocab_dir(tmp_path_factory.mktemp("vocab"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB_PATHS", [native_lib])
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_lib_tried", False)
    j_native = JTokenizer.from_dir(str(d))
    j_native.encode("warm up")  # builds its C++ encoder while the path is set
    mp.undo()
    assert j_native._native is not None, "JAX's C++ encoder did not load"
    j_python = JTokenizer.from_dir(str(d))
    j_python._native_tried = True  # pin the Python path
    return GPT2Tokenizer.from_dir(str(d)), j_python, j_native


def check_encode(tokenizers, text):
    port, j_python, j_native = tokenizers
    got = port.encode(text)
    assert got == j_python.encode(text), repr(text)
    assert got == j_native.encode(text), repr(text)
    assert port.encode(text, add_special=True) == j_python.encode(text, add_special=True)


@pytest.mark.parametrize("text", HAND_CASES)
def test_pretokenize_matches_regex_hand_cases(text):
    assert pretokenize(text) == GPT2_PATTERN.findall(text)


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.lists(st.sampled_from(MIXED_ALPHABET), max_size=24).map("".join))
def test_pretokenize_matches_regex_mixed(text):
    assert pretokenize(text) == GPT2_PATTERN.findall(text)


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.text(alphabet=st.characters(exclude_categories=("Cs", "Cn")), max_size=24))
def test_pretokenize_matches_regex_any_text(text):
    """Any assigned character: letters and numbers of every script, marks,
    symbols, every whitespace and control character."""
    assert pretokenize(text) == GPT2_PATTERN.findall(text)


def test_encode_identical_to_jax_hand_cases(tokenizers):
    for text in HAND_CASES:
        check_encode(tokenizers, text)
    # the C++ path took the ASCII cases (so both JAX paths were compared)
    assert tokenizers[2]._native.encode_ascii("___ x") is not None


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(st.sampled_from(MIXED_ALPHABET + ["the heart", "12", "__"]),
                max_size=20).map("".join))
def test_encode_identical_to_jax_fuzz(tokenizers, text):
    check_encode(tokenizers, text)


def test_encode_random_ascii_identical_to_jax(tokenizers):
    rng = np.random.default_rng(0)
    alpha = np.array(list("heart l._'!?,;()0123 \t\nTHE_sdmv"))
    for _ in range(300):
        check_encode(tokenizers, "".join(rng.choice(alpha, rng.integers(0, 60))))


def test_dummy_and_batch_helpers_identical_to_jax():
    port, jax_tok = GPT2Tokenizer.dummy(["lungs"]), JTokenizer.dummy(["lungs"])
    assert port.encoder == jax_tok.encoder and port.vocab_size == jax_tok.vocab_size
    texts = ["The heart is normal.", "", "x² ___ naïve", "a  b\n"]
    seqs = [port.encode(t, add_special=True) for t in texts]
    assert seqs == [jax_tok.encode(t, add_special=True) for t in texts]
    for max_len in (None, 3, 40):
        assert port.pad_batch(seqs, max_len) == jax_tok.pad_batch(seqs, max_len)
    assert port.pad_batch([]) == jax_tok.pad_batch([])
    assert port.batch_decode(seqs) == jax_tok.batch_decode(seqs)
    assert port.batch_decode(seqs, False, False) == jax_tok.batch_decode(seqs, False, False)


def _word_overlap(pairs):
    """A deterministic similarity: word-set Jaccard of each pair."""
    out = []
    for a, b in pairs:
        sa, sb = set(a.lower().split()), set(b.lower().split())
        out.append(len(sa & sb) / max(len(sa | sb), 1))
    return out


@pytest.mark.parametrize("threshold", [0.3, 0.6, 0.9])
def test_return_removed_identical_to_jax(threshold):
    sents = ["The lungs are clear.", "The lungs are clear bilaterally.",
             "No pleural effusion.", "No pleural effusion is seen.",
             "Heart size is normal.", "", "The lungs are clear.", "Heart size normal."]
    for sim in (None, _word_overlap):
        want = j_assemble(sents, sim, threshold, return_removed=True)
        assert assemble_report(sents, sim, threshold, return_removed=True) == want
        assert assemble_report(sents, sim, threshold) == want[0]
        split = [s for s in sents if s]
        assert (remove_duplicate_sentences(split, sim, threshold, return_removed=True)
                == j_dedup(split, sim, threshold, return_removed=True))
    removed = assemble_report(sents, _word_overlap, 0.3, return_removed=True)[1]
    assert removed  # the soft dedup removed something
