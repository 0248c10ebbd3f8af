"""The port's soft-dedup default (eval/bertscore.py, eval/chexbert.py's
encoder, text/wordpiece.py) against the JAX package, on the CPU.

Weights: random HF DistilBertModels (transformers, tests only), converted
by each package's own `convert_distilbert`. The encoder and F1 run in f32
in both (JAX at Precision.HIGHEST); they differ only in summation order, so
hidden states and F1 agree within 1e-5. The default-generator test writes a
distilbert of the default scorer's widths (768 wide, 12 heads, 5 layers,
narrow FFN and vocab) to a temporary $RGRG_DISTILBERT_DIR, builds
`ReportGenerator` with its defaults in both packages over the pipeline
tests' margin-checked model and images, and runs both generate_reports.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from transformers import DistilBertConfig as HFDistilBertConfig
from transformers import DistilBertModel

from rgrg_tpu.eval import bertscore as jbs
from rgrg_tpu.eval.chexbert import BertConfig as JBertConfig
from rgrg_tpu.eval.chexbert import bert_encode as j_bert_encode
from rgrg_tpu.inference import ReportGenerator as JReportGenerator
from rgrg_tpu.text.report import assemble_report as j_assemble
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer
from rgrg_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from rgrg_tpu.text.wordpiece import basic_tokenize as j_basic_tokenize

from rgrg_tpu_torch.eval import bertscore as bs
from rgrg_tpu_torch.eval.chexbert import BertConfig, bert_encode
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.text.report import assemble_report, remove_duplicate_sentences
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
from rgrg_tpu_torch.text.wordpiece import WordPieceTokenizer, basic_tokenize

from tests.test_torch_pipeline import MAX_LEN as PIPELINE_MAX_LEN
from tests.test_torch_pipeline import setup  # noqa: F401 (the margin-checked model fixture)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "lung", "lungs", "are",
         "is", "clear", "no", "pleural", "effusion", "seen", "heart", "size",
         "normal", "within", "limits", "of", ".", ",", "cardiac", "silhouette",
         "stable", "acute", "process", "there", "##s", "##al", "un", "##remarkable"]
SENTS = ["The lungs are clear.", "No pleural effusion seen.", "Heart size is normal.",
         "The cardiac silhouette is stable.", "There is no acute process.",
         "Heart size is within normal limits.", "Lungs unremarkable, no effusion."]
F1_TOL = 1e-5


def hf_model(seed, **kw):
    cfg = dict(vocab_size=len(VOCAB), dim=32, n_layers=3, n_heads=4, hidden_dim=64,
               max_position_embeddings=48, dropout=0.0, attention_dropout=0.0)
    cfg.update(kw)
    torch.manual_seed(seed)
    return DistilBertModel(HFDistilBertConfig(**cfg)).eval()


def small_cfgs():
    kw = dict(vocab_size=len(VOCAB), hidden=32, layers=3, heads=4, intermediate=64,
              max_positions=48)
    return JBertConfig(**kw), BertConfig(**kw)


def state_dict(hf):
    return {k: v.detach().clone() for k, v in hf.state_dict().items()}


def scorers(seed, layer=2):
    """(JAX scorer, port scorer on the CPU) over one random distilbert."""
    sd = state_dict(hf_model(seed))
    jcfg, tcfg = small_cfgs()
    vocab = {w: i for i, w in enumerate(VOCAB)}
    jsc = jbs.BERTScorer(jbs.convert_distilbert({k: v.numpy() for k, v in sd.items()}),
                         JWordPiece(vocab), cfg=jcfg, layer=layer)
    tsc = bs.BERTScorer(bs.convert_distilbert(sd), WordPieceTokenizer(vocab), cfg=tcfg,
                        layer=layer, device="cpu")
    return jsc, tsc


def write_model_dir(path, hf, safetensors=False):
    path.mkdir(parents=True, exist_ok=True)
    if safetensors:
        from safetensors.torch import save_file
        save_file(state_dict(hf), str(path / "model.safetensors"))
    else:
        torch.save(hf.state_dict(), str(path / "pytorch_model.bin"))
    (path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return path


@pytest.mark.parametrize("lowercase", [True, False])
def test_wordpiece_matches_jax(lowercase):
    vocab = {w: i for i, w in enumerate(VOCAB + ["Lungs", "The", "é"])}
    jt, tt = JWordPiece(vocab, lowercase=lowercase), WordPieceTokenizer(vocab, lowercase=lowercase)
    texts = SENTS + ["Lungs  unremarkable\t(no effusion)!", "Éffusion naïve 肺 x\u200b y",
                     "", "x" * 120, " ".join(["lungs"] * 600), "heartsal lungal,unclear"]
    for text in texts:
        assert basic_tokenize(text, lowercase) == j_basic_tokenize(text, lowercase)
        assert tt.tokenize(text) == jt.tokenize(text)
        for max_len in (512, 8):
            assert tt.encode(text, max_len) == jt.encode(text, max_len)
    assert tt.encode_batch(texts[:4], 16) == jt.encode_batch(texts[:4], 16)


def test_encoder_matches_jax():
    sd = state_dict(hf_model(0))
    jcfg, tcfg = small_cfgs()
    jp = jbs.convert_distilbert({k: v.numpy() for k, v in sd.items()})
    tp = bs.convert_distilbert(sd)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, len(VOCAB), (3, 13)).astype(np.int32)
    mask = np.ones((3, 13), np.float32)
    mask[1, 7:] = 0
    mask[2, 2:] = 0
    want = np.asarray(j_bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                    precision=jax.lax.Precision.HIGHEST))
    got = bert_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # and the scorer's normalised layer-2 embedding
    want = np.asarray(jbs._embed(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg, 2))
    got = bs._embed(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_scorer_f1_matches_jax(layer):
    jsc, tsc = scorers(seed=layer, layer=layer)
    pairs = [(a, b) for i, a in enumerate(SENTS) for b in SENTS[i + 1:]]
    pairs += [(SENTS[0], SENTS[0]), ("The lungs are clear .", "the lungs are clear.")]
    got, want = tsc(pairs), jsc(pairs)
    assert len(got) == len(want) == len(pairs)
    np.testing.assert_allclose(got, want, rtol=0, atol=F1_TOL)
    assert got[-1] > 0.999 and got[-2] > 0.999
    assert tsc([]) == []


def test_pair_f1_empty_weight_is_zero():
    _, tsc = scorers(seed=3, layer=1)
    emb, weight = tsc.embed([".", ""])
    f1 = bs._pair_f1(emb, weight * 0.0, torch.tensor([0]), torch.tensor([1]))
    assert bool(torch.isfinite(f1).all()) and float(f1[0]) == 0.0


def test_soft_dedup_drops_shorter_as_jax():
    jsc, tsc = scorers(seed=2, layer=2)
    long, short = "The lungs are clear .", "The lungs are clear."
    sents = [long, "No pleural effusion seen.", short, "Heart size is normal."]
    kept = remove_duplicate_sentences(sents, similarity_fn=tsc)
    assert short not in kept and long in kept
    assert assemble_report(sents, tsc) == j_assemble(sents, jsc)
    assert short not in assemble_report(sents, tsc)


def test_default_scorer_env(tmp_path, monkeypatch):
    monkeypatch.delenv("RGRG_DISTILBERT_DIR", raising=False)
    assert bs.default_scorer(device="cpu", _cache=False) is None
    monkeypatch.setenv("RGRG_DISTILBERT_DIR", str(tmp_path / "missing"))
    assert bs.default_scorer(device="cpu", _cache=False) is None

    d = write_model_dir(tmp_path / "db", hf_model(5))
    monkeypatch.setenv("RGRG_DISTILBERT_DIR", str(d))
    jcfg, tcfg = small_cfgs()
    tsc = bs.default_scorer(cfg=tcfg, layer=2, device="cpu", _cache=False)
    jsc = jbs.default_scorer(cfg=jcfg, layer=2, _cache=False)
    assert tsc is not None and tsc.device == torch.device("cpu")
    pairs = [(SENTS[0], SENTS[1]), (SENTS[2], SENTS[5])]
    np.testing.assert_allclose(tsc(pairs), jsc(pairs), rtol=0, atol=F1_TOL)
    # cached per (directory, layer, config, device)
    bs._DEFAULT_SCORER_CACHE.clear()
    try:
        first = bs.default_scorer(cfg=tcfg, layer=2, device="cpu")
        assert bs.default_scorer(cfg=tcfg, layer=2, device="cpu") is first
        assert bs.default_scorer(cfg=tcfg, layer=1, device="cpu") is not first
    finally:
        bs._DEFAULT_SCORER_CACHE.clear()


def test_safetensors_weights_equal_bin(tmp_path):
    pytest.importorskip("safetensors")
    hf = hf_model(6)
    _, tcfg = small_cfgs()
    a = bs.load_bertscorer(str(write_model_dir(tmp_path / "bin", hf)), cfg=tcfg, layer=2,
                           device="cpu")
    b = bs.load_bertscorer(str(write_model_dir(tmp_path / "st", hf, safetensors=True)),
                           cfg=tcfg, layer=2, device="cpu")
    pairs = [(SENTS[0], SENTS[3]), (SENTS[1], SENTS[6])]
    assert a(pairs) == b(pairs)
    with pytest.raises(FileNotFoundError):
        bs.load_bertscorer(str(tmp_path), device="cpu")


class NearDuplicateTokenizer:
    """Stands in for the GPT-2 tokenizer in both packages: records the ids
    of every region sentence it decodes and names the i-th one NEAR[i % 4],
    so every report with two or more regions holds a near-duplicate pair
    (the first two) that only soft dedup removes."""

    NEAR = ["The lungs are clear .", "The lungs are clear.", "No pleural effusion seen.",
            "Heart size is normal."]

    def __init__(self):
        self.seen = []

    def decode(self, ids, skip_special_tokens=True):
        self.seen.append([int(t) for t in ids])
        return self.NEAR[(len(self.seen) - 1) % len(self.NEAR)]


def test_default_report_generators_soft_dedup_identical(setup, tmp_path, monkeypatch):
    """Both packages' ReportGenerator with its defaults finds the scorer
    through $RGRG_DISTILBERT_DIR. Assembled through each generator's own
    scorer, a report with a near-duplicate pair comes out identical, the
    shorter sentence dropped. Both packages' generate_reports, on the
    pipeline tests' margin-checked images, give identical reports and
    region sentences; with a tokenizer that turns the decoded regions into
    near-duplicates, identical again, the ids decoded are equal and soft
    dedup drops a sentence that exact dedup keeps."""
    d = write_model_dir(tmp_path / "distilbert", hf_model(
        7, dim=768, n_heads=12, n_layers=bs.BERTSCORE_LAYER, hidden_dim=64,
        max_position_embeddings=64))
    monkeypatch.setenv("RGRG_DISTILBERT_DIR", str(d))
    monkeypatch.setattr(bs, "_DEFAULT_SCORER_CACHE", {})
    monkeypatch.setattr(jbs, "_DEFAULT_SCORER_CACHE", {})
    jgen = JReportGenerator(setup["jp"], JTokenizer.dummy(), cfg=setup["jcfg"])
    tgen = ReportGenerator(setup["tp"], GPT2Tokenizer.dummy(), cfg=setup["tcfg"])
    assert isinstance(jgen.similarity_fn, jbs.BERTScorer)
    assert isinstance(tgen.similarity_fn, bs.BERTScorer)
    assert tgen.similarity_fn.device == tgen.device
    assert dataclasses.asdict(tgen.similarity_fn.cfg) == dataclasses.asdict(
        jgen.similarity_fn.cfg)

    long, short = NearDuplicateTokenizer.NEAR[:2]
    regions = [long, "No pleural effusion seen.", short, "Heart size is normal."]
    got = assemble_report(regions, tgen.similarity_fn, tgen.threshold)
    want = j_assemble(regions, jgen.similarity_fn, jgen.threshold)
    assert got == want == "The lungs are clear . No pleural effusion seen. Heart size is normal."
    assert short in assemble_report(regions)

    def same_reports(got, want):
        assert len(got) == len(want) == len(setup["images"])
        for g, w in zip(got, want):
            assert g.report == w.report
            assert g.region_sentences == w.region_sentences
            np.testing.assert_array_equal(g.selected_regions, np.asarray(w.selected_regions))

    kw = dict(num_beams=1, max_length=PIPELINE_MAX_LEN)
    plain = tgen.generate_reports(setup["images"], **kw)
    same_reports(plain, jgen.generate_reports(setup["images"], **kw))
    assert any(r.region_sentences for r in plain)

    jtok, ttok = NearDuplicateTokenizer(), NearDuplicateTokenizer()
    jgen.tokenizer, tgen.tokenizer = jtok, ttok
    got = tgen.generate_reports(setup["images"], **kw)
    same_reports(got, jgen.generate_reports(setup["images"], **kw))
    assert ttok.seen == jtok.seen and ttok.seen
    dropped = [r for r in got
               if r.report != assemble_report(list(r.region_sentences.values()))]
    assert dropped and all(short not in r.report for r in dropped)
