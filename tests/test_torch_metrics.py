"""The port's evaluation metrics and artifacts against the JAX package, on
numpy-seeded inputs: NLG (BLEU, METEOR on the port's own stemmer, ROUGE-L,
CIDEr-D with the corpus df and a custom df, compute_nlg_scores) within
1e-12; CheXbert (convert_chexbert + chexbert_label on a random small
BERT-shaped state dict: logits within 1e-5, labels identical; CE scores
and miura_convert on random label arrays, equal); the CIDEr df file; and
write_final_scores / write_sentences_txt / write_reports_txt, byte for
byte from the same scores and collector.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.data.stats import compute_cider_doc_frequencies
from rgrg_tpu.eval import artifacts as ja
from rgrg_tpu.eval import chexbert as jcx
from rgrg_tpu.eval import nlg as jn
from rgrg_tpu.eval.evaluator import SentenceCollector as JCollector

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.data.stats import load_cider_doc_frequencies
from rgrg_tpu_torch.eval import artifacts as ta
from rgrg_tpu_torch.eval import chexbert as tcx
from rgrg_tpu_torch.eval import nlg as tn
from rgrg_tpu_torch.eval.evaluator import SentenceCollector

from tests.test_torch_evaluator import lift_per_condition, word_tokenizers
from tests.torch_parity import WORDS

TOL = dict(rtol=0, atol=1e-12)


def random_sentences(rng, n, lo=0, hi=14):
    """Report-like sentences over WORDS, some empty, some with '.'."""
    out = []
    for _ in range(n):
        words = [WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(lo, hi))]
        text = " ".join(words)
        if rng.uniform() < 0.7:
            text = text[:1].upper() + text[1:] + "."
        out.append(text)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nlg_scores_match_jax(seed):
    rng = np.random.default_rng(seed)
    gen, ref = random_sentences(rng, 40), random_sentences(rng, 40, lo=1)
    metrics = ("bleu", "meteor", "rouge", "cider")
    want = jn.compute_nlg_scores(metrics, gen, ref)
    got = tn.compute_nlg_scores(metrics, gen, ref)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert want["meteor"] > 0 and want["bleu_1"] > 0

    cands = [tn.pycoco_tokenize(t) for t in gen]
    refs = [[tn.pycoco_tokenize(t), tn.pycoco_tokenize(s)] for t, s in
            zip(ref, random_sentences(rng, 40, lo=1))]
    assert cands == [jn.pycoco_tokenize(t) for t in gen]
    np.testing.assert_allclose(tn.rouge_l(cands, refs), jn.rouge_l(cands, refs), **TOL)
    np.testing.assert_allclose(tn.corpus_bleu(cands, refs), jn.corpus_bleu(cands, refs),
                               **TOL)
    # CIDEr-D with a df from another corpus (the reference's val-set df)
    df, log_n = jn.compute_doc_frequencies(
        [[tn.pycoco_tokenize(t)] for t in random_sentences(rng, 60, lo=1)])
    assert tn.compute_doc_frequencies(
        [[tn.pycoco_tokenize(t)] for t in ref]) == jn.compute_doc_frequencies(
        [[jn.pycoco_tokenize(t)] for t in ref])
    np.testing.assert_allclose(tn.cider_d(cands, refs, df, log_n),
                               jn.cider_d(cands, refs, df, log_n), **TOL)
    np.testing.assert_allclose(tn.cider_d(cands, refs), jn.cider_d(cands, refs), **TOL)
    tm, jm = tn.Meteor(), jn.Meteor()
    for c, r in zip(cands, refs):
        np.testing.assert_allclose(tm.score_pair(c, r[0]), jm.score_pair(c, r[0]), **TOL)
    np.testing.assert_allclose(tm.corpus(cands, refs), jm.corpus(cands, refs), **TOL)


def test_meteor_stem_stage_matches_jax():
    """Candidates that match their references only through stems."""
    cands = [s.split() for s in ("effusions are decreasing in size",
                                 "the lungs appeared hyperinflated", "nodular opacities")]
    refs = [[s.split()] for s in ("effusion decreased in sizes",
                                  "lung appears hyperinflation", "opacity nodule")]
    got, want = tn.Meteor().corpus(cands, refs), jn.Meteor().corpus(cands, refs)
    np.testing.assert_allclose(got, want, **TOL)
    assert want > 0.2


def test_cider_df_file_loads(tmp_path):
    path = str(tmp_path / "df.bin.gz")
    df, log_n = compute_cider_doc_frequencies(["The heart is normal.", "No effusion."], path)
    assert load_cider_doc_frequencies(path) == (df, log_n)


# ----------------------------------------------------------------- CheXbert

def chexbert_state_dict(rng, vocab=60, hidden=32, layers=2, inter=64, positions=40,
                        prefix="module."):
    def w(*shape, std=0.2):
        return rng.normal(0, std, shape).astype(np.float32)

    e = f"{prefix}bert.embeddings"
    sd = {f"{e}.word_embeddings.weight": w(vocab, hidden),
          f"{e}.position_embeddings.weight": w(positions, hidden),
          f"{e}.token_type_embeddings.weight": w(2, hidden),
          f"{e}.LayerNorm.weight": 1 + w(hidden, std=0.1),
          f"{e}.LayerNorm.bias": w(hidden, std=0.1)}
    for i in range(layers):
        p = f"{prefix}bert.encoder.layer.{i}"
        for name, (o, n) in (("attention.self.query", (hidden, hidden)),
                             ("attention.self.key", (hidden, hidden)),
                             ("attention.self.value", (hidden, hidden)),
                             ("attention.output.dense", (hidden, hidden)),
                             ("intermediate.dense", (inter, hidden)),
                             ("output.dense", (hidden, inter))):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = w(o, n), w(o, std=0.1)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + w(hidden, std=0.1), w(hidden)
    for j in range(14):
        n = 2 if j == 13 else 4
        sd[f"{prefix}linear_heads.{j}.weight"] = w(n, hidden, std=1.0)
        sd[f"{prefix}linear_heads.{j}.bias"] = w(n, std=0.5)
    return sd


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_chexbert_labels_identical_to_jax(prefix):
    cfg_kw = dict(vocab_size=60, hidden=32, layers=2, heads=4, intermediate=64,
                  max_positions=40)
    rng = np.random.default_rng(5)
    sd = chexbert_state_dict(rng, prefix=prefix)
    ids = rng.integers(4, 60, (6, 17)).astype(np.int64)
    ids[:, 0] = 2
    mask = np.ones((6, 17), np.int64)
    for i, n in enumerate((17, 12, 9, 3, 17, 5)):
        mask[i, n:] = 0
        ids[i, n:] = 0
    jparams = jax.tree.map(jnp.asarray, jcx.convert_chexbert(sd))
    want_logits = jcx.chexbert_logits(jparams, jnp.asarray(ids.astype(np.int32)),
                                      jnp.asarray(mask.astype(np.float32)),
                                      jcx.BertConfig(**cfg_kw))
    want = jcx.chexbert_label(jparams, jnp.asarray(ids.astype(np.int32)),
                              jnp.asarray(mask.astype(np.float32)), jcx.BertConfig(**cfg_kw))
    tparams = tcx.convert_chexbert({k: torch.from_numpy(v) for k, v in sd.items()},
                                   device="cpu")
    cfg = tcx.BertConfig(**cfg_kw)
    got_logits = tcx.chexbert_logits(tparams, torch.from_numpy(ids),
                                     torch.from_numpy(mask.astype(np.float32)), cfg)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        top2 = np.sort(np.asarray(w), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4  # argmax has a margin
    got = tcx.chexbert_label(tparams, ids, mask, cfg)
    assert got.shape == (14, 6) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1
    # numpy state dicts convert to the same parameters
    np_params = tcx.convert_chexbert(sd, device="cpu")
    np.testing.assert_array_equal(tcx.chexbert_label(np_params, ids, mask, cfg), want)


def test_convert_chexbert_defaults_to_the_card():
    """convert_chexbert without a device puts the labeler on cuda, as every
    other entry point of the port does; without a card it raises."""
    sd = chexbert_state_dict(np.random.default_rng(0), layers=1)
    if torch.cuda.is_available():
        assert tcx.convert_chexbert(sd)["heads"][0]["bias"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcx.convert_chexbert(sd)


def test_evaluate_cli_labeler_identical_to_jax(tmp_path):
    """rgrg_tpu_torch/evaluate.chexbert_labeler (WordPiece encode + labels
    of converted parameters) on report texts gives the JAX package's labels
    of the same texts through its own WordPiece tokenizer."""
    from rgrg_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
    from rgrg_tpu_torch.evaluate import chexbert_labeler

    cfg_kw = dict(vocab_size=60, hidden=32, layers=2, heads=4, intermediate=64,
                  max_positions=40)
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + sorted({w.lower() for w in WORDS}))
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    rng = np.random.default_rng(7)
    reports = [" ".join(random_sentences(rng, int(rng.integers(1, 4)), lo=1, hi=6))
               for _ in range(12)] + ["", "Opacity: right lower lobe, ___ unchanged."]
    sd = chexbert_state_dict(rng)
    jparams = jax.tree.map(jnp.asarray, jcx.convert_chexbert(sd))
    ids, mask = JWordPiece.from_vocab_file(str(path)).encode_batch(reports)
    want = jcx.chexbert_label(jparams, jnp.asarray(np.asarray(ids, np.int32)),
                              jnp.asarray(np.asarray(mask, np.float32)),
                              jcx.BertConfig(**cfg_kw))
    label = chexbert_labeler(tcx.convert_chexbert(sd, device="cpu"), str(path),
                             tcx.BertConfig(**cfg_kw))
    got = label(reports)
    assert got.shape == (14, len(reports))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ce_scores_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    gen, ref = rng.integers(0, 4, (14, 40)), rng.integers(0, 4, (14, 40))
    np.testing.assert_array_equal(tcx.miura_convert(gen), jcx.miura_convert(gen))
    assert tcx.CONDITIONS == jcx.CONDITIONS and tcx.FIVE_CONDITIONS == jcx.FIVE_CONDITIONS
    for g, r in ((gen, ref), (np.zeros_like(gen), np.zeros_like(ref)), (gen, gen)):
        assert tcx.compute_ce_scores(g, r) == jcx.compute_ce_scores(g, r)


# ---------------------------------------------------------------- artifacts

def filled_collectors(seed=0):
    """Both packages' SentenceCollector fed the same decoded batches."""
    rng = np.random.default_rng(seed)
    ttok, jtok = word_tokenizers()
    collectors = (SentenceCollector(), JCollector())
    for _ in range(2):
        b = 3
        # "There w w. There w." rows: sentences that split, repeat and
        # overlap across regions, so both dedups act
        ids = rng.integers(1, len(WORDS) + 1, (b, C.NUM_REGIONS, 9)) % 6 + 1
        ids[..., [0, 8]] = 0
        ids[..., [1, 5]] = WORDS.index("There") + 1
        ids[..., [4, 7]] = WORDS.index(".") + 1
        decoded = rng.uniform(size=(b, C.NUM_REGIONS)) < 0.4
        phrases = [[s if rng.uniform() < 0.6 else "" for s in random_sentences(rng, 29, lo=2)]
                   for _ in range(b)]
        abnormal = rng.uniform(size=(b, C.NUM_REGIONS)) < 0.3
        reports = random_sentences(rng, b, lo=3)
        reports[1] = ""  # no reference report: no report row
        sim = lambda pairs: [float(len(a) % 3 == len(b) % 3) for a, b in pairs]  # noqa: E731
        for col, tok in zip(collectors, (ttok, jtok)):
            col.add_batch(ids, decoded, tok, phrases, abnormal, reports, similarity_fn=sim)
    return collectors


def test_collector_and_text_artifacts_identical_to_jax(tmp_path):
    tcol, jcol = filled_collectors()
    for field in ("gen_sents", "ref_sents", "is_abnormal", "region_ids", "image_ids",
                  "gen_reports", "ref_reports", "report_region_sents", "report_removed"):
        assert getattr(tcol, field) == getattr(jcol, field), field
    assert any(tcol.report_removed)
    got, want = tcol.compute(), jcol.compute()
    assert got == want
    for name, mod, col in (("port", ta, tcol), ("jax", ja, jcol)):
        mod.write_sentences_txt(col, str(tmp_path / name), step=3)
        mod.write_reports_txt(col, str(tmp_path / name), step=3)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.txt"))
    assert len(files) == 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_final_scores_identical_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    tcol, _ = filled_collectors(1)
    scores = {
        "object_detector": {
            "avg_detections_per_image": 28.5, "avg_iou": float(rng.uniform()),
            "per_region_iou": {n: float(rng.uniform()) for n in C.REGION_NAMES},
            "per_region_detection_freq": {n: float(rng.uniform()) for n in C.REGION_NAMES}},
        "region_selection": {s: {"precision": float(rng.uniform()), "recall": 0.5, "f1": 0.25}
                             for s in ("all", "normal", "abnormal")},
        "region_abnormal": {"precision": 0.7, "recall": 0.2, "f1": 0.3},
        **tcol.compute(),
    }
    scores["report"]["CE"] = tcx.compute_ce_scores(rng.integers(0, 4, (14, 9)),
                                                   rng.integers(0, 4, (14, 9)))
    ta.write_final_scores(scores, str(tmp_path / "port.txt"))
    # the JAX writer raises on compute_ce_scores' nested "per_condition"
    # block; with the conditions lifted to the CE level it writes the lines
    # the port writes for the nested block
    with pytest.raises(TypeError):
        ja.write_final_scores(scores, str(tmp_path / "jax.txt"))
    ja.write_final_scores(lift_per_condition(scores), str(tmp_path / "jax.txt"))
    body = (tmp_path / "port.txt").read_bytes()
    assert body == (tmp_path / "jax.txt").read_bytes()
    assert b"report_CE_no_finding_f1:" in body and b"sentence_meteor_right_lung" in body
    # flat selection scores are written under "all", as in the JAX package
    flat = {"region_selection": {"precision": 1.0, "recall": 0.5, "f1": 0.6}}
    ta.write_final_scores(flat, str(tmp_path / "p2.txt"))
    ja.write_final_scores(flat, str(tmp_path / "j2.txt"))
    assert (tmp_path / "p2.txt").read_bytes() == (tmp_path / "j2.txt").read_bytes()
