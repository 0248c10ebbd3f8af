"""`python -m rgrg_tpu_torch.train` and the train -> serve -> evaluate loop
on the CPU, at a small size: the shallow (1,1,1,1) ResNet at 512x512, 64
training / 32 test proposals, 32 sampled RoIs, a 16-wide box head and a
2-layer, 16-wide GPT-2 (tests/test_torch_train_model.configs), batches of
2 from split CSVs of 512 x <=512 PNGs (so the augmentations, held against
JAX in tests/test_torch_augment.py, need no resize) with phrases of report
words whose ids fit the decoder's 50-token vocabulary.

- The CLI trains, validates, checkpoints (`last`, `best`), logs
  metrics.jsonl and resumes; warm-starts from a synthetic reference .pt
  (the inverse conversion of tests/test_torch_roundtrip.py), full-model
  or detector-only.
- Its first mini-step's losses, from a full .pt and replaying JAX's
  sampling draws, are within the training tests' tolerances (rtol 1e-4,
  atol 1e-5) of the losses JAX's train.loop.train computes at its first
  mini-step:
  `compute_losses` on its first batch (JAX's RGRGDataset(train=True) at
  the same seed, shuffled) with its first step key and the same weights.
- ReportGenerator.from_checkpoint(<run_dir>/last) serves the trained
  params (the same reports as a generator built on the state's params);
  the evaluate and bbox-variations CLIs take the directory; the three CLIs
  and the rehearsal and proposal-budget tools default to --device cuda and
  raise without a card.
- The reference's behaviour pinned here: JAX's from_orbax hands a
  TrainState checkpoint's whole {"params", "opt_state", "step"} tree to
  the generator, which fails on params["detector"]; JAX's warm start from
  a detector-only .pt replaces the whole detector tree, so its first step
  fails on the missing classifiers (ROADMAP section 3).
"""

import csv
import json
import os
import shutil

import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core import config as JC
from rgrg_tpu.data.dataset import RGRGDataset as JDataset, read_split_csv as j_read
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer
from rgrg_tpu.train import trainer as jtrainer

import rgrg_tpu_torch.evaluate as tevaluate
import rgrg_tpu_torch.evaluate_bbox_variations as tbbox
import rgrg_tpu_torch.train.__main__ as tcli
import rgrg_tpu_torch.tools.three_stage_rehearsal as trehearsal
import rgrg_tpu_torch.tools.validate_proposal_budget as tbudget
from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core.checkpoint import load_params, save_checkpoint
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.train import trainer

from tests.test_ops import random_boxes
from tests.test_torch_roundtrip import build_reference_state_dict
from tests.test_torch_train_model import (LM_BUDGET, SEED, TOL, configs, make_batch,
                                          n_anchors, pool_size)
from tests.test_torch_train_ops import jax_draws
from tests.torch_parity import WORDS

SHAPES = [(512, 448), (470, 512), (512, 512), (512, 401), (433, 512), (512, 487)]
SEQ = 10
STAGES = (1, 1, 1, 1)


def _write_tokenizer(path):
    """vocab.json: EOS, then " word" for each report word and "." (ids
    1..49, inside the decoder's vocabulary), then the byte alphabet;
    merges.txt: the left-to-right merges that build each " word"."""
    from rgrg_tpu_torch.text.tokenizer import ENDOFTEXT, _bytes_to_unicode
    enc, merges = {ENDOFTEXT: 0}, []
    for w in WORDS:
        piece = "." if w == "." else "Ġ" + w
        enc[piece] = len(enc)
        merges += [(piece[:i], piece[i]) for i in range(1, len(piece))
                   if (piece[:i], piece[i]) not in merges]
    for ch in sorted(set(_bytes_to_unicode().values()) - set(enc)):
        enc[ch] = len(enc)
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps(enc), encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
                                     encoding="utf-8")
    return str(path)


def _write_split(path, seed, regions=29):
    """A split csv over PNGs of SHAPES; each row has `regions` of the 29
    regions (29: every image has region 1, which the JAX package's
    training losses need, see test_missing_region_keeps_losses_finite)."""
    rng = np.random.default_rng(seed)
    words = [w for w in WORDS if w != "."]
    rows = []
    for i, (h, w) in enumerate(SHAPES):
        img = path.parent / f"{path.stem}_{i}.png"
        cv2.imwrite(str(img), rng.integers(0, 256, (h, w), dtype=np.uint8))
        labels = sorted(rng.choice(np.arange(1, 30), regions, replace=False).tolist())
        boxes = random_boxes(regions, extent=float(min(h, w)), min_size=24.0, rng=rng).round(1)
        # a leading space: every word is one " word" token
        phrases = ["".join(" " + w for w in rng.choice(words, rng.integers(2, 6))) + "."
                   if rng.uniform() < 0.6 else "" for _ in range(29)]
        rows.append({"mimic_image_file_path": str(img), "bbox_coordinates": str(boxes.tolist()),
                     "bbox_labels": str(labels), "bbox_phrases": str(phrases),
                     "bbox_phrase_exists": str([bool(p) for p in phrases]),
                     "bbox_is_abnormal": str([bool(rng.uniform() < 0.3) for _ in phrases]),
                     "reference_report": " ".join(p for p in phrases if p)})
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    tok = _write_tokenizer(d / "tok")
    jcfg, tcfg = configs(representation_size=16)
    jp = jax.tree.map(np.asarray, jax.jit(lambda r: JRGRG(jcfg).init(r))(jax.random.PRNGKey(0)))
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          build_reference_state_dict(jp, STAGES).items()}
    full, det_only = d / "full.pt", d / "detector.pt"
    torch.save({"model": sd}, full)
    prefix = "module.object_detector."
    torch.save({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, det_only)
    cfg = TC.RGRGConfig(model=tcfg, train=TC.TrainConfig(grad_accumulation_steps=2,
                                                         evaluate_every_k_batches=2))
    yield dict(dir=d, tok=tok, jcfg=jcfg, tcfg=tcfg, cfg=cfg, jp=jp, full=str(full),
               det_only=str(det_only), train_csv=_write_split(d / "train.csv", 0),
               val_csv=_write_split(d / "val.csv", 1, regions=24))
    shutil.rmtree(d, ignore_errors=True)   # training states are ~0.6 GB each


@pytest.fixture(scope="module")
def jax_losses(setup):
    """JAX's compute_losses (train=True, stage 3), jitted once: (params,
    batch, key) -> losses."""
    model = JRGRG(setup["jcfg"])
    fn = jax.jit(lambda p, b, k: jtrainer.compute_losses(model, p, b, k, 3, JC.TrainConfig(),
                                                         LM_BUDGET, train=True)[1])
    return lambda b, k: fn(jax.tree.map(jnp.asarray, setup["jp"]),
                           {n: jnp.asarray(v) for n, v in b.items()
                            if isinstance(v, np.ndarray)}, k)


def _argv(s, run_dir, *extra):
    return ["--stage", "3", "--train-csv", s["train_csv"], "--tokenizer-dir", s["tok"],
            "--run-dir", str(run_dir), "--batch-size", "2", "--seq-len", str(SEQ),
            "--lm-budget", str(LM_BUDGET), "--prefetch", "1", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(setup):
    """The CLI from the full .pt: 2 mini-steps (one update) with a
    validation at step 2, then resumed from `last` to step 3. The first
    mini-step replays JAX's sampling draws of its loop's first step key;
    its losses are recorded."""
    s = setup
    run = s["dir"] / "run"
    rng_det = jax.random.split(jax.random.split(jax.random.PRNGKey(s["cfg"].train.seed + 1))[1])[0]
    draws = jax_draws(rng_det, 2, n_anchors(s["tcfg"]), pool_size(s["tcfg"], True))
    recorded = []
    make_step = trainer.make_train_step

    def replaying(*a, **kw):
        step = make_step(*a, **kw)

        def run_step(state, batch, rng):
            state, losses = step(state, batch, iter(draws) if not recorded else rng)
            recorded.append((batch, losses))
            return state, losses
        return run_step

    trainer.make_train_step = replaying
    try:
        state = tcli.main(_argv(s, run, "--val-csv", s["val_csv"], "--max-steps", "2",
                                "--init-from-torch", s["full"]), cfg=s["cfg"])
        first = recorded[0]
        resumed = tcli.main(_argv(s, s["dir"] / "resumed", "--max-steps", "3", "--resume-from",
                                  str(run / "last")), cfg=s["cfg"])
    finally:
        trainer.make_train_step = make_step
    return dict(run=run, state=state, first=first, resumed=resumed, steps=len(recorded))


def test_train_cli_writes_metrics_checkpoints_and_resumes(trained):
    run = trained["run"]
    assert trained["state"].step == 2 and trained["state"].opt_state.mini_step == 0
    for name in ("last", "best"):
        assert os.path.isfile(run / name / "train_state.pt"), name
    recs = [json.loads(line) for line in open(run / "metrics.jsonl")]
    vals = {k: v for r in recs if r["step"] == 2 for k, v in r.items() if k.startswith("val/")}
    assert [r["step"] for r in recs if "val/loss" in r] == [2]
    assert {"val/loss", "val/loss_lm", "val/loss_objectness", "val/loss_rpn_box_reg"} <= set(vals)
    assert all(np.isfinite(v) for v in vals.values())   # val images lack regions
    # the resumed run started at step 2 and took one mini-step
    assert trained["resumed"].step == 3 and trained["steps"] == 3
    batch = trained["first"][0]
    assert batch["images"].shape == (2, 512, 512, 1) and batch["input_ids"].shape == (2, 29, SEQ)


def test_first_mini_step_losses_match_jax_loop(setup, trained, jax_losses):
    s = setup
    jtok = JTokenizer.from_dir(s["tok"])
    jbatch = next(JDataset(j_read(s["train_csv"]), jtok, train=True, seq_len=SEQ).batches(
        2, shuffle=True))
    batch, losses = trained["first"]
    for k in jbatch:
        if isinstance(jbatch[k], np.ndarray):
            np.testing.assert_allclose(np.asarray(batch[k], np.float64), jbatch[k], rtol=0,
                                       atol=1e-5, err_msg=k)
    step_key = jax.random.split(jax.random.PRNGKey(s["cfg"].train.seed + 1))[1]
    want = jax_losses(jbatch, step_key)
    assert set(losses) == set(want)
    for k in want:
        np.testing.assert_allclose(float(losses[k]), float(want[k]), **TOL, err_msg=k)


def test_missing_region_keeps_losses_finite(setup, jax_losses):
    """An image without region 1 (its slot all zeros, gt_valid False): JAX's
    RPN and RoI box-regression losses are NaN (an unmatched anchor takes gt
    slot 0 and encodes log(0), masked by a product); the port's losses and
    gradients are finite and equal to those of the same batch with any
    box in the empty slot (which no anchor may match)."""
    from rgrg_tpu_torch.core.convert import from_jax_params
    from rgrg_tpu_torch.models.full_model import RGRG
    s = setup
    batch = make_batch(SEED, s=SEQ)
    batch["gt_valid"][1, 0] = False
    batch["gt_boxes"][1, 0] = 0.0
    key = jax.random.PRNGKey(5)
    want = jax_losses(batch, key)
    assert np.isnan(float(want["loss_rpn_box_reg"])) and np.isnan(float(want["loss_box_reg"]))
    filled = dict(batch, gt_boxes=batch["gt_boxes"].copy())
    filled["gt_boxes"][1, 0] = [100.0, 100.0, 200.0, 220.0]
    filled_want = jax_losses(filled, key)
    rng_det = jax.random.split(key)[0]
    draws = jax_draws(rng_det, 2, n_anchors(s["tcfg"]), pool_size(s["tcfg"], True))
    model = RGRG(s["tcfg"])
    params = from_jax_params(s["jp"], s["tcfg"], "cpu")
    tensors = trainer.set_trainable_(params, 3)
    total, losses = trainer.compute_losses(model, params, trainer.batch_to_device(
        batch, torch.device("cpu")), iter(draws), 3, TC.TrainConfig(), LM_BUDGET)
    total.backward()
    for k in want:
        np.testing.assert_allclose(float(losses[k]), float(filled_want[k]), **TOL, err_msg=k)
    assert all(torch.isfinite(t.grad).all() for t in tensors if t.grad is not None)


def test_from_checkpoint_serves_the_trained_params(setup, trained, tmp_path):
    """Reports from <run_dir>/last equal those of a generator on the
    trained state's params; a bare params tree saved and served alike."""
    s = setup
    images = [np.random.default_rng(i).integers(0, 256, (512, 480), dtype=np.uint8)
              for i in range(2)]
    kw = dict(cfg=s["tcfg"], device="cpu", similarity_fn=None)
    gen = ReportGenerator.from_checkpoint(str(trained["run"] / "last"), s["tok"], **kw)
    state = trained["state"]
    state.params["detector"].eval()   # the loop leaves it in train mode
    ref = ReportGenerator(state.params, gen.tokenizer, cfg=s["tcfg"], similarity_fn=None)
    got = gen.generate_reports(images, max_length=8)
    want = ref.generate_reports(images, max_length=8)
    assert [r.report for r in got] == [r.report for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.selected_regions, b.selected_regions)
        np.testing.assert_array_equal(a.top_region_boxes, b.top_region_boxes)
    save_checkpoint(str(tmp_path / "bare"), state.params)
    bare = load_params(str(tmp_path / "bare"), s["tcfg"], "cpu")
    shutil.rmtree(tmp_path / "bare")
    a, b = bare["detector"].state_dict(), state.params["detector"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(x, y) for x, y in zip(trainer.leaves(bare["decoder"]),
                                                 trainer.leaves(state.params["decoder"])))


def test_evaluate_and_bbox_cli_take_the_checkpoint_dir(setup, trained, tmp_path):
    s = setup
    ckpt = str(trained["run"] / "last")
    out = tmp_path / "scores.json"
    tevaluate.main(["--checkpoint", ckpt, "--tokenizer-dir", s["tok"], "--test-csv",
                    s["val_csv"], "--output", str(out), "--batch-size", "2",
                    "--num-beams", "2", "--max-length", "8", "--num-figure-images", "0",
                    "--device", "cpu"], cfg=s["tcfg"])
    scores = json.loads(out.read_text())[s["val_csv"]]
    assert {"object_detector", "language_generation"} <= set(scores)
    assert os.path.isfile(tmp_path / "final_scores_val.txt")
    bbox = tmp_path / "bbox.json"
    res = tbbox.main(["--checkpoint", ckpt, "--tokenizer-dir", s["tok"], "--csv", s["val_csv"],
                      "--stds", "0.0", "0.5", "--batch-size", "2", "--max-length", "8",
                      "--output", str(bbox), "--device", "cpu"], cfg=s["tcfg"])
    written = json.loads(bbox.read_text())
    assert written["mode"] == "position" and set(written["meteor_by_std"]) == {"0.0", "0.5"}
    assert all(0.0 <= v <= 1.0 for v in res.values())


@pytest.mark.parametrize("cli", ["train", "evaluate", "bbox", "rehearsal", "budget"])
def test_clis_default_to_the_card_and_raise_without_one(setup, cli, tmp_path):
    s = setup
    argv = {"train": _argv(s, tmp_path / "run")[:-2],
            "evaluate": ["--checkpoint", s["full"], "--tokenizer-dir", s["tok"],
                         "--test-csv", s["val_csv"]],
            "bbox": ["--checkpoint", s["full"], "--tokenizer-dir", s["tok"],
                     "--csv", s["val_csv"]],
            "rehearsal": ["--shallow", "--run-dir", str(tmp_path / "rehearsal"),
                          "--out", str(tmp_path / "rehearsal.json")],
            "budget": ["--shallow", "--steps", "1"]}[cli]
    module = {"train": tcli, "evaluate": tevaluate, "bbox": tbbox, "rehearsal": trehearsal,
              "budget": tbudget}[cli]
    main, parser = module.main, module.build_parser()
    assert parser.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv, **({} if cli == "budget" else
                      {"cfg": s["cfg"] if cli == "train" else s["tcfg"]}))


def test_init_from_torch_detector_only(setup, tmp_path):
    """A stage-1 (detector-only) .pt: after one mini-step (no update yet at
    accumulation 2) every detector parameter but the two classifiers' is
    the file's, the classifiers keep the fresh init (BatchNorm statistics
    moved in train mode). JAX replaces its whole detector tree with the
    converted one, so the classifiers' parameters are missing and its
    train_forward fails."""
    from rgrg_tpu_torch.core.convert import from_jax_params
    from rgrg_tpu_torch.models.full_model import RGRG
    s = setup
    init = tcli.init_from_torch(s["det_only"], s["tcfg"])
    assert set(init) == {"detector"} and "selection_classifier" not in init["detector"]["params"]
    state = tcli.main(_argv(s, tmp_path / "run", "--max-steps", "1", "--init-from-torch",
                            s["det_only"]), cfg=s["cfg"])
    shutil.rmtree(tmp_path / "run")
    assert state.step == 1 and state.opt_state.mini_step == 1
    got = state.params["detector"].state_dict()
    from_file = from_jax_params(s["jp"], s["tcfg"], "cpu")["detector"].state_dict()
    fresh = RGRG(s["tcfg"]).init(s["cfg"].train.seed, device="cpu")["detector"].state_dict()
    classifiers = ("selection_classifier.", "abnormal_classifier.")
    assert any(n.startswith(classifiers) for n in got)
    for name, t in got.items():
        if "running" not in name:
            want = fresh if name.startswith(classifiers) else from_file
            assert torch.equal(t, want[name]), name
    jparams = {"decoder": s["jp"]["decoder"], "detector": {
        "params": {k: v for k, v in s["jp"]["detector"]["params"].items()
                   if not k.endswith("_classifier")},
        "batch_stats": s["jp"]["detector"]["batch_stats"]}}
    batch = {k: jnp.asarray(v) for k, v in make_batch(0, s=SEQ).items()}
    with pytest.raises(Exception, match="selection_classifier"):
        jax.eval_shape(lambda p: jtrainer.compute_losses(
            JRGRG(s["jcfg"]), p, batch, jax.random.PRNGKey(0), 3, JC.TrainConfig(),
            LM_BUDGET, train=True), jparams)


def test_from_orbax_on_a_train_state_fails_in_jax(setup, tmp_path):
    """JAX's from_orbax restores a TrainState checkpoint as the dict
    {"opt_state", "params", "step"} and hands it to the generator whole:
    generating fails on params["detector"]. The port takes state.params
    (test_from_checkpoint_serves_the_trained_params)."""
    from rgrg_tpu.core.checkpoint import save_checkpoint as j_save
    from rgrg_tpu.inference import ReportGenerator as JReportGenerator
    s = setup
    opt = jtrainer.make_optimizer(s["jp"], JC.TrainConfig(), 3)
    state = jtrainer.TrainState(jax.tree.map(jnp.asarray, s["jp"]), opt.init(s["jp"]),
                                jnp.zeros((), jnp.int32))
    j_save(str(tmp_path / "last"), state)
    gen = JReportGenerator.from_orbax(str(tmp_path / "last"), s["tok"], cfg=s["jcfg"],
                                      similarity_fn=None)
    assert set(gen.params) == {"opt_state", "params", "step"}
    with pytest.raises(KeyError, match="detector"):
        gen.generate_reports([np.zeros((512, 512), np.uint8)], max_length=4)
    shutil.rmtree(tmp_path, ignore_errors=True)
