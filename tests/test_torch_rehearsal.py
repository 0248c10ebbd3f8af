"""The three-stage rehearsal and the proposal-budget check of the port
(rgrg_tpu_torch/tools/{three_stage_rehearsal,validate_proposal_budget}.py)
against the JAX package's scripts, on the CPU.

- The synthetic corpus functions equal the JAX scripts' (`build_corpus_batch`,
  `synth_batch`, loaded from scripts/*.py by file path) array for array,
  bit for bit, and phrase for phrase.
- The budget check against the JAX script's logic on the same weights
  (a shallow detector with 50 test proposals, converted from JAX's init):
  survivor counts, `class_detected` agreement, box deltas (1e-4) and the
  smallest safe budget, the ladder's budget included. The inputs are
  seeded synthetic images whose decisions clear tests/torch_parity.py's
  margins under every budget tested (seeds found once, asserted here). A
  budget at or above the survivors reproduces the unbudgeted detections
  exactly, and `model_with` builds the detector the budgeted config's
  `detect` accepts.
- The protocol: stages 1-3 and the final evaluation on a small model
  (shallow backbone, a 16-wide box head, 32 test proposals, 256 x 256
  inputs), batch 2, 2/1/2 steps, 1 evaluation batch, watched by the
  tool's `watch_handoffs`. Stage 2 begins with stage 1's final
  detector and stage 3 with stage 2's params, bit for bit; every
  stageN/last loads through core/checkpoint.load_params (the rehearsal
  reloads and removes them); the summary's keys are those of
  docs/artifacts/three_stage_rehearsal.json plus the port's additions;
  the default --out is outside docs/.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core import config as JC
from rgrg_tpu.models.full_model import RGRG as JRGRG, ladder_budget as j_ladder_budget
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.models.detector import RegionDetector
from rgrg_tpu_torch.models.full_model import RGRG, ladder_budget
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
from rgrg_tpu_torch.tools import three_stage_rehearsal as rehearsal
from rgrg_tpu_torch.tools import validate_proposal_budget as vpb
from rgrg_tpu_torch.train import trainer

from tests.torch_parity import PARITY_MARGINS, decision_margins

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "docs", "artifacts", "three_stage_rehearsal.json")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes on one
    host's cores, where more threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """scripts/<name>.py as a module, read only; sys.path as it was (the
    script puts a path of its own in front)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w, k
        else:
            w = np.asarray(w)
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert got[k].tobytes() == w.tobytes(), k


# ---------------------------------------------------------------- the synthetic corpus

@pytest.mark.parametrize("with_text", [True, False])
@pytest.mark.parametrize("seed", [0, 10_000])
def test_corpus_batch_identical_to_jax_script(seed, with_text):
    want = jax_script("three_stage_rehearsal").build_corpus_batch(
        np.random.default_rng(seed), 2, JTokenizer.dummy(), with_text=with_text)
    got = rehearsal.build_corpus_batch(np.random.default_rng(seed), 2, GPT2Tokenizer.dummy(),
                                       with_text=with_text)
    assert_same_batch(got, want)
    assert got["attention_mask"].any() and got["region_is_abnormal"].any()


@pytest.mark.parametrize("seed", [0, 12345])
def test_synth_batch_identical_to_jax_script(seed):
    want = jax_script("validate_proposal_budget").synth_batch(np.random.default_rng(seed), 2)
    assert_same_batch(vpb.synth_batch(np.random.default_rng(seed), 2), want)


# ---------------------------------------------------------------- budget logic

CAPACITY = 50
BUDGETS = [32, 16]
# synth_batch(default_rng(seed), 1): the evaluation image (44 survivors)
# clears every margin without and under each budget (the ladder's 48
# included); the ladder image's survivors clear the objectness and NMS
# margins
EVAL_SEED = 58
LADDER_SEED = 6


def budget_configs(budget=None):
    dec = dict(vocab_size=64, hidden_dim=64, num_heads=2, num_layers=2, max_positions=64)
    jcfg = JC.ModelConfig(
        detector=JC.DetectorConfig(
            backbone_stages=(1, 1, 1, 1),
            rpn=JC.RPNConfig(pre_nms_top_n_test=CAPACITY, post_nms_top_n_test=CAPACITY),
            roi=JC.RoIConfig(representation_size=16, inference_proposal_budget=budget)),
        decoder=JC.DecoderConfig(**dec))
    tcfg = TC.ModelConfig(
        detector=TC.DetectorConfig(
            backbone_stages=(1, 1, 1, 1), rpn=TC.RPNConfig(pre_nms_top_n_test=CAPACITY),
            roi=TC.RoIConfig(representation_size=16, inference_proposal_budget=budget)),
        decoder=TC.DecoderConfig(**dec))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def budget_case():
    jcfg, tcfg = budget_configs()
    jp = jax.jit(JRGRG(jcfg).init)(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return dict(jcfg=jcfg, jp=jp, model=RGRG(tcfg), params=params)


def jax_certify(jcfg, jp, budgets, batch, eval_batches, rng, ladder_rng):
    """The JAX script's survivors, ladder, agreement and smallest safe budget
    (scripts/validate_proposal_budget.py main, from `survivors` on), with
    the params passed to the jitted function."""
    synth_batch = jax_script("validate_proposal_budget").synth_batch
    det = JRGRG(jcfg).detector

    @jax.jit
    def survivors(variables, images):
        feats = det.apply(variables, images, method=det.backbone_features, train=False)
        _, keep, _ = det.apply(variables, feats, train=False, method=det.rpn_proposals)
        return jnp.sum(keep, axis=1)

    def detect_with(budget, images):
        dcfg = dataclasses.replace(jcfg.detector, roi=dataclasses.replace(
            jcfg.detector.roi, inference_proposal_budget=budget))
        return JRGRG(cfg=dataclasses.replace(jcfg, detector=dcfg)).detect(jp, images)

    budgets = list(budgets)
    smax = max(int(np.asarray(survivors(jp["detector"], synth_batch(ladder_rng, batch)
                                        ["images"])).max()) for _ in range(eval_batches))
    lb = j_ladder_budget(smax)
    if lb < int(jcfg.detector.rpn.post_nms_top_n_test) and lb not in budgets:
        budgets.append(lb)
    counts, agreements = [], {b: {"boxes": [], "cls": []} for b in budgets}
    for _ in range(eval_batches):
        images = synth_batch(rng, batch)["images"]
        counts.extend(np.asarray(survivors(jp["detector"], images)).tolist())
        ref = detect_with(None, images)
        for b in budgets:
            out = detect_with(b, images)
            agreements[b]["boxes"].append(float(jnp.max(jnp.abs(
                out["top_region_boxes"] - ref["top_region_boxes"]))))
            agreements[b]["cls"].append(bool(jnp.all(
                out["class_detected"] == ref["class_detected"])))
    agreement = {str(b): {"max_box_delta_px": round(max(v["boxes"]), 4),
                          "class_detected_identical": all(v["cls"])}
                 for b, v in agreements.items()}
    safe = [b for b in sorted(budgets) if agreement[str(b)]["class_detected_identical"]
            and agreement[str(b)]["max_box_delta_px"] < 1e-3]
    return {"survivors_max": int(max(counts)), "survivors_mean": round(float(np.mean(counts)), 1),
            "budget_agreement": agreement, "smallest_safe_budget_tested": safe[0] if safe else None}


def test_budget_check_matches_the_jax_script(budget_case):
    c = budget_case
    model, params = c["model"], c["params"]
    image = torch.from_numpy(vpb.synth_batch(np.random.default_rng(EVAL_SEED), 1)["images"])
    ladder_image = torch.from_numpy(
        vpb.synth_batch(np.random.default_rng(LADDER_SEED), 1)["images"])
    got = vpb.certify(model, params, BUDGETS, batch=1, eval_batches=1, ladder=True,
                      rng=np.random.default_rng(EVAL_SEED),
                      ladder_rng=np.random.default_rng(LADDER_SEED))
    tested = [int(b) for b in got["budget_agreement"]]
    assert tested == BUDGETS + [48], "the ladder adds its budget"
    for b in [None] + tested:
        m = decision_margins(vpb.model_with(model, params, b)[1]["detector"], image)
        assert all(m[k] >= v for k, v in PARITY_MARGINS.items()), (b, m)
    m = decision_margins(params["detector"], ladder_image)
    assert m["objectness"] >= PARITY_MARGINS["objectness"] and m["iou"] >= PARITY_MARGINS["iou"]

    want = jax_certify(c["jcfg"], c["jp"], BUDGETS, 1, 1, np.random.default_rng(EVAL_SEED),
                       np.random.default_rng(LADDER_SEED))
    assert got["post_nms_capacity"] == CAPACITY
    assert (got["survivors_max"], got["survivors_mean"]) == (want["survivors_max"],
                                                             want["survivors_mean"])
    assert list(got["budget_agreement"]) == list(want["budget_agreement"])
    for b, w in want["budget_agreement"].items():
        g = got["budget_agreement"][b]
        assert g["class_detected_identical"] == w["class_detected_identical"], b
        assert abs(g["max_box_delta_px"] - w["max_box_delta_px"]) <= 1e-4, b
    assert got["smallest_safe_budget_tested"] == want["smallest_safe_budget_tested"]
    deltas = [v["max_box_delta_px"] for v in got["budget_agreement"].values()]
    assert min(deltas) == 0.0 and max(deltas) > 1.0, "safe and unsafe budgets both tested"


def test_budget_at_or_above_the_survivors_is_exact(budget_case):
    model, params = budget_case["model"], budget_case["params"]
    image = torch.from_numpy(vpb.synth_batch(np.random.default_rng(EVAL_SEED), 1)["images"])
    n = int(vpb.survivors(params["detector"], image).max())
    assert n < CAPACITY
    ref = model.detect(params, image)
    for budget in (n, n + 3):
        budgeted = RGRG(dataclasses.replace(model.cfg, detector=dataclasses.replace(
            model.cfg.detector, roi=dataclasses.replace(model.cfg.detector.roi,
                                                        inference_proposal_budget=budget))))
        with pytest.raises(ValueError, match="DetectorConfig"):
            budgeted.detect(params, image)
        m, p = vpb.model_with(model, params, budget)
        assert m.cfg == budgeted.cfg and p["decoder"] is params["decoder"]
        out = vpb.detect_with(model, params, budget, image)
        for k, v in ref.items():
            assert torch.equal(out[k], v), (budget, k)


def test_budget_keeps_the_top_proposal_where_nms_dropped_it(budget_case, monkeypatch):
    """Where NMS's small-box rule drops the top-ranked proposal, the
    undetected regions still take its box (top_idx 0): a budget above the
    survivors keeps it in slot 0 and gives the unbudgeted detections."""
    model, params = budget_case["model"], budget_case["params"]
    rpn_proposals = RegionDetector.rpn_proposals

    def top_dropped(self, feats):
        boxes, keep = rpn_proposals(self, feats)
        return boxes, keep.index_fill(1, torch.tensor([0]), False)

    monkeypatch.setattr(RegionDetector, "rpn_proposals", top_dropped)
    image = torch.from_numpy(vpb.synth_batch(np.random.default_rng(EVAL_SEED), 1)["images"])
    n = int(vpb.survivors(params["detector"], image).max())
    assert n + 3 < CAPACITY
    ref = model.detect(params, image)
    assert not ref["class_detected"].all(), "a region takes proposal 0's box"
    for budget in (n + 1, n + 3):
        out = vpb.detect_with(model, params, budget, image)
        for k, v in ref.items():
            assert torch.equal(out[k], v), (budget, k)


# ---------------------------------------------------------------- the protocol

def protocol_config():
    """The rehearsal's shallow model with tests/test_torch_train_model's
    small detector: 64 training / 32 test proposals, 32 sampled RoIs, a
    16-wide box head; 256 x 256 inputs (an 8 x 8 anchor grid), where the
    corpus clips its right and bottom regions to slivers."""
    cfg = rehearsal.model_config(GPT2Tokenizer.dummy(), shallow=True, seq_len=12)
    rpn = TC.RPNConfig(pre_nms_top_n_train=64, post_nms_top_n_train=64, pre_nms_top_n_test=32)
    roi = TC.RoIConfig(batch_size_per_image=32, representation_size=16)
    return dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, rpn=rpn, roi=roi, image_size=256, anchors=TC.AnchorConfig(grid_size=8)))


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """One CPU rehearsal, watching the params that enter each stage's first
    mini-step and every checkpoint the rehearsal loads."""
    run_dir = tmp_path_factory.mktemp("rehearsal")
    argv = ["--shallow", "--stage1-steps", "2", "--stage2-steps", "1", "--stage3-steps", "2",
            "--batch", "2", "--eval-batches", "1", "--seq-len", "12",
            "--num-figure-images", "0", "--budgets", "16", "--budget-batch", "1",
            "--budget-eval-batches", "1", "--run-dir", str(run_dir),
            "--out", str(run_dir / "summary.json"),
            "--budget-out", str(run_dir / "budget.json"), "--device", "cpu"]
    with rehearsal.watch_handoffs(str(run_dir)) as seen:
        summary = rehearsal.main(argv, cfg=protocol_config())
    return dict(summary=summary, seen=seen, run_dir=run_dir)


def test_rehearsal_hands_each_stage_the_last_stages_params(protocol):
    seen = protocol["seen"]
    assert seen["entering"] == [1, 2, 3]
    last = [os.path.join(f"stage{n}", "last") for n in (1, 2, 3)]
    # each stage's reload check, then the budget check's load of stage 3
    assert seen["loaded"] == last + last[2:]
    assert seen["stage 2 begins with stage 1's final detector"]
    assert seen["stage 3 begins with stage 2's params"]
    assert seen["stage 3 moved the decoder"]
    assert trainer.make_train_step.__name__ == "make_train_step"
    assert rehearsal.load_params.__name__ == "load_params", "the watch ends with the run"


def test_rehearsal_summary_has_the_jax_artifacts_keys(protocol):
    summary, run_dir = protocol["summary"], protocol["run_dir"]
    with open(ARTIFACT) as f:
        want = json.load(f)
    assert rehearsal.reference_key_paths(summary) == rehearsal.key_paths(want)
    for stage in ("stage1", "stage2", "stage3"):
        losses = summary["stages"][stage]["final_val_losses"]
        assert set(losses) == set(want["stages"][stage]["final_val_losses"])
        assert all(np.isfinite(v) for v in losses.values())
    with open(run_dir / "summary.json") as f:
        assert rehearsal.key_paths(json.load(f)) == rehearsal.key_paths(summary)
    with open(run_dir / "budget.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary["proposal_budget"]))
    lg = summary["final_eval"]["language_generation"]
    assert lg["decoded_rows"] >= lg["rows_closed_before_max_length"] >= 0
    # one batch of 2: the decode's row budget is the ladder's value over its rows, at most 2 x 29
    assert lg["row_budgets"] == [min(ladder_budget(lg["decoded_rows"]), 58)]
    assert sorted(os.listdir(run_dir)) == ["budget.json", "eval_artifacts", "summary.json"]
    default_out = rehearsal.build_parser().parse_args([]).out
    assert not os.path.abspath(default_out).startswith(os.path.join(ROOT, "docs"))
    assert os.path.normpath(default_out).split(os.sep)[0] == "chiprun_out"
