"""The port's data-parallel mesh (rgrg_tpu_torch/core/mesh.py) on the CPU:
two ranks joined through gloo by core.mesh.launch (spawned processes, a
FileStore rendezvous in a temporary directory), against world 1 (the
same code in this process, where make_mesh() is a mesh of one) and the
JAX package.

One launch runs every rank-side check of the module (tests/
torch_mesh_ranks.py, which imports no JAX):
  - the mesh helpers (make_mesh's limits, shard_pytree_batch,
    replicate_pytree);
  - data-parallel serving as tests/test_mesh_inference.py serves: 5
    images in batches of 4 (the final batch padded), greedy at max_length
    6 and beam 3 at 12 through the length cascade (buckets (4, 12)); the
    JAX side serves on its 2-device mesh. The images are seeds whose
    detector, greedy and beam decisions clear the two libraries' f32
    disagreement (tests/torch_parity.py), asserted here;
  - one stage-3 train step on a global batch of 4 (shallow detector,
    BatchNorm in train mode, JAX's sampling draws replayed) whose inputs
    show the traps of a naive data-parallel port: the LM budget truncates
    the valid rows, the halves hold different numbers of valid tokens, and
    each half's BatchNorm statistics differ from the batch's. The batch is
    a fixed seed whose training decisions clear TRAINING_MARGINS
    (asserted);
  - the backbone's gradient in f64, the draws and the LM's dropout masks;
  - train.loop.train with a resume from `last`;
  - the serve CLI's ranks (`--data-parallel 2`);
  - the train CLI's ranks (`_train_rank`) on a split with an unreadable
    image: with `--workers 2` each rank loads only its rows, agreeing on
    the skip over its gloo group, for two mini-steps; with `--workers 0`
    (world 2 only) every rank builds the global batch and keeps its rows.
World 1 runs in this process while world 2's ranks run: the ranks return
digests, and rank 0 its tensors, which the tests compare with world 1's.
"""

import concurrent.futures as cf
import copy
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core import mesh as jmesh
from rgrg_tpu.core.config import GenerationConfig as JGenerationConfig
from rgrg_tpu.core.config import TrainConfig as JTrainConfig
from rgrg_tpu.inference import ReportGenerator as JReportGenerator
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.serving import generate_reports_pipelined as j_pipelined
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer
from rgrg_tpu.train import trainer as jtrainer

import rgrg_tpu_torch.serve as tserve
from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core import mesh
from rgrg_tpu_torch.core.checkpoint import save_checkpoint
from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.serving import generate_reports_pipelined
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
from rgrg_tpu_torch.train import trainer

from tests import torch_mesh_ranks as ranks
from tests.test_torch_pipeline import SHAPE
from tests.test_torch_rank_loading import write_split, write_tokenizer
from tests.test_torch_train_model import (TOL, configs as train_configs, make_batch,
                                          n_anchors, pool_size)
from tests.test_torch_train_ops import jax_draws
from tests.torch_parity import (TRAINING_MARGINS, beam_score_margin, greedy_logit_margin,
                                has_parity_margins, training_margins)

BUCKETS = (4, 12)
SERVE_SEEDS = (18, 24, 53, 79, 91)   # images default_rng([12, seed]); margins asserted
CASES = {"greedy": dict(num_beams=1, max_length=6), "beam": dict(num_beams=3, max_length=12)}
MIN_GAP = 1e-4
TRAIN_SEED = 14                  # the global batch of 4; margins asserted
LM_BUDGET = 8                    # below the batch's 14 LM-valid rows
CPU = torch.device("cpu")
CLI_SEQ = 10


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the ranks one each, world 1 the rest): the
    suite runs several test processes on one host's cores, where more
    threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """One small model for serving and training: the shallow detector of
    tests/test_torch_train_model.py (box head 16 wide) and its 2-layer
    decoder; serving scales the decoder x8 so that sentences differ and
    end (tests/test_torch_serving.py) and decodes through buckets (4, 12)."""
    jcfg, tcfg = train_configs(representation_size=16)
    jp = jax.tree.map(np.asarray, jax.jit(lambda r: JRGRG(jcfg).init(r))(
        jax.random.PRNGKey(0)))
    tp = from_jax_params(jp, tcfg, "cpu")
    j8 = {"detector": jp["detector"], "decoder": jax.tree.map(lambda a: a * 8.0, jp["decoder"])}
    t8 = {"detector": tp["detector"],   # x8 is exact in f32
          "decoder": trainer.tree_map(lambda _, a: a * 8.0, tp["decoder"])}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, j8=j8, t8=t8)


@pytest.fixture(scope="module")
def serving(model):
    jcfg = dataclasses.replace(model["jcfg"],
                               generation=JGenerationConfig(length_buckets=BUCKETS))
    tcfg = dataclasses.replace(model["tcfg"],
                               generation=TC.GenerationConfig(length_buckets=BUCKETS))
    images = [np.random.default_rng([12, s]).integers(0, 256, SHAPE, dtype=np.uint8)
              for s in SERVE_SEEDS]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=model["j8"], tp=model["t8"], images=images)


@pytest.fixture(scope="module")
def training(model):
    rng = jax.random.PRNGKey(1)
    draws = jax_draws(jax.random.split(rng)[0], 4, n_anchors(model["tcfg"]),
                      pool_size(model["tcfg"], True))
    return dict(model, rng=rng, batch=make_batch(TRAIN_SEED, b=4), draws=draws)


def _serve_cases():
    return [dict(batch_size=4, kv_cache_dtype=None, **kw) for kw in CASES.values()]


def _lm_inputs():
    rng = np.random.default_rng(5)
    b, s = 4, 9
    return {"input_ids": rng.integers(1, 50, (b, 29, s)).astype(np.int64),
            "attention_mask": (np.arange(s)[None, None] < rng.integers(2, s + 1, (b, 29, 1))
                               ).astype(np.float32),
            "region_features": rng.normal(0, 1, (b, 29, 1024)).astype(np.float32),
            "seq_valid": rng.uniform(size=(b, 29)) < 0.5}


def _train_cli_argv(train_cli, run_dir, workers, steps):
    return ["--stage", "3", "--train-csv", train_cli["csv"], "--tokenizer-dir", train_cli["tok"],
            "--run-dir", os.path.join(run_dir, f"train_cli_w{workers}"), "--batch-size", "2",
            "--seq-len", str(CLI_SEQ), "--lm-budget", str(LM_BUDGET), "--max-steps", str(steps),
            "--workers", str(workers), "--prefetch", "1", "--device", "cpu"]


def _world_tasks(serving, training, run_dir, dec_cfg, cli_argv, train_cli, world):
    """The rank tasks, in an order in which none sees another's changes:
    serving reads the detector that train_step then trains in place (the
    tasks share it, so it is pickled once), the backbone and dropout
    checks copy what they change; the serve CLI loads its own checkpoint
    and writes <run_dir>/serve.txt; the train CLI trains its own init
    under <run_dir>/train_cli_w<workers> (with --workers 0 at world 2
    only)."""
    t = training
    lcfg = TC.RGRGConfig(model=t["tcfg"], train=TC.TrainConfig(grad_accumulation_steps=1))
    rng = np.random.default_rng(2)   # the f64 backbone check at 128x128
    images = rng.normal(0, 1, (4, 128, 128, 1)).astype(np.float32)
    weights = rng.normal(0, 1, (4, 4, 4, 2048)).astype(np.float32)
    return [
        ("helpers", ranks.helpers, ()),
        ("serve", ranks.serve, (serving["tp"], serving["tcfg"], serving["images"],
                                _serve_cases())),
        ("backbone", ranks.backbone_grads, (t["tp"]["detector"].backbone, images, weights,
                                            torch.float64)),
        ("dropout", ranks.draws_and_dropout, (t["tp"]["decoder"], dec_cfg, _lm_inputs(), 40)),
        ("train_step", ranks.train_step, (t["tp"], t["tcfg"], TC.TrainConfig(
            grad_accumulation_steps=1), t["batch"], t["draws"], LM_BUDGET)),
        ("loop", ranks.train_loop, (lcfg, [make_batch(TRAIN_SEED + 1, b=2)], run_dir,
                                    LM_BUDGET)),
        ("serve_cli", ranks.serve_cli, (cli_argv + ["--output", os.path.join(run_dir,
                                                                             "serve.txt")],
                                        serving["tcfg"])),
        ("train_cli", ranks.train_cli, (_train_cli_argv(train_cli, run_dir, 2, 2), lcfg)),
    ] + ([("train_cli_w0", ranks.train_cli, (_train_cli_argv(train_cli, run_dir, 0, 1), lcfg))]
         if world > 1 else [])


def _serve_cli_inputs(serving, root):
    """The serve CLI's arguments (without --output): the serving images as
    PNGs, a tokenizer directory and a checkpoint directory under `root`."""
    import cv2
    tok, images, ckpt = (os.path.join(root, d) for d in ("tok", "images", "ckpt"))
    os.makedirs(tok)
    os.makedirs(images)
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        json.dump(GPT2Tokenizer.dummy().encoder, f)
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    for i, image in enumerate(serving["images"]):
        cv2.imwrite(os.path.join(images, f"x{i}.png"), image)
    save_checkpoint(ckpt, serving["tp"])
    return ["--checkpoint", ckpt, "--tokenizer-dir", tok, "--image-dir", images,
            "--pattern", "*.png", "--batch-size", "4", "--max-length", "6", "--device", "cpu"]


@pytest.fixture(scope="module")
def worlds(serving, training, tmp_path_factory):
    """Every rank task at world 1 (here) and at world 2 (one gloo launch,
    running meanwhile). The checkpoints are deleted afterwards."""
    _, dec_cfg = train_configs(dropout=0.5, representation_size=16)
    root = tmp_path_factory.mktemp("worlds")
    try:
        yield _run_worlds(serving, training, root, dec_cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run_worlds(serving, training, root, dec_cfg):
    dirs = {w: str(root / f"world{w}") for w in (1, 2)}
    for d in dirs.values():
        os.makedirs(d)
    cli = _serve_cli_inputs(serving, str(root / "cli"))
    os.makedirs(root / "train_cli")
    csv_path, _ = write_split(root / "train_cli", rows=6, unreadable=(0,))
    train_cli = dict(csv=csv_path, tok=write_tokenizer(root / "train_cli" / "tok"))
    # neither world reads the other's results, so world 1 runs here while
    # world 2's ranks run (the longer part: its ranks get 3/8 of the
    # threads each, world 1 the rest)
    threads = torch.get_num_threads()
    rank_threads = max(1, threads * 3 // 8)
    torch.set_num_threads(max(1, threads - 2 * rank_threads))
    try:
        with cf.ThreadPoolExecutor(1) as pool:
            two = pool.submit(mesh.launch, ranks.tasks, 2,
                              args=(_world_tasks(serving, training, dirs[2], dec_cfg.decoder,
                                                 cli + ["--data-parallel", "2"], train_cli, 2),),
                              device="cpu", timeout_s=600, threads=rank_threads)
            one = ranks.tasks(0, copy.deepcopy(_world_tasks(serving, training, dirs[1],
                                                            dec_cfg.decoder, cli, train_cli, 1)))
            return {1: one, 2: two.result(), "dirs": dirs, "train_cli": train_cli}
    finally:
        torch.set_num_threads(threads)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _param_diff(params, ref):
    return [float(np.abs(p - r).max()) for p, r in zip(params, ref)]


# ---------------------------------------------------------------- helpers

def test_make_mesh_limits_and_clamp_as_jax(worlds):
    """make_mesh raises past the visible devices (the ranks of the process
    group; one outside a launch) and clamps to a batch it must divide, as
    JAX's does (tests/test_mesh_inference.py: test_mesh_clamps_to_batch)."""
    with pytest.raises(ValueError, match="only 1 available"):
        mesh.make_mesh(2)
    assert mesh.make_mesh(batch_size=3).size == 1
    assert jmesh.make_mesh(batch_size=3).size in (1, 3)
    for r, out in enumerate(worlds[2]):
        h = out["helpers"]
        assert "requested 3 devices but only 2 available" in h["too_many"]
        assert h["clamped"] == (1, r == 0) and (h["size"], h["rank"]) == (2, r)


def test_shard_and_replicate_pytree(worlds):
    """Each rank keeps its contiguous rows, in rank order; replication
    gives every rank rank 0's bits (f32, bf16 module, non-contiguous)."""
    h0, h1 = (out["helpers"] for out in worlds[2])
    np.testing.assert_array_equal(np.concatenate([h0["x"], h1["x"]]),
                                  np.arange(8).reshape(4, 2))
    np.testing.assert_array_equal(np.concatenate([h0["t"], h1["t"]]), np.arange(4) * 10)
    assert h0["name"] == h1["name"] == "b"
    assert not np.array_equal(h0["before"], h1["before"])
    for k in ("a", "m", "l"):
        np.testing.assert_array_equal(h1[k], h0[k])
    np.testing.assert_array_equal(h1["a"], h0["before"])


def test_failing_rank_makes_the_launcher_raise():
    """Rank 1 raises while rank 0 waits in a barrier: launch stops rank 0
    and raises with rank 1's traceback, well inside the timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*fails on purpose"):
        mesh.launch(ranks.fail_on_rank_1, 2, device="cpu", timeout_s=60)
    assert time.perf_counter() - t0 < 60


# ---------------------------------------------------------------- serving

def test_serving_images_have_margins(serving):
    tp, cfg = serving["tp"], serving["tcfg"]
    gen = ReportGenerator(tp, GPT2Tokenizer.dummy(), cfg=cfg)
    model = RGRG(cfg)
    for image in serving["images"]:
        x = gen.preprocess([image])
        assert has_parity_margins(tp["detector"], x)
        det = model.detect(tp, x)
        feats = det["region_features"][0][det["selected_regions"][0]]
        assert feats.shape[0] > 0
        assert greedy_logit_margin(tp["decoder"], feats, cfg.decoder, 6) >= MIN_GAP
        for cap in BUCKETS:
            assert beam_score_margin(tp["decoder"], feats, cfg.decoder, cap, 3, True) >= MIN_GAP


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_serving_matches_world1_and_jax(serving, worlds, case):
    """World 2 (each rank its half of every batch, the last batch padded)
    == world 1 == JAX's generate_reports_pipelined on its 2-device mesh:
    identical reports and selections; every rank yields all of them; the
    CascadeStats counted over both ranks equal world 1's."""
    i = list(CASES).index(case)
    one = worlds[1]["serve"][i]
    jgen = JReportGenerator(serving["jp"], JTokenizer.dummy(), cfg=serving["jcfg"],
                            similarity_fn=None)
    want = [r for c in j_pipelined(jgen, serving["images"], mesh=jmesh.make_mesh(2),
                                   **_serve_cases()[i]) for r in c]
    assert len(want) == len(one["reports"]) == 5
    assert one["reports"] == [r.report for r in want]
    np.testing.assert_array_equal(one["selected"], np.stack([r.selected_regions
                                                              for r in want]))
    for out in worlds[2]:
        two = out["serve"][i]
        assert two["reports"] == one["reports"]
        np.testing.assert_array_equal(two["selected"], one["selected"])
        assert two["stats"] == one["stats"]
    assert one["stats"]["rows_selected"] == int(one["selected"].sum()) > 0


def test_mesh_serving_rejects_bad_batch_and_chunking(serving):
    """As JAX's (tests/test_mesh_inference.py): batch 4 over 3 ranks and
    detect_image_chunk with a mesh raise before any work."""
    gen = ReportGenerator(serving["tp"], GPT2Tokenizer.dummy(), cfg=serving["tcfg"])
    imgs = [np.zeros((64, 64), np.uint8)] * 4
    three = mesh.Mesh(3, 0)
    with pytest.raises(ValueError, match="multiple"):
        list(generate_reports_pipelined(gen, imgs, batch_size=4, mesh=three))
    with pytest.raises(ValueError, match="detect_image_chunk"):
        list(generate_reports_pipelined(gen, imgs, batch_size=4, detect_image_chunk=2,
                                        mesh=mesh.make_mesh()))
    jgen = JReportGenerator(serving["jp"], JTokenizer.dummy(), cfg=serving["jcfg"],
                            similarity_fn=None)
    with pytest.raises(ValueError, match="multiple"):
        list(j_pipelined(jgen, imgs, batch_size=4, mesh=jmesh.make_mesh(num_devices=3)))
    with pytest.raises(ValueError, match="detect_image_chunk"):
        list(j_pipelined(jgen, imgs, batch_size=4, detect_image_chunk=2,
                         mesh=jmesh.make_mesh(num_devices=2)))


def test_serve_cli_data_parallel_writes_the_same_file(worlds):
    """The serve CLI's ranks with `--data-parallel 2 --device cpu` (two
    gloo ranks; rank 0 writes) write the file the run without it does."""
    one, two = (open(os.path.join(worlds["dirs"][w], "serve.txt")).read() for w in (1, 2))
    assert one.count("x4.png") == 1
    assert two == one


def test_serve_cli_data_parallel_launches_its_ranks(monkeypatch, tmp_path):
    """`--data-parallel N` starts N ranks of the CLI's rank function
    through core.mesh.launch, on the device named."""
    calls = []
    monkeypatch.setattr(mesh, "launch", lambda fn, n, args, device: calls.append(
        (fn, n, args[0].data_parallel, device)))
    tserve.main(["--checkpoint", "c", "--tokenizer-dir", "t", "--image-dir", str(tmp_path),
                 "--output", "o", "--data-parallel", "2", "--device", "cpu"])
    assert calls == [(tserve._serve_rank, 2, 2, "cpu")]


# ---------------------------------------------------------------- training

def test_train_batch_has_margins_and_shows_the_traps(training):
    """The global batch clears TRAINING_MARGINS; its LM-valid rows exceed
    the budget; the halves (the two ranks' rows) hold different numbers of
    valid target tokens; each half's first BatchNorm statistics differ from
    the batch's."""
    t = training
    det = copy.deepcopy(t["tp"])["detector"]
    b = trainer.batch_to_device(t["batch"], CPU)
    m = training_margins(det, b["images"], b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                         t["draws"][2:], bn_train=True)
    assert all(m[k] >= v for k, v in TRAINING_MARGINS.items()), m
    with torch.no_grad():
        _, aux = det.train_forward(b["images"], b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                                   iter(t["draws"]))
        valid = aux["class_detected"] & b["region_has_sentence"]
        tokens = (b["attention_mask"][..., 1:] * valid[..., None]).sum(dim=(1, 2))
        assert int(valid.sum()) > LM_BUDGET
        assert tokens[:2].sum() != tokens[2:].sum()
        x = det.backbone.conv1(b["images"].permute(0, 3, 1, 2))
        whole = x.mean(dim=(0, 2, 3))
        for half in (x[:2], x[2:]):
            assert (half.mean(dim=(0, 2, 3)) - whole).abs().max() > 1e-3


def test_train_step_world2_equals_world1(training, worlds):
    """Losses within 1e-5 (relative), BatchNorm running statistics within
    1e-5 (of max(1, |statistic|)), gradients within 1e-4 relative L2
    outside the backbone and 2e-2 in it (f32 cancellation in train-mode
    BatchNorm's backward at this size puts either world ~5e-3 from f64; in
    f64 they agree to 1e-10: test_backbone_gradient_world2_equals_world1_in_f64),
    the parameters after the update within 2 x lr (Adam turns a near-zero
    gradient's rounding into a whole step), and bitwise equal across ranks."""
    one = worlds[1]["train_step"]
    two = [out["train_step"] for out in worlds[2]]
    assert two[0]["losses"] == two[1]["losses"]
    for k, v in one["losses"].items():
        np.testing.assert_allclose(two[0]["losses"][k], v, rtol=1e-5, err_msg=k)
    for k, v in one["stats"].items():
        err = np.abs(two[0]["stats"][k] - v).max() / max(1.0, np.abs(v).max())
        assert err <= 1e-5, k
    names = [n for n, _ in training["tp"]["detector"].named_parameters()]
    names += ["decoder"] * (len(one["grads"]) - len(names))
    assert len(two[0]["grads"]) == len(names)
    for n, g, r in zip(names, two[0]["grads"], one["grads"]):
        rel = _rel_l2(g, r)
        assert rel <= (2e-2 if n.startswith("backbone.") else 1e-4), (n, rel)
    lr = TC.TrainConfig().learning_rate
    assert max(_param_diff(two[0]["params"], one["params"])) <= 2 * lr + 1e-6
    assert two[0]["digest"] == two[1]["digest"]


def test_backbone_gradient_world2_equals_world1_in_f64(worlds):
    """The backbone with train-mode BatchNorm over the global batch: the
    ranks' all-reduced f64 parameter gradients equal world 1's within
    1e-10 (relative L2, every tensor)."""
    one, two = worlds[1]["backbone"]["grads"], worlds[2][0]["backbone"]["grads"]
    assert set(two) == set(one)
    rel = {n: _rel_l2(g, one[n]) for n, g in two.items()}
    assert max(rel.values()) <= 1e-10, max(rel.items(), key=lambda kv: kv[1])
    assert worlds[2][1]["backbone"]["digest"] == worlds[2][0]["backbone"]["digest"]


def test_draws_and_dropout_do_not_depend_on_the_world(worlds):
    """assign.uniform and the LM's dropout masks are drawn at the global
    shape and cut: world 2's keys, loss and region-feature gradients equal
    world 1's (dropout 0.5, budget 40 of the global rows)."""
    one = worlds[1]["dropout"]
    two = [out["dropout"] for out in worlds[2]]
    np.testing.assert_array_equal(np.concatenate([two[0]["keys"], two[1]["keys"]]),
                                  one["keys"])
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-6)
    assert two[0]["loss"] == two[1]["loss"]
    np.testing.assert_allclose(np.concatenate([two[0]["feats_grad"], two[1]["feats_grad"]]),
                               one["feats_grad"], rtol=1e-5, atol=1e-9)
    assert np.abs(one["feats_grad"]).max() > 0


def test_train_step_world2_matches_jax_and_a_naive_mean_does_not(training, worlds):
    """World 2's losses equal JAX's single-device compute_losses on the
    global batch within TOL; the mean of the halves' own losses (per-rank
    BatchNorm, draws, LM compaction and means: a naive data-parallel
    port) falls outside TOL."""
    t = training
    tc = JTrainConfig()
    model = JRGRG(t["jcfg"])
    jbatch = {k: jnp.asarray(v) for k, v in t["batch"].items()}
    _, want, _ = jax.jit(lambda p: jtrainer.compute_losses(model, p, jbatch, t["rng"], 3, tc,
                                                            LM_BUDGET, train=True))(t["jp"])
    want = jax.tree.map(float, want)
    got = worlds[2][0]["train_step"]["losses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        params = copy.deepcopy(t["tp"])
        batch = trainer.batch_to_device({k: v[rows] for k, v in t["batch"].items()}, CPU)
        with torch.no_grad():
            _, losses = trainer.compute_losses(RGRG(t["tcfg"]), params, batch,
                                               iter([d[rows] for d in t["draws"]]), 3,
                                               TC.TrainConfig(), LM_BUDGET)
        halves.append({k: float(v) for k, v in losses.items()})
    naive = {k: (halves[0][k] + halves[1][k]) / 2 for k in want}
    off = [k for k in want if not np.isclose(naive[k], want[k], **TOL)]
    assert "loss_total" in off and "loss_lm" in off, (naive, want)


def test_train_loop_world2_matches_world1_and_resumes(worlds):
    """train.loop.train at world 2: rank 0 alone writes metrics.jsonl and
    `last` (one record per epoch, as world 1's); the parameters after the
    step and after the resume from `last` equal world 1's within 2 x lr a
    step, and are bitwise equal across the ranks."""
    lr = TC.TrainConfig().learning_rate
    one, two = worlds[1]["loop"], [out["loop"] for out in worlds[2]]
    for name, steps in (("run", 1), ("resumed", 2)):
        assert one[name]["step"] == two[0][name]["step"] == two[1][name]["step"] == steps
        diff = _param_diff(two[0][name]["params"], one[name]["params"])
        assert max(diff) <= 2 * lr * steps + 1e-6
        assert two[0][name]["digest"] == two[1][name]["digest"]
        recs = {w: [json.loads(line) for line in
                    open(os.path.join(worlds["dirs"][w], name, "metrics.jsonl"))]
                for w in (1, 2)}
        strip = [[{k: v for k, v in r.items() if k not in ("time", "train/epoch_seconds")}
                  for r in recs[w]] for w in (1, 2)]
        assert strip[0] == strip[1] and len(strip[1]) == 1
        assert os.path.isfile(os.path.join(worlds["dirs"][2], name, "last",
                                           "train_state.pt"))


def _cli_dataset(train_cli):
    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    return RGRGDataset(read_split_csv(train_cli["csv"]),
                       GPT2Tokenizer.from_dir(train_cli["tok"]), train=True, seq_len=CLI_SEQ)


def test_train_cli_ranks_load_their_rows_and_match_world1(worlds):
    """The train CLI's ranks with `--workers 2` (two gloo ranks, batch 2,
    two mini-steps; the split's unreadable image lies in rank 0's rows of
    the first batch): each rank's batches are the rows of
    tests/test_torch_rank_loading.py's in-process ranks on the same split,
    and the shards of world 1's (the replicated loader's) batches; the
    trained parameters equal world 1's within 2 x lr a step and are
    bitwise equal across the ranks; rank 0 wrote `last`."""
    lr = TC.TrainConfig().learning_rate
    one, two = worlds[1]["train_cli"], [out["train_cli"] for out in worlds[2]]
    local = ranks.rank_local_epochs(lambda: _cli_dataset(worlds["train_cli"]), 2, 2, epochs=1)
    assert [len(epochs[0][0]) for epochs in local] == [2, 2]
    assert local[0][0][1].unreadable == 1 and local[0][0][1].built > local[0][0][1].rows
    for r, out in enumerate(two):
        assert out["batches"] == [ranks.batch_digest(b) for b in local[r][0][0]]
    replicated = list(_cli_dataset(worlds["train_cli"]).batches(2, shuffle=True, workers=2))
    assert one["batches"] == [ranks.batch_digest(b) for b in replicated]
    assert [ranks.batch_digest(mesh.shard_pytree_batch(b, mesh.Mesh(2, 0)))
            for b in replicated] == two[0]["batches"]
    assert one["step"] == two[0]["step"] == two[1]["step"] == 2
    assert two[0]["digest"] == two[1]["digest"]
    assert max(_param_diff(two[0]["params"], one["params"])) <= 2 * lr * 2 + 1e-6
    assert os.path.isfile(os.path.join(worlds["dirs"][2], "train_cli_w2", "last",
                                       "train_state.pt"))


def test_train_cli_ranks_with_workers_0_keep_the_replicated_batches(worlds):
    """`--workers 0` at world 2: each rank's batch is its rows of the
    shared Generator's global batch (the JAX package's workers=0 stream)."""
    want = next(_cli_dataset(worlds["train_cli"]).batches(2, shuffle=True, workers=0))
    for r, out in enumerate(worlds[2]):
        assert out["train_cli_w0"]["batches"] == [
            ranks.batch_digest(mesh.shard_pytree_batch(want, mesh.Mesh(2, r)))]
        assert out["train_cli_w0"]["step"] == 1
