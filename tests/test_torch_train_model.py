"""The port's training path against the JAX package on the CPU, on a small
model: a shallow (1,1,1,1) ResNet at 512x512, 64 training / 32 test RPN
proposals, 32 sampled RoIs, and a 2-layer, 16-wide GPT-2 with dropout 0
(JAX's dropout at rate 0 is the identity; the port's dropout is pinned by
its statistics). JAX params come from `RGRG(cfg).init` and cross over by
core/convert.from_jax_params; the port's sampling replays JAX's uniform
draws (tests/test_torch_train_ops.jax_draws). Each JAX function is jitted
once for the module.

The batch is a fixed seed whose every discrete decision of a training
step (objectness order, NMS, RoI matching, top-1 per class) clears the
two libraries' f32 disagreement by ~10x (tests/torch_parity.py
`training_margins`, asserted here, not searched). Tolerances are stated
per test.
"""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from rgrg_tpu.core import config as JC
from rgrg_tpu.models import gpt2 as jgpt2
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.train import losses as JL
from rgrg_tpu.train import trainer as jtrainer

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core.checkpoint import load_checkpoint
from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.eval.evaluator import validation_losses
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.models.layers import BatchNorm2d
from rgrg_tpu_torch.train import losses as L
from rgrg_tpu_torch.train import loop, trainer

from tests.test_torch_kernels import random_boxes
from tests.test_torch_train_ops import jax_draws
from tests.torch_parity import TRAINING_MARGINS, training_margins

SEED = 12         # the batch (images, boxes, tokens); margins asserted below
LM_BUDGET = 24
TOL = dict(rtol=1e-4, atol=1e-5)   # model outputs and losses: two libraries' f32


def configs(dropout=0.0, representation_size=1024):
    dec = dict(vocab_size=50, hidden_dim=16, num_heads=2, num_layers=2, max_positions=64,
               bos_token_id=0, eos_token_id=0, pad_token_id=0, image_feature_dim=1024,
               embd_dropout=dropout, attn_dropout=dropout, resid_dropout=dropout)
    rpn = dict(pre_nms_top_n_train=64, post_nms_top_n_train=64, pre_nms_top_n_test=32)
    jcfg = JC.ModelConfig(
        detector=JC.DetectorConfig(backbone_stages=(1, 1, 1, 1),
                                   rpn=JC.RPNConfig(post_nms_top_n_test=32, **rpn),
                                   roi=JC.RoIConfig(batch_size_per_image=32,
                                                    representation_size=representation_size)),
        decoder=JC.DecoderConfig(**dec))
    tcfg = TC.ModelConfig(
        detector=TC.DetectorConfig(backbone_stages=(1, 1, 1, 1), rpn=TC.RPNConfig(**rpn),
                                   roi=TC.RoIConfig(batch_size_per_image=32,
                                                    representation_size=representation_size)),
        decoder=TC.DecoderConfig(**dec))
    return jcfg, tcfg


def make_batch(seed, b=2, s=10):
    rng = np.random.default_rng(seed)
    gt = np.stack([random_boxes(29, min_size=24.0, rng=rng) for _ in range(b)])
    return {"images": rng.normal(0, 1, (b, 512, 512, 1)).astype(np.float32),
            "gt_boxes": gt,
            "gt_labels": np.tile(np.arange(1, 30, dtype=np.int32), (b, 1)),
            "gt_valid": rng.uniform(size=(b, 29)) < 0.9,
            "input_ids": rng.integers(1, 50, (b, 29, s)).astype(np.int32),
            "attention_mask": (np.arange(s)[None, None, :]
                               < rng.integers(3, s + 1, (b, 29, 1))).astype(np.float32),
            "region_has_sentence": rng.uniform(size=(b, 29)) < 0.6,
            "region_is_abnormal": rng.uniform(size=(b, 29)) < 0.3}


def n_anchors(cfg):
    return cfg.detector.anchors.num_anchors_per_location * 16 * 16


def pool_size(cfg, train):
    return cfg.detector.rpn.pre_nms_top_n(train) + 29


def tensors(batch):
    return trainer.batch_to_device(batch, torch.device("cpu"))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jp = jax.jit(lambda r: JRGRG(jcfg).init(r))(jax.random.PRNGKey(0))
    jp = jax.tree.map(np.asarray, jp)
    batch = make_batch(SEED)
    rng = jax.random.PRNGKey(1)
    rng_det, _ = jax.random.split(rng)
    draws = {train: jax_draws(rng_det, 2, n_anchors(tcfg), pool_size(tcfg, train))
             for train in (True, False)}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, batch=batch, rng=rng, draws=draws)


def port_params(setup):
    return from_jax_params(setup["jp"], setup["tcfg"], "cpu")


@pytest.fixture(scope="module")
def jax_losses(setup):
    """JAX's stage-3 compute_losses, with its gradient for train=True."""
    jcfg, jp, batch, rng = setup["jcfg"], setup["jp"], setup["batch"], setup["rng"]
    model = JRGRG(jcfg)
    tc = JC.TrainConfig()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params, train):
        total, losses, stats = jtrainer.compute_losses(model, params, jbatch, rng, 3, tc,
                                                       LM_BUDGET, train=train)
        return total, (losses, stats)

    (_, (lt, stats)), grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, True), has_aux=True))(jp)
    _, (lf, _) = jax.jit(lambda p: loss(p, False))(jp)
    return {True: jax.tree.map(np.asarray, lt), False: jax.tree.map(np.asarray, lf),
            "stats": jax.tree.map(np.asarray, stats), "grads": jax.tree.map(np.asarray, grads)}


def test_batch_has_training_margins(setup):
    """The fixed batch clears every discrete decision of a training step
    (train and eval RPN top-n) by TRAINING_MARGINS on the port."""
    det = port_params(setup)["detector"]
    b = tensors(setup["batch"])
    for train in (True, False):
        m = training_margins(det, b["images"], b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                             setup["draws"][train][2:], bn_train=train)
        assert all(m[k] >= v for k, v in TRAINING_MARGINS.items()), (train, m)


# ---------------------------------------------------------------- decoder

@pytest.fixture(scope="module")
def decoder_case(setup):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 50, (5, 9)).astype(np.int32)
    mask = (np.arange(9)[None] < rng.integers(2, 10, (5, 1))).astype(np.float32)
    feats = rng.normal(0, 1, (5, 1024)).astype(np.float32)
    jdec = {k: v for k, v in setup["jp"]["decoder"].items()}
    jfull = jax.jit(lambda p, i, m, f: jgpt2.forward_full(p, i, m, f, setup["jcfg"].decoder))
    jvanilla = jax.jit(lambda p, i, m: jgpt2.forward_full(p, i, m, None, setup["jcfg"].decoder))
    want = {"image": np.asarray(jfull(jdec, ids, mask, feats)),
            "none": np.asarray(jvanilla(jdec, ids, mask))}
    return dict(ids=ids, mask=mask, feats=feats, want=want)


@pytest.mark.parametrize("image", ["image", "none"])
def test_forward_full_matches_jax_and_remat_is_identical(setup, decoder_case, image):
    """Logits within 1e-5 of JAX (with the image slot and vanilla GPT-2);
    per-block checkpointing gives identical logits and gradients."""
    c = decoder_case
    dec = port_params(setup)["decoder"]
    cfg = setup["tcfg"].decoder
    ids, mask = torch.from_numpy(c["ids"]).long(), torch.from_numpy(c["mask"])
    feats = torch.from_numpy(c["feats"]) if image == "image" else None
    outs = []
    for remat in (False, True):
        for t in trainer.leaves(dec):
            t.grad = None
            t.requires_grad_(True)
        logits = gpt2.forward_full(dec, ids, mask, feats, cfg, remat=remat)
        logits.square().mean().backward()
        outs.append((logits.detach(), [t.grad.clone() for t in trainer.leaves(dec)
                                       if t.grad is not None]))
    np.testing.assert_allclose(outs[0][0].numpy(), c["want"][image], rtol=1e-5, atol=1e-5)
    assert torch.equal(outs[0][0], outs[1][0])
    assert len(outs[0][1]) == len(outs[1][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_forward_full_dropout_statistics_and_remat_masks(setup):
    """Dropout at rate 0.5 drops about half the attention weights' share and
    keeps the expected value (inverted scaling); with the same seed, remat
    recomputes the same masks (identical logits and gradients)."""
    _, tcfg = configs(dropout=0.5)
    dec = port_params(setup)["decoder"]
    ids = torch.randint(1, 50, (64, 12), generator=torch.Generator().manual_seed(0))
    mask = torch.ones(64, 12)
    feats = torch.randn(64, 1024, generator=torch.Generator().manual_seed(1))
    x = torch.ones(200_000)
    kept = gpt2._dropout(x, 0.5)
    assert abs(float((kept == 0).float().mean()) - 0.5) < 0.01
    assert abs(float(kept.mean()) - 1.0) < 0.02
    assert torch.equal(gpt2._dropout(x, 0.0), x)
    outs = []
    for remat in (False, True):
        torch.manual_seed(11)
        for t in trainer.leaves(dec):
            t.grad = None
            t.requires_grad_(True)
        logits = gpt2.forward_full(dec, ids, mask, feats, tcfg.decoder, dropout=True,
                                   remat=remat)
        logits.square().mean().backward()
        outs.append((logits.detach(), [t.grad.clone() for t in trainer.leaves(dec)
                                       if t.grad is not None]))
    assert torch.equal(outs[0][0], outs[1][0]) and len(outs[0][1]) == len(outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    plain = gpt2.forward_full(dec, ids, mask, feats, tcfg.decoder)
    assert not torch.equal(plain.detach(), outs[0][0])


def test_language_model_losses_match_jax(setup, decoder_case):
    """language_model_loss and lm_loss_selected (compaction to a budget,
    logsumexp CE) within 1e-5 of JAX."""
    c = decoder_case
    jdec, jcfg = setup["jp"]["decoder"], setup["jcfg"].decoder
    dec, cfg = port_params(setup)["decoder"], setup["tcfg"].decoder
    want = float(jax.jit(lambda p: jgpt2.language_model_loss(
        p, c["ids"], c["mask"], c["feats"], jcfg))(jdec))
    got = float(gpt2.language_model_loss(dec, torch.from_numpy(c["ids"]).long(),
                                         torch.from_numpy(c["mask"]),
                                         torch.from_numpy(c["feats"]), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    b = setup["batch"]
    feats = np.random.default_rng(4).normal(0, 1, (2, 29, 1024)).astype(np.float32)
    valid = b["region_has_sentence"] & b["gt_valid"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = float(jax.jit(lambda p: JL.lm_loss_selected(
        p, jb["input_ids"], jb["attention_mask"], jnp.asarray(feats), jnp.asarray(valid),
        jcfg, LM_BUDGET))(jdec))
    t = tensors(b)
    got = float(L.lm_loss_selected(dec, t["input_ids"], t["attention_mask"],
                                   torch.from_numpy(feats), torch.from_numpy(valid), cfg,
                                   LM_BUDGET))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------- detector

@pytest.mark.parametrize("bn_train", [True, False])
def test_train_forward_matches_jax(setup, bn_train):
    """Losses, aux (region features, detections, classifier logits) and, in
    BN train mode, the new running statistics against JAX's
    train_forward (mutable batch_stats), within TOL; class_detected
    identical; eval BN leaves the statistics bit-unchanged."""
    jcfg, jp, b = setup["jcfg"], setup["jp"], setup["batch"]
    jdet = JRGRG(jcfg).detector
    rng_det, _ = jax.random.split(setup["rng"])
    fn = jax.jit(lambda v: jdet.apply(
        v, b["images"], b["gt_boxes"], b["gt_labels"], b["gt_valid"], rng_det,
        method=jdet.train_forward, bn_train=bn_train, mutable=["batch_stats"]))
    (jlosses, jaux), mutated = fn(jp["detector"])
    det = port_params(setup)["detector"]
    before = {k: v.clone() for k, v in det.named_buffers()}
    t = tensors(b)
    losses, aux = det.train_forward(t["images"], t["gt_boxes"], t["gt_labels"],
                                    t["gt_valid"], iter(setup["draws"][bn_train]),
                                    bn_train=bn_train)
    assert not det.training
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(aux["class_detected"].numpy(),
                                  np.asarray(jaux["class_detected"]))
    for k in ("region_features", "selection_logits", "abnormal_logits"):
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    stats = dict(det.named_buffers())
    if bn_train:
        bs = mutated["batch_stats"]
        for name in ("backbone.bn1", "backbone.layer4_0.bn3",
                     "backbone.layer2_0.downsample_bn"):
            node = bs
            for part in name.split("."):
                node = node[part]
            for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(stats[f"{name}.{ours}"].numpy(),
                                           np.asarray(node[theirs]), rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name}.{ours}")
        assert not torch.equal(stats["backbone.bn1.running_mean"],
                               before["backbone.bn1.running_mean"])
    else:
        assert all(torch.equal(stats[k], before[k]) for k in before)


def test_roi_head_loss_reaches_the_backbone(setup):
    """The RoI-head losses alone backpropagate through RoIAlign into the
    backbone; the proposals are decoded from detached RPN outputs, so the
    RPN head gets no gradient from them (as in JAX's stop_gradient)."""
    det = port_params(setup)["detector"]
    t = tensors(setup["batch"])
    losses, _ = det.train_forward(t["images"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
                                  iter(setup["draws"][True]))
    (losses["loss_classifier"] + losses["loss_box_reg"]).backward()
    assert det.backbone.conv1.weight.grad.abs().sum() > 0
    assert det.box_head.fc6.kernel.grad.abs().sum() > 0
    assert det.rpn_head.cls_logits.weight.grad is None
    assert det.rpn_head.bbox_pred.weight.grad is None


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("train", [True, False])
def test_compute_losses_matches_jax(setup, jax_losses, stage, train):
    """The port's compute_losses for each stage and mode against JAX's
    stage-3 losses (stages 1 and 2 are its first terms: the same draws give
    the same detector and classifier losses), within TOL; the total as the
    stage's weighted sum."""
    model = RGRG(setup["tcfg"])
    params = port_params(setup)
    tc = TC.TrainConfig()
    total, losses = trainer.compute_losses(model, params, tensors(setup["batch"]),
                                           iter(setup["draws"][train]), stage, tc, LM_BUDGET,
                                           train=train)
    want = jax_losses[train]
    names = ["loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"]
    names += ["loss_selection", "loss_abnormal"] if stage >= 2 else []
    names += ["loss_lm"] if stage >= 3 else []
    assert set(losses) == set(names) | {"loss_total"}
    for k in names:
        np.testing.assert_allclose(float(losses[k]), float(want[k]), **TOL, err_msg=k)
    w = {"loss_selection": 5.0, "loss_abnormal": 5.0, "loss_lm": 2.0}
    expect = sum(w.get(k, 1.0) * float(want[k]) for k in names)
    np.testing.assert_allclose(float(total), expect, **TOL)
    if stage == 3:
        np.testing.assert_allclose(float(total), float(want["loss_total"]), **TOL)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_stage3_gradients_match_jax_grad(setup, jax_losses):
    """Every trainable gradient of a stage-3 step (detector incl. backbone
    through RoIAlign's backward and train-mode BN; uk / uv and the feature
    transform) against jax.grad: the heads, RPN head and the last block's
    output BN within 2e-3 relative L2, the backbone within 2e-2 (XLA's f32
    CPU backward through train-mode BN is further from an f64 reference
    than the port's, which is within 1e-4 of one:
    `test_backbone_gradient_matches_f64_reference`); the frozen GPT-2 base
    gets none."""
    model = RGRG(setup["tcfg"])
    params = port_params(setup)
    trainer.set_trainable_(params, 3)
    total, _ = trainer.compute_losses(model, params, tensors(setup["batch"]),
                                      iter(setup["draws"][True]), 3, TC.TrainConfig(),
                                      LM_BUDGET)
    total.backward()
    jg = jax_losses["grads"]
    gdet = from_jax_params({"detector": jg["detector"], "decoder": {}}, setup["tcfg"],
                           "cpu")["detector"]
    want = dict(gdet.named_parameters())
    worst = {}
    for name, p in params["detector"].named_parameters():
        assert p.grad is not None, name
        worst[name] = _rel_l2(p.grad.numpy(), want[name].detach().numpy())
    heads = {k: v for k, v in worst.items() if not k.startswith("backbone.")}
    assert max(heads.values()) < 2e-3, sorted(heads.items(), key=lambda kv: -kv[1])[:5]
    assert max(worst.values()) < 2e-2, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    mask = trainer.decoder_trainable_mask(params["decoder"])
    flat_mask = trainer.leaves(mask)
    flat_t = trainer.leaves(params["decoder"])
    flat_j = trainer.leaves(jax.tree.map(torch.from_numpy, jg["decoder"]))
    assert sum(flat_mask) == 2 * 2 * 2 + 4
    for m, t, j in zip(flat_mask, flat_t, flat_j):
        if m:
            assert _rel_l2(t.grad.numpy(), j.numpy()) < 1e-4
        else:
            assert t.grad is None and not t.requires_grad
    assert params["detector"].backbone.conv1.weight.grad.abs().sum() > 0


def test_backbone_gradient_matches_f64_reference():
    """The train-mode backbone's parameter gradients (conv and BatchNorm
    backward, batch statistics) in f32 against JAX's flax backbone in f64
    (x64 enabled for this computation only) on a 128x128 batch: within 1e-4
    relative L2 per tensor, and closer to it than JAX's own f32 gradient
    (XLA's f32 CPU backward), which is why the whole-model comparison with
    jax.grad holds the backbone to a wider bound."""
    from rgrg_tpu.models.resnet import ResNetBackbone as JBackbone
    from rgrg_tpu_torch.core.convert import load_detector_
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 128, 128, 1))
    w = rng.normal(0, 1, (2, 4, 4, 2048))
    jb = JBackbone(stage_sizes=(1, 1, 1, 1))
    variables = jax.tree.map(np.asarray, jax.jit(lambda r: jb.init(
        r, jnp.zeros((1, 128, 128, 1)), train=False))(jax.random.PRNGKey(0)))
    def loss_fn(module, dtype):
        def loss(p):
            y, _ = module.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x, dtype), train=True, mutable=["batch_stats"])
            return jnp.sum(jnp.maximum(y, 0.1) * jnp.asarray(w, dtype))
        return loss
    with jax.enable_x64(True):
        jb64 = JBackbone(stage_sizes=(1, 1, 1, 1), dtype=jnp.float64)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            jax.jit(jax.grad(loss_fn(jb64, jnp.float64)))(p64))
    jax32 = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn(jb, jnp.float32)))(
        variables["params"]))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            from rgrg_tpu_torch.models.resnet import ResNetBackbone
            self.backbone = ResNetBackbone((1, 1, 1, 1))
    got, ref, j32 = Holder(), Holder(), Holder()
    load_detector_(got, {"params": {"backbone": variables["params"]},
                         "batch_stats": {"backbone": variables["batch_stats"]}})
    load_detector_(ref, {"params": {"backbone": want},
                         "batch_stats": {"backbone": variables["batch_stats"]}})
    got.train()
    y = got.backbone(torch.from_numpy(x.astype(np.float32)))
    (torch.clamp(y, min=0.1) * torch.from_numpy(w.astype(np.float32))).sum().backward()
    load_detector_(j32, {"params": {"backbone": jax32},
                         "batch_stats": {"backbone": variables["batch_stats"]}})
    ref_grads, j32_grads = dict(ref.named_parameters()), dict(j32.named_parameters())
    worst = max(_rel_l2(p.grad.numpy(), ref_grads[n].detach().numpy())
                for n, p in got.named_parameters())
    worst_jax = max(_rel_l2(j32_grads[n].detach().numpy(), ref_grads[n].detach().numpy())
                    for n in ref_grads)
    assert worst < 1e-4 and worst < worst_jax, (worst, worst_jax)


def test_trainable_partition_matches_jax(setup):
    """The frozen partition: the decoder's trainable leaves are JAX's
    (uk, uv, feature transform from stage 3), every detector parameter
    trains, BatchNorm statistics are buffers (never optimised)."""
    params = port_params(setup)
    jp = setup["jp"]
    for stage in (1, 2, 3):
        jmask = jtrainer.trainable_mask(jp, stage)
        mask = trainer.trainable_mask(params, stage)
        assert trainer.leaves(mask["decoder"]) == [bool(x) for x in
                                                    trainer.leaves(jmask["decoder"])]
        assert all(mask["detector"].values())
        n_det = len(jax.tree.leaves(jmask["detector"]["params"]))
        assert len(mask["detector"]) == n_det
        assert not any(jax.tree.leaves(jmask["detector"]["batch_stats"]))
    assert {n for n, _ in params["detector"].named_buffers()
            if n.endswith(("running_mean", "running_var"))} == {
        f"{m}.{s}" for m, mod in params["detector"].named_modules()
        if isinstance(mod, BatchNorm2d) for s in ("running_mean", "running_var")}


# ---------------------------------------------------------------- optimizer

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)
        self.bn = BatchNorm2d(3)


def _tiny_trees(seed):
    """A small {"detector", "decoder"} pair in both layouts: JAX arrays and
    the port's (a module with a Linear and a BatchNorm, and a decoder dict
    with a frozen and two trainable leaves)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    j = {"detector": {"params": {"fc": {"kernel": f(4, 3), "bias": f(3)},
                                 "bn": {"scale": f(3), "bias": f(3)}},
                      "batch_stats": {"bn": {"mean": f(3), "var": f(3)}}},
         "decoder": {"wte": {"embedding": f(5, 2)},
                     "h_0": {"attn": {"uk": {"kernel": f(2, 2), "bias": f(2)}}}}}
    return j


def _to_port(j):
    det = _Tiny()
    p = j["detector"]["params"]
    with torch.no_grad():
        det.fc.weight.copy_(torch.from_numpy(p["fc"]["kernel"]).T)
        det.fc.bias.copy_(torch.from_numpy(p["fc"]["bias"]))
        det.bn.weight.copy_(torch.from_numpy(p["bn"]["scale"]))
        det.bn.bias.copy_(torch.from_numpy(p["bn"]["bias"]))
        det.bn.running_mean.copy_(torch.from_numpy(j["detector"]["batch_stats"]["bn"]["mean"]))
        det.bn.running_var.copy_(torch.from_numpy(j["detector"]["batch_stats"]["bn"]["var"]))
    dec = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), j["decoder"])
    return {"detector": det, "decoder": dec}


def _set_grads(params, g):
    det = params["detector"]
    det.fc.weight.grad = torch.from_numpy(g["detector"]["params"]["fc"]["kernel"]).T.clone()
    det.fc.bias.grad = torch.from_numpy(g["detector"]["params"]["fc"]["bias"]).clone()
    det.bn.weight.grad = torch.from_numpy(g["detector"]["params"]["bn"]["scale"]).clone()
    det.bn.bias.grad = torch.from_numpy(g["detector"]["params"]["bn"]["bias"]).clone()
    uk = params["decoder"]["h_0"]["attn"]["uk"]
    uk["kernel"].grad = torch.from_numpy(g["decoder"]["h_0"]["attn"]["uk"]["kernel"]).clone()
    uk["bias"].grad = None   # no gradient reached it: counts as zero


@pytest.mark.parametrize("accumulation", [1, 4])
def test_optimizer_matches_optax(accumulation):
    """AdamW (lr 1e-3, weight decay 1e-2) against the JAX package's
    make_optimizer (optax adamw + set_to_zero partition + LR scale, wrapped in
    MultiSteps for accumulation 4): 2 updates with the LR scale set to 0.5
    before the second. Every parameter within 1e-6 absolute of optax's
    (the step is ~1e-3), the frozen leaf and the BN statistics bit-unchanged,
    and nothing moves before an accumulation completes."""
    tc = TC.TrainConfig(grad_accumulation_steps=accumulation)
    jtc = JC.TrainConfig(grad_accumulation_steps=accumulation)
    jp = _tiny_trees(0)
    params = _to_port(jp)
    wte0 = params["decoder"]["wte"]["embedding"].clone()
    stats0 = params["detector"].bn.running_var.clone()
    opt = trainer.make_optimizer(params, tc, stage=3, learning_rate=1e-3)
    jopt = jtrainer.make_optimizer(jp, jtc, stage=3, learning_rate=1e-3)
    jstate = jopt.init(jp)
    jparams = jp
    update = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    for i in range(2 * accumulation):
        if i == accumulation:
            jstate = jtrainer.set_lr_scale(jstate, 0.5)
            trainer.set_lr_scale(opt, 0.5)
        g = _tiny_trees(10 + i)
        g["decoder"]["h_0"]["attn"]["uk"]["bias"] = np.zeros(2, np.float32)
        u, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        _set_grads(params, g)
        stepped = opt.step()
        assert stepped == ((i + 1) % accumulation == 0)
        if not stepped:
            continue
        want = _to_port(jax.tree.map(np.asarray, jparams))
        for (name, p), (_, w) in zip(params["detector"].named_parameters(),
                                     want["detector"].named_parameters()):
            np.testing.assert_allclose(p.detach().numpy(), w.detach().numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(params["decoder"]["h_0"]["attn"]["uk"][k].detach().numpy(),
                                       want["decoder"]["h_0"]["attn"]["uk"][k].numpy(),
                                       rtol=0, atol=1e-6)
    assert trainer.get_lr_scale(opt) == 0.5 == jtrainer.get_lr_scale(jstate)
    assert torch.equal(params["decoder"]["wte"]["embedding"], wte0)
    assert torch.equal(params["detector"].bn.running_var, stats0)


# ---------------------------------------------------------------- loop

def test_warm_start_params():
    """Entries of init_params replace the fresh init (a detector module or
    its state dict; decoder tensors copied, not shared); absent ones keep
    it; an unknown entry raises."""
    _, tcfg = configs()
    model = RGRG(tcfg)
    fresh = model.init(0, device="cpu")
    other = model.init(1, device="cpu")
    out = loop.warm_start_params(fresh, {"detector": other["detector"]})
    assert torch.equal(out["detector"].dim_reduction.weight, other["detector"].dim_reduction.weight)
    assert out["decoder"] is fresh["decoder"]
    out = loop.warm_start_params(model.init(0, device="cpu"),
                                 {"decoder": other["decoder"],
                                  "detector": other["detector"].state_dict()})
    wte = out["decoder"]["wte"]["embedding"]
    assert torch.equal(wte, other["decoder"]["wte"]["embedding"])
    assert wte.data_ptr() != other["decoder"]["wte"]["embedding"].data_ptr()
    with pytest.raises(KeyError, match="not in model params"):
        loop.warm_start_params(fresh, {"decoderr": other["decoder"]})


def test_train_loop_end_to_end_checkpoint_and_resume(tmp_path):
    """loop.train on the CPU (box head 16 wide, so a checkpoint is ~0.6 GB):
    4 mini-steps with accumulation 2, a checkpoint at step 4, a validation
    function driving the best checkpoint, the scalars in metrics.jsonl; the
    checkpoint round trip is bit-exact (params, BN statistics, optimizer
    moments, step); a run cut at step 2 resumes there and runs to 4."""
    _, mcfg = configs(representation_size=16)
    cfg = TC.RGRGConfig(model=mcfg, train=TC.TrainConfig(grad_accumulation_steps=2))
    model = RGRG(mcfg)
    batches = [make_batch(SEED + i) for i in range(4)]
    seen = []

    def run(run_dir, max_steps, resume=None, val=None, every=None):
        def feed():
            for b in batches:
                seen.append(run_dir)
                yield b
        return loop.train(model, cfg, feed, str(run_dir), stage=3, lm_budget=LM_BUDGET,
                          max_steps=max_steps, checkpoint_every=every, resume_from=resume,
                          val_fn=val, evaluate_every=2, device="cpu")

    try:
        vals = iter([2.0, 1.0])
        full = run(tmp_path / "full", 4, every=4,
                   val=lambda s: {"total": next(vals), "loss_lm": 0.5})
        assert full.step == 4
        for name in ("last", "best", "step_4"):
            assert os.path.isfile(tmp_path / "full" / name / "train_state.pt"), name
        recs = [json.loads(line) for line in open(tmp_path / "full" / "metrics.jsonl")]
        assert [r["val/loss"] for r in recs if "val/loss" in r] == [2.0, 1.0]
        assert [r["val/loss_lm"] for r in recs if "val/loss_lm" in r] == [0.5, 0.5]
        assert any("train/epoch_seconds" in r for r in recs)
        assert open(tmp_path / "full" / "run_config.txt").read().startswith("RGRGConfig(")

        # bit-exact round trip of the saved state into a fresh one
        fresh = trainer.init_train_state(model, 5, cfg.train, stage=3, device="cpu")
        load_checkpoint(str(tmp_path / "full" / "last"), fresh)
        assert fresh.step == 4
        a, b = full.params["detector"].state_dict(), fresh.params["detector"].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(x, y) for x, y in zip(trainer.leaves(full.params["decoder"]),
                                                     trainer.leaves(fresh.params["decoder"])))
        sa, sb = full.opt_state.state_dict(), fresh.opt_state.state_dict()
        assert sa["mini_step"] == sb["mini_step"] == 0 and sa["scale"] == sb["scale"]
        for i, st in sa["adamw"]["state"].items():
            assert all(torch.equal(st[k], sb["adamw"]["state"][i][k]) for k in st)

        # a run cut at step 2, resumed: it starts at step 2 and runs 2 more
        seen.clear()
        run(tmp_path / "cut", 2)
        cut = trainer.init_train_state(model, 0, cfg.train, stage=3, device="cpu")
        load_checkpoint(str(tmp_path / "cut" / "last"), cut)
        assert cut.step == 2 and seen.count(tmp_path / "cut") == 2
        resumed = run(tmp_path / "resumed", 4, resume=str(tmp_path / "cut" / "last"))
        assert resumed.step == 4 and seen.count(tmp_path / "resumed") == 2
        moved = [not torch.equal(x, y) for x, y in zip(resumed.params["detector"].parameters(),
                                                       cut.params["detector"].parameters())]
        assert all(moved)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)   # checkpoints are large


def test_validation_losses_match_jax(setup, jax_losses):
    """validation_losses over two copies of the batch, each replaying JAX's
    draws: every loss and the total equal JAX's compute_losses(train=False)
    within TOL, and BatchNorm statistics stay as they were."""
    model = RGRG(setup["tcfg"])
    params = port_params(setup)
    stats = {k: v.clone() for k, v in params["detector"].named_buffers()}
    got = validation_losses(model, params, [setup["batch"]] * 2, 3, TC.TrainConfig(),
                            LM_BUDGET, rng=lambda: iter(setup["draws"][False]))
    want = jax_losses[False]
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(got["total"], float(want["loss_total"]), **TOL)
    assert all(torch.equal(v, stats[k]) for k, v in params["detector"].named_buffers())
