"""The port's training building blocks against the JAX package on the CPU:
box IoU and encoding, the anchor matcher (low-quality restore included),
balanced sampling fed JAX's own uniform draws, the losses, BatchNorm in
train and eval mode, RoIAlign's feature gradient, the plateau scheduler,
and the kernels without a backward refusing a graph.

torch cannot replay jax.random, so every sampling draw of the port goes
through train/assign.uniform, which here replays the arrays JAX draws, in
the port's call order (`jax_draws`). Tolerances are stated per test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from rgrg_tpu.core import config as JC
from rgrg_tpu.ops import boxes as j_boxes
from rgrg_tpu.ops.roi_align import roi_align as j_roi_align
from rgrg_tpu.train import assign as j_assign
from rgrg_tpu.train import losses as JL
from rgrg_tpu.train.loop import PlateauScheduler as JPlateau

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.layers import BatchNorm2d
from rgrg_tpu_torch.ops import anchors, boxes
from rgrg_tpu_torch.ops.beam_attn import beam_attention
from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
from rgrg_tpu_torch.ops.roi_align import (RoIAlign, roi_align, roi_align_feature_grad,
                                          roi_align_plain)
from rgrg_tpu_torch.train import assign
from rgrg_tpu_torch.train import losses as L
from rgrg_tpu_torch.train.loop import PlateauScheduler

from tests.test_torch_beam import _attn_case
from tests.test_torch_kernels import random_boxes

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_draws(rng_det, b, n_anchors, n_pool):
    """The uniform draws of JAX's `train_forward(rng_det)` (RPN loss, then
    RoI sampling; per image a positive and a negative key) stacked in the
    port's call order: RPN positives [B, N], RPN negatives, RoI positives
    [B, K+G], RoI negatives."""
    r_rpn, r_roi = jax.random.split(rng_det)
    out = []
    for r, n in ((r_rpn, n_anchors), (r_roi, n_pool)):
        pairs = [jax.random.split(k) for k in jax.random.split(r, b)]
        for j in (0, 1):
            out.append(np.stack([np.asarray(jax.random.uniform(p[j], (n,))) for p in pairs]))
    return out


def gt_batch(seed, b=2, g=29, extent=512.0):
    rng = np.random.default_rng(seed)
    gt = np.stack([random_boxes(g, extent=extent, min_size=8.0, rng=rng) for _ in range(b)])
    valid = rng.uniform(size=(b, g)) < 0.85
    return gt, valid


# ---------------------------------------------------------------- box math

def test_box_iou_and_encode_match_jax():
    """IoU bit-identical (the matcher compares IoUs for equality); the
    encoded targets within 1e-6 relative (log may differ by an ulp)."""
    rng = np.random.default_rng(0)
    a, p = random_boxes(40, rng=rng), random_boxes(300, rng=rng)
    got = boxes.box_iou(torch.from_numpy(a), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_boxes.box_iou(jnp.asarray(a), jnp.asarray(p))))
    np.testing.assert_array_equal(boxes.box_area(torch.from_numpy(a)).numpy(),
                                  np.asarray(j_boxes.box_area(jnp.asarray(a))))
    ref = random_boxes(300, rng=rng)
    w = (10.0, 10.0, 5.0, 5.0)
    np.testing.assert_allclose(
        boxes.encode_boxes(torch.from_numpy(ref), torch.from_numpy(p), w).numpy(),
        np.asarray(j_boxes.encode_boxes(jnp.asarray(ref), jnp.asarray(p), w)),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- matching

@pytest.mark.parametrize("high,low,low_quality", [(0.7, 0.3, True), (0.5, 0.5, False)])
def test_match_anchors_identical_to_jax(high, low, low_quality):
    gt, valid = gt_batch(1)
    anc = anchors.grid_anchors(TC.AnchorConfig())[::7]
    got = assign.match_anchors(torch.from_numpy(gt), torch.from_numpy(valid),
                               torch.from_numpy(anc), high, low, low_quality)
    for i in range(gt.shape[0]):
        want = j_assign.match_anchors(jnp.asarray(gt[i]), jnp.asarray(valid[i]),
                                      jnp.asarray(anc), high, low, low_quality)
        np.testing.assert_array_equal(got.matched_idx[i].numpy(), np.asarray(want.matched_idx))
        np.testing.assert_array_equal(got.matched_vals[i].numpy(),
                                      np.asarray(want.matched_vals))


def test_low_quality_restore_gives_the_original_match():
    """Anchor 0 is gt 1's best (IoU 0.16) but overlaps gt 0 more (0.25,
    below low): the restore gives it back its ORIGINAL match, gt 0, not the
    tying gt 1, as torchvision (and JAX) do; anchor 1 matches gt 0 at 0.9;
    the far anchor stays background. The invalid gt 2 (a copy of anchor 2)
    never matches."""
    gt = np.array([[[0, 0, 100, 100], [0, 0, 20, 20], [300, 300, 310, 310]]], np.float32)
    valid = np.array([[True, True, False]])
    anc = np.array([[0, 0, 50, 50], [0, 0, 100, 90], [300, 300, 310, 310]], np.float32)
    got = assign.match_anchors(torch.from_numpy(gt), torch.from_numpy(valid),
                               torch.from_numpy(anc), 0.7, 0.3, True)
    want = j_assign.match_anchors(jnp.asarray(gt[0]), jnp.asarray(valid[0]),
                                  jnp.asarray(anc), 0.7, 0.3, True)
    np.testing.assert_array_equal(got.matched_idx[0].numpy(), np.asarray(want.matched_idx))
    assert got.matched_idx[0].tolist() == [0, 0, assign.BELOW_LOW]


# ---------------------------------------------------------------- sampling

def test_uniform_replays_and_draws():
    keys = [np.full((2, 3), 0.25, np.float32)]
    np.testing.assert_array_equal(assign.uniform(iter(keys), (2, 3), torch.device("cpu")),
                                  keys[0])
    with pytest.raises(ValueError, match="shape"):
        assign.uniform(iter(keys), (3, 2), torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    u = assign.uniform(g, (1000,), torch.device("cpu"))
    assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0


@pytest.mark.parametrize("n_pos,n_neg", [(30, 470), (600, 400), (0, 50)])
def test_sample_pos_neg_identical_with_jax_keys(n_pos, n_neg):
    """The same masks as JAX's sampler when fed JAX's own uniform keys."""
    labels = np.full((2, 1000), -1.0, np.float32)
    rng = np.random.default_rng(n_pos)
    for i in range(2):
        perm = rng.permutation(1000)
        labels[i, perm[:n_pos]] = 1.0
        labels[i, perm[n_pos:n_pos + n_neg]] = 0.0
    rngs = [jax.random.PRNGKey(7 + i) for i in range(2)]
    pairs = [jax.random.split(r) for r in rngs]
    draws = [np.stack([np.asarray(jax.random.uniform(p[j], (1000,))) for p in pairs])
             for j in (0, 1)]
    pos, neg = assign.sample_pos_neg(iter(draws), torch.from_numpy(labels), 256, 0.5)
    for i in range(2):
        jpos, jneg = j_assign.sample_pos_neg(rngs[i], jnp.asarray(labels[i]), 256, 0.5)
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(jneg))
    assert int(pos[0].sum()) == min(n_pos, 128)
    assert int(neg[0].sum()) == min(n_neg, 256 - min(n_pos, 128))


# ---------------------------------------------------------------- losses

def test_loss_formulas_match_jax():
    """smooth_l1, weighted BCE, masked_mean and the classifier loss within
    1e-5."""
    rng = np.random.default_rng(2)
    a, b = (rng.normal(0, 1, (3, 40)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(L.smooth_l1(torch.from_numpy(a), torch.from_numpy(b), 1 / 9).numpy(),
                               np.asarray(JL.smooth_l1(jnp.asarray(a), jnp.asarray(b), 1 / 9)),
                               **LOSS_TOL)
    x = rng.normal(0, 8, (2, 29)).astype(np.float32)   # saturating logits too
    y = (rng.uniform(size=(2, 29)) > 0.6).astype(np.float32)
    det = rng.uniform(size=(2, 29)) > 0.3
    np.testing.assert_allclose(
        L.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y), 2.2).numpy(),
        np.asarray(JL.bce_with_logits(jnp.asarray(x), jnp.asarray(y), 2.2)), **LOSS_TOL)
    np.testing.assert_allclose(
        float(L.masked_mean(torch.from_numpy(a), torch.from_numpy(a > 0))),
        float(JL.masked_mean(jnp.asarray(a), jnp.asarray(a > 0))), **LOSS_TOL)
    np.testing.assert_allclose(
        float(L.classifier_loss(torch.from_numpy(x), torch.from_numpy(y > 0),
                                torch.from_numpy(det), 6.0)),
        float(JL.classifier_loss(jnp.asarray(x), jnp.asarray(y > 0), jnp.asarray(det), 6.0)),
        **LOSS_TOL)
    assert float(L.masked_mean(torch.from_numpy(a), torch.zeros(3, 40, dtype=torch.bool))) == 0.0


def small_det(rpn_batch=64, roi_batch=32):
    return (JC.DetectorConfig(rpn=JC.RPNConfig(batch_size_per_image=rpn_batch),
                              roi=JC.RoIConfig(batch_size_per_image=roi_batch)),
            TC.DetectorConfig(rpn=TC.RPNConfig(batch_size_per_image=rpn_batch),
                              roi=TC.RoIConfig(batch_size_per_image=roi_batch)))


def test_rpn_loss_matches_jax():
    """The RPN loss over every anchor of the 16x16 grid, with JAX's keys:
    within 1e-5."""
    jcfg, tcfg = small_det()
    gt, valid = gt_batch(3)
    anc = anchors.grid_anchors(tcfg.anchors)
    rng = np.random.default_rng(3)
    obj = rng.normal(0, 2, (2, anc.shape[0])).astype(np.float32)
    deltas = rng.normal(0, 0.5, (2, anc.shape[0], 4)).astype(np.float32)
    r = jax.random.PRNGKey(5)
    want = JL.rpn_loss(r, jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(anc),
                       jnp.asarray(gt), jnp.asarray(valid), jcfg)
    # rpn_loss's own per-image keys (jax_draws starts one split earlier)
    pairs = [jax.random.split(k) for k in jax.random.split(r, 2)]
    draws = [np.stack([np.asarray(jax.random.uniform(p[j], (anc.shape[0],))) for p in pairs])
             for j in (0, 1)]
    got = L.rpn_loss(iter(draws), torch.from_numpy(obj), torch.from_numpy(deltas),
                     torch.from_numpy(anc), torch.from_numpy(gt), torch.from_numpy(valid), tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL, err_msg=k)


def roi_case(seed, k=120):
    """Proposals scattered around the gt boxes (so some match at 0.5), a
    keep mask with holes, and the gts."""
    gt, valid = gt_batch(seed)
    rng = np.random.default_rng(seed + 100)
    pick = rng.integers(0, gt.shape[1], (2, k))
    base = np.take_along_axis(gt, pick[..., None], 1)
    props = (base + rng.normal(0, 12, base.shape)).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 2.0)
    keep = rng.uniform(size=(2, k)) < 0.8
    labels = np.tile(np.arange(1, 30, dtype=np.int64), (2, 1))
    return props, keep, gt, labels, valid


def test_select_training_samples_and_fastrcnn_loss_match_jax():
    """Sampled rows, labels and masks identical to JAX with its keys;
    regression targets and both RoI losses within 1e-5."""
    jcfg, tcfg = small_det()
    props, keep, gt, labels, valid = roi_case(4)
    r = jax.random.PRNGKey(9)
    want = JL.select_training_samples(r, jnp.asarray(props), jnp.asarray(keep), jnp.asarray(gt),
                                      jnp.asarray(labels), jnp.asarray(valid), jcfg)
    n_pool = props.shape[1] + gt.shape[1]
    pairs = [jax.random.split(k) for k in jax.random.split(r, 2)]
    draws = [np.stack([np.asarray(jax.random.uniform(p[j], (n_pool,))) for p in pairs])
             for j in (0, 1)]
    got = L.select_training_samples(iter(draws), torch.from_numpy(props), torch.from_numpy(keep),
                                    torch.from_numpy(gt), torch.from_numpy(labels),
                                    torch.from_numpy(valid), tcfg)
    for name in ("proposals", "labels", "sampled", "pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.pos.sum()) > 0 and bool(got.sampled.all())
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets),
                               rtol=1e-5, atol=1e-5)

    rng = np.random.default_rng(5)
    s = got.labels.shape[1]
    cls = rng.normal(0, 2, (2, s, 30)).astype(np.float32)
    reg = rng.normal(0, 1, (2, s, 120)).astype(np.float32)
    jl = JL.fastrcnn_loss(jnp.asarray(cls), jnp.asarray(reg), want)
    tl = L.fastrcnn_loss(torch.from_numpy(cls), torch.from_numpy(reg), got)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), **LOSS_TOL, err_msg=k)


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    """Train mode against flax.linen.BatchNorm(momentum 0.9, eps 1e-5,
    use_running_average=False): the output and the new running statistics
    within 1e-5 (f32; bf16 input: the output within one bf16 ulp, the
    statistics, computed in f32 from the bf16 values, within 1e-5)."""
    rng = np.random.default_rng(6)
    x = (rng.normal(0.7, 2.0, (4, 8, 8, 5))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.3, 5).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 5).astype(np.float32)
    var0 = rng.uniform(0.8, 1.2, 5).astype(np.float32)
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jx = jnp.asarray(x).astype(jdt)
    y, mutated = bn.apply(variables, jx, mutable=["batch_stats"])

    m = BatchNorm2d(5)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    m.train()
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    got = m(tx).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(y.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), rtol=1e-5, atol=1e-5)


def test_batchnorm_eval_mode_bit_identical_and_train_gradient():
    """Eval mode keeps the frozen arithmetic bit for bit,
    ((x - mean) * (rsqrt(var + eps) * scale) + bias) in f32, cast back, and
    leaves the statistics alone; train mode passes a gradient to its input
    and its scale and bias."""
    rng = np.random.default_rng(7)
    m = BatchNorm2d(6).eval()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)))
        m.running_mean.copy_(torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
    stats = (m.running_mean.clone(), m.running_var.clone())
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(0, 3, (2, 6, 5, 5)).astype(np.float32)).to(dt)
        mul = torch.rsqrt(m.running_var + m.eps) * m.weight
        want = ((x.to(torch.float32) - m.running_mean[:, None, None]) * mul[:, None, None]
                + m.bias[:, None, None]).to(dt)
        assert torch.equal(m(x), want)
    assert torch.equal(m.running_mean, stats[0]) and torch.equal(m.running_var, stats[1])
    x = torch.randn(3, 6, 4, 4, requires_grad=True)
    m.train()(x).square().sum().backward()
    assert x.grad.abs().sum() > 0 and m.weight.grad is not None and m.bias.grad is not None


# ---------------------------------------------------------------- RoIAlign gradient

def test_roi_align_feature_grad_matches_jax_grad():
    """The feature gradient of a loss through the port's roi_align (the
    autograd.Function, backward = the fused transposed product) against
    jax.grad of JAX's roi_align, f32, within 1e-5 (relative to the
    gradient's scale)."""
    rng = np.random.default_rng(8)
    feats = rng.normal(0, 1, (2, 16, 16, 24)).astype(np.float32)
    bx = np.stack([random_boxes(40, rng=rng) for _ in range(2)])
    bx[:, :3] = [[0, 0, 512, 512], [-40, -20, 100, 60], [500, 500, 530, 600]]
    w = rng.normal(0, 1, (2, 40, 8, 8, 24)).astype(np.float32)

    def jloss(f):
        out = jax.vmap(lambda fi, bi: j_roi_align(fi, bi))(f, jnp.asarray(bx))
        return jnp.sum(out * jnp.asarray(w))
    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(feats)))

    tf = torch.from_numpy(feats).requires_grad_(True)
    (roi_align(tf, torch.from_numpy(bx)) * torch.from_numpy(w)).sum().backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(tf.grad.numpy() / scale, want / scale, rtol=0, atol=1e-5)
    direct = roi_align_feature_grad(torch.from_numpy(w), torch.from_numpy(bx), 16, 16)
    assert torch.equal(direct, tf.grad)


def test_roi_align_gradcheck_f64_and_boxes_get_no_gradient():
    """torch.autograd.gradcheck in f64 on a tiny map through the CPU route;
    boxes that require grad are refused; the output is differentiable and
    the gradient reaches the features (the graph is not cut)."""
    rng = np.random.default_rng(9)
    f = torch.from_numpy(rng.normal(0, 1, (2, 5, 6, 3))).requires_grad_(True)
    bx = torch.from_numpy(np.array([[[1, 2, 70, 60], [-10, 0, 30, 200], [80, 90, 95, 99]],
                                     [[0, 0, 192, 160], [5, 5, 6, 6], [40, 10, 120, 150]]],
                                    np.float32))
    kw = dict(output_size=3, spatial_scale=1.0 / 16.0, sampling_ratio=2)
    assert torch.autograd.gradcheck(
        lambda t: RoIAlign.apply(t, bx, kw["output_size"], kw["spatial_scale"],
                                 kw["sampling_ratio"]), (f,), eps=1e-6, atol=1e-8)
    out = roi_align(f, bx, **kw)
    assert out.grad_fn is not None and out.dtype == torch.float64
    torch.testing.assert_close(out.detach(), roi_align_plain(f.detach(), bx, **kw))
    out.sum().backward()
    assert f.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="no gradient to its boxes"):
        roi_align(f, bx.clone().requires_grad_(True), **kw)


# ---------------------------------------------------------------- no backward

def test_beam_attention_and_dense_wint8_refuse_a_graph():
    """K3 and K4 have no backward: with grad enabled and an input that
    requires grad they raise (on the CPU route too) instead of returning a
    result cut off from the graph; under no_grad they run."""
    q, k, v, anc, slot = _attn_case(5, 4, 2)
    tq, tk, tv, tanc = (torch.from_numpy(a) for a in (q, k, v, anc))
    with pytest.raises(RuntimeError, match="no backward"):
        beam_attention(tq.clone().requires_grad_(True), tk, tv, tanc, slot, scale=0.3)
    with torch.no_grad():
        beam_attention(tq.clone().requires_grad_(True), tk, tv, tanc, slot, scale=0.3)
    x = torch.randn(3, 8, requires_grad=True)
    qw = torch.randint(-127, 128, (8, 4), dtype=torch.int8)
    s = torch.rand(1, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        dense_wint8(x, qw, s, torch.zeros(4))
    with torch.no_grad():
        assert dense_wint8(x, qw, s, torch.zeros(4)).shape == (3, 4)
    # a frozen int8 decoder under a graph-building caller raises too
    params = gpt2.quantize_decoder_weights(
        {"h_0": {"attn": {"c_attn": {"kernel": torch.randn(8, 4), "bias": torch.zeros(4)},
                          "c_proj": {"kernel": torch.randn(4, 4), "bias": torch.zeros(4)}},
                 "mlp": {"c_fc": {"kernel": torch.randn(4, 4), "bias": torch.zeros(4)},
                         "c_proj": {"kernel": torch.randn(4, 4), "bias": torch.zeros(4)}}}},
        layout="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        gpt2._dense(x, params["h_0"]["attn"]["c_attn"])


# ---------------------------------------------------------------- scheduler

def test_plateau_scheduler_identical_to_jax():
    vals = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.7, 0.7, 0.7,
            0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.69999, 0.5]
    kw = dict(factor=0.5, patience=2, threshold=1e-3, cooldown=3)
    got, want = PlateauScheduler(**kw), JPlateau(**kw)
    assert [got.update(v) for v in vals] == [want.update(v) for v in vals]
    assert got.scale < 1.0 and got == PlateauScheduler(**{**kw, **{
        f: getattr(want, f) for f in ("best", "bad_count", "cooldown_counter", "scale")}})
