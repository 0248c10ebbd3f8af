"""The port's detector against the JAX package's, on converted weights.

JAX params come from `RGRG(cfg).init` with a shallow backbone (1,1,1,1),
pre_nms_top_n_test=32 and f32 compute, so the graph compiles in seconds;
core/convert.py carries them across. JAX runs its default f32 path (lax
tiled NMS, separable RoIAlign), the same math as kernels K1/K2, whose
plain versions the port runs on the CPU.

Discrete outputs (class_detected, selected_regions, top_idx, NMS keep) are
identical; boxes, scores, features and logits agree at rtol 1e-4 /
atol 1e-4 (convolutions and matmuls summed in a different order by each
library). The two libraries' f32 results differ by ~3e-6 on these maps,
and a random network has near-ties (two objectness scores 4e-6 apart): a
discrete decision on such a tie may go either way in either library, even
between runs of one library. So the test input is the first seeded image
batch on which every decision has a margin of at least ~10x that noise
(tests/torch_parity.py `decision_margins`).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.core import config as JC
from rgrg_tpu.models.detector import top1_per_class as j_top1
from rgrg_tpu.models.full_model import RGRG as JRGRG

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core.convert import from_jax_params, load_detector_
from rgrg_tpu_torch.models.detector import RegionDetector, top1_per_class
from rgrg_tpu_torch.models.full_model import RGRG

from tests.torch_parity import has_parity_margins

TOL = dict(rtol=1e-4, atol=1e-4)
STAGES = (1, 1, 1, 1)
def pick_images(det, make, tries=24):
    """First seed whose input `make(seed)` gives every decision its margin."""
    for seed in range(tries):
        images = make(seed)
        if has_parity_margins(det, torch.from_numpy(images)):
            return images
    raise AssertionError("no seeded input with decision margins")


def det_configs(budget=None):
    jdet = JC.DetectorConfig(
        backbone_stages=STAGES,
        rpn=JC.RPNConfig(pre_nms_top_n_test=32, post_nms_top_n_test=32),
        roi=JC.RoIConfig(inference_proposal_budget=budget))
    tdet = TC.DetectorConfig(
        backbone_stages=STAGES,
        rpn=TC.RPNConfig(pre_nms_top_n_test=32),
        roi=TC.RoIConfig(inference_proposal_budget=budget))
    return JC.ModelConfig(detector=jdet), TC.ModelConfig(detector=tdet)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = det_configs()
    jp = JRGRG(jcfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    images = pick_images(tp["detector"], lambda seed: np.random.default_rng(seed).normal(
        0, 1, (2, 512, 512, 1)).astype(np.float32))
    jdet = JRGRG(jcfg).detector
    jvars = jp["detector"]
    jfeats = jax.jit(lambda v, x: jdet.apply(v, x, method=jdet.backbone_features))(
        jvars, jnp.asarray(images))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, images=images, jdet=jdet,
                jvars=jvars, jfeats=np.array(jfeats))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL, err_msg=msg)


def test_converter_layouts(setup):
    det = setup["tp"]["detector"]
    jv = jax.tree.map(np.asarray, setup["jvars"])
    p, s = jv["params"], jv["batch_stats"]
    np.testing.assert_array_equal(det.backbone.conv1.weight.detach().numpy(),
                                  p["backbone"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(det.rpn_head.conv.bias.detach().numpy(),
                                  p["rpn_head"]["conv"]["bias"])
    np.testing.assert_array_equal(det.box_head.fc7.weight.detach().numpy(),
                                  p["box_head"]["fc7"]["kernel"].T)
    np.testing.assert_array_equal(det.box_head.fc6.kernel.detach().numpy(),
                                  p["box_head"]["fc6"]["kernel"])
    bn = det.backbone.layer1_0.downsample_bn
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  s["backbone"]["layer1_0"]["downsample_bn"]["var"])
    np.testing.assert_array_equal(bn.weight.detach().numpy(),
                                  p["backbone"]["layer1_0"]["downsample_bn"]["scale"])
    dec = setup["tp"]["decoder"]
    np.testing.assert_array_equal(dec["h_0"]["attn"]["c_attn"]["kernel"].numpy(),
                                  np.asarray(setup["jp"]["decoder"]["h_0"]["attn"]["c_attn"]["kernel"]))


def test_converter_rejects_unplaced_variables(setup):
    jv = jax.tree.map(np.asarray, setup["jvars"])
    extra = {"params": dict(jv["params"], stray={"kernel": np.zeros(3)}),
             "batch_stats": jv["batch_stats"]}
    with pytest.raises(ValueError, match="stray"):
        load_detector_(RegionDetector(setup["tcfg"].detector, device="cpu"), extra)


def test_backbone_c5_matches_jax(setup):
    got = setup["tp"]["detector"].backbone(torch.from_numpy(setup["images"]))
    assert tuple(got.shape) == (2, 16, 16, 2048)
    _close(got.detach().numpy(), setup["jfeats"])


def test_rpn_and_roi_heads_match_jax(setup):
    """From the same C5 map: NMS keep and top_idx identical, proposals,
    logits and pooled features close."""
    jdet, jvars, det = setup["jdet"], setup["jvars"], setup["tp"]["detector"]
    feats = setup["jfeats"]
    jboxes, jkeep, _ = jdet.apply(jvars, jnp.asarray(feats), method=jdet.rpn_proposals)
    with torch.no_grad():
        tboxes, tkeep = det.rpn_proposals(torch.from_numpy(feats))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    _close(tboxes.numpy(), jboxes)

    jout = jdet.apply(jvars, jnp.asarray(feats), jboxes, method=jdet.roi_forward)
    with torch.no_grad():
        tout = det.roi_forward(torch.from_numpy(feats), tboxes)
    for name, t, j in zip(("class_logits", "box_regression", "box_features"), tout, jout):
        _close(t.numpy(), j, name)

    jsel = jax.vmap(j_top1)(jout[0], jkeep)
    tsel = top1_per_class(tout[0], tkeep)
    np.testing.assert_array_equal(tsel["top_idx"].numpy(), np.asarray(jsel["top_idx"]))
    np.testing.assert_array_equal(tsel["class_detected"].numpy(),
                                  np.asarray(jsel["class_detected"]))
    _close(tsel["top_scores"].numpy(), jsel["top_scores"])


def _detect_both(setup, budget=None, image_chunk=None):
    jcfg, tcfg = det_configs(budget)
    want = jax.tree.map(np.asarray, JRGRG(jcfg).detect(setup["jp"],
                                                       jnp.asarray(setup["images"])))
    params = setup["tp"]
    if budget is not None:
        params = from_jax_params(jax.tree.map(np.asarray, setup["jp"]), tcfg, "cpu")
        with pytest.raises(ValueError, match="DetectorConfig"):
            RGRG(tcfg).detect(setup["tp"], torch.from_numpy(setup["images"]))
    got = RGRG(tcfg).detect(params, torch.from_numpy(setup["images"]),
                            image_chunk=image_chunk)
    return {k: v.numpy() for k, v in got.items()}, want


def _assert_detect_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype == bool:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            _close(got[k], want[k], k)


def test_roi_forward_runs_every_chunk_at_one_shape(setup, monkeypatch):
    """A short last chunk is padded to the chunk's size, so a proposal's
    outputs do not depend on how many proposals run with it (the GEMM
    library picks its algorithm by shape); the outputs stay those of one
    unchunked pass."""
    det = setup["tp"]["detector"]
    feats = torch.from_numpy(setup["jfeats"])
    with torch.no_grad():
        boxes, _ = det.rpn_proposals(feats)
        whole = det.roi_forward(feats, boxes)
        pool, shapes = det._pool, []
        monkeypatch.setattr(det, "_pool", lambda f, b: shapes.append(tuple(b.shape)) or pool(f, b))
        monkeypatch.setattr(det, "cfg", dataclasses.replace(
            det.cfg, roi=dataclasses.replace(det.cfg.roi, proposal_chunk=12)))
        chunked = det.roi_forward(feats, boxes)
    assert boxes.shape[1] == 32 and shapes == [(2, 12, 4)] * 3
    for got, want in zip(chunked, whole):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["full", "image_chunk", "proposal_budget"])
def test_detect_matches_jax(setup, variant):
    if variant == "proposal_budget":
        got, want = _detect_both(setup, budget=12)
    else:
        got, want = _detect_both(setup, image_chunk=1 if variant == "image_chunk" else None)
    _assert_detect_equal(got, want)
    assert want["class_detected"].any()


def test_region_features_from_boxes_match_jax(setup):
    jdet, jvars, det = setup["jdet"], setup["jvars"], setup["tp"]["detector"]
    bx = np.array([[[10, 10, 200, 200], [100, 100, 400, 300], [0, 0, 512, 512]]] * 2,
                  np.float32)
    want = jdet.apply(jvars, jnp.asarray(setup["jfeats"]), jnp.asarray(bx),
                      method=jdet.region_features_from_boxes)
    with torch.no_grad():
        got = det.region_features_from_boxes(torch.from_numpy(setup["jfeats"]),
                                             torch.from_numpy(bx))
    _close(got.numpy(), want)


def test_bf16_detector_runs_and_keeps_box_math_f32(setup):
    """bf16 compute: finite outputs of the right shapes, boxes in f32."""
    jcfg, tcfg = det_configs()
    cfg16 = dataclasses.replace(tcfg, detector=dataclasses.replace(tcfg.detector,
                                                                   dtype="bfloat16"))
    params = from_jax_params(jax.tree.map(np.asarray, setup["jp"]), cfg16, "cpu")
    out = RGRG(cfg16).detect(params, torch.from_numpy(setup["images"][:1]))
    assert out["region_features"].dtype == torch.bfloat16
    assert out["top_region_boxes"].dtype == torch.float32
    assert out["selection_logits"].dtype == torch.float32
    assert torch.isfinite(out["top_region_boxes"]).all()
    assert tuple(out["region_features"].shape) == (1, 29, 1024)


def _within_ulps(got, want, ulps, msg):
    """max |got - want| <= `ulps` bf16 ulps (2^-7 relative) of want's
    largest magnitude: both compute in bf16, rounding at other places."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert err <= ulps * ulp, f"{msg}: max abs err {err} > {ulps} x {ulp}"


def test_bf16_detector_stages_match_jax(setup):
    """bf16 compute in both packages, stage by stage. The backbone's C5
    from the same image agrees within 4 bf16 ulps of its largest magnitude
    (measured: max abs 0.031 at magnitudes up to 3.9, mean abs 1.8e-3). From
    JAX's bf16 C5 (with a bf16 detector JAX pools through its "fused"
    RoIAlign, the port through K2's plain version): NMS keep masks are
    identical, proposals close in f32, and roi_forward's class logits, box
    regression and box features within 2 bf16 ulps (measured <= 1.1e-2 at
    magnitudes up to 3.1). End-to-end decisions (class_detected, the
    selections) are not compared: the input's margins were chosen for f32
    noise, and bf16 noise flips near-ties between the two libraries."""
    jcfg, tcfg = det_configs()
    j16 = dataclasses.replace(jcfg, detector=dataclasses.replace(jcfg.detector,
                                                                 dtype="bfloat16"))
    t16 = dataclasses.replace(tcfg, detector=dataclasses.replace(tcfg.detector,
                                                                 dtype="bfloat16"))
    jdet, jvars = JRGRG(j16).detector, setup["jvars"]
    det = from_jax_params(jax.tree.map(np.asarray, setup["jp"]), t16, "cpu")["detector"]
    jfeats = jax.jit(lambda v, x: jdet.apply(v, x, method=jdet.backbone_features))(
        jvars, jnp.asarray(setup["images"]))
    jc5 = np.array(jfeats.astype(jnp.float32))
    with torch.no_grad():
        c5 = det.backbone(torch.from_numpy(setup["images"]))
    assert c5.dtype == torch.bfloat16 and jfeats.dtype == jnp.bfloat16
    _within_ulps(c5.float().numpy(), jc5, 4, "C5")
    assert np.abs(c5.float().numpy() - jc5).mean() <= 2.0 ** -8

    feats = torch.from_numpy(jc5).to(torch.bfloat16)   # exact: jc5 holds bf16 values
    jboxes, jkeep, _ = jdet.apply(jvars, jfeats, method=jdet.rpn_proposals)
    with torch.no_grad():
        boxes, keep = det.rpn_proposals(feats)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(boxes.numpy(), jboxes)
    jout = jdet.apply(jvars, jfeats, jboxes, method=jdet.roi_forward)
    with torch.no_grad():
        out = det.roi_forward(feats, torch.from_numpy(np.asarray(jboxes)))
    for name, t, j in zip(("class_logits", "box_regression", "box_features"), out, jout):
        _within_ulps(t.float().numpy(), np.asarray(j.astype(jnp.float32)), 2, name)
