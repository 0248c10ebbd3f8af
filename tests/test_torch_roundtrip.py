"""Synthetic full .pt -> product entry point -> generate, in one test.

Builds a complete reference-convention torch checkpoint file covering all
four weight quirks AT ONCE — (1) the torchvision rpn conv rename
("rpn.head.conv.0.0.*", reference workaround train_full_model.py:290-293),
(2) HF Conv1D [in, out] kernel layout (language_model.py:11-29), (3) a
uniform nn.DataParallel "module." prefix (the convention the reference's
CheXbert weights use, evaluate_language_model.py:166-174), and (4) the
wte-positional-embedding quirk (language_model.py:307 — a config flag on
our side, asserted on here so the converted tree is actually consumed
through the quirk path) — loads it through the PRODUCT entry point
(`ReportGenerator.from_torch_checkpoint`, rgrg_tpu/inference.py) and
generates, pinning report-for-report identity against a generator built
directly from the source params. Any layout/transpose/rename mistake in
the converter changes tokens, so identity IS the conversion proof.

The synthetic state dict is produced by inverse-converting our own params
tree into torch conventions (conv HWIO->OIHW, Linear [in,out]->[out,in],
fc6 spatial-major -> channel-major flatten, HF Conv1D kept [in,out],
Sequential backbone child indices) — the exact inverse of
rgrg_tpu/core/torch_convert.py.
"""

import json

import numpy as np
import cv2
import jax
import pytest

torch = pytest.importorskip("torch")

from rgrg_tpu.inference import ReportGenerator
from rgrg_tpu.models.full_model import RGRG
from rgrg_tpu.text.tokenizer import GPT2Tokenizer

from tests.test_full_model import SMOKE_CFG


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _conv_inv(dst, key, p):
    """flax conv {kernel HWIO, bias?} -> torch {key}.weight OIHW (+bias)."""
    dst[f"{key}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        dst[f"{key}.bias"] = _t(p["bias"])


def _linear_inv(dst, key, p):
    dst[f"{key}.weight"] = _t(np.transpose(p["kernel"], (1, 0)))
    dst[f"{key}.bias"] = _t(p["bias"])


def _conv1d_inv(dst, key, p):
    """HF Conv1D stores [in, out] — our layout, no transpose."""
    dst[f"{key}.weight"] = _t(p["kernel"])
    dst[f"{key}.bias"] = _t(p["bias"])


def _ln_inv(dst, key, p):
    dst[f"{key}.weight"] = _t(p["scale"])
    dst[f"{key}.bias"] = _t(p["bias"])


def _bn_inv(dst, key, p, s):
    dst[f"{key}.weight"] = _t(p["scale"])
    dst[f"{key}.bias"] = _t(p["bias"])
    dst[f"{key}.running_mean"] = _t(s["mean"])
    dst[f"{key}.running_var"] = _t(s["var"])
    dst[f"{key}.num_batches_tracked"] = torch.tensor(7)


def _fc6_inv(p):
    """our fc6 kernel [P*P*C, out] (spatial-major NHWC flatten) ->
    torch fc6.weight [out, C*P*P] (channel-major NCHW flatten)."""
    k = np.asarray(p["kernel"])  # [8*8*2048, 1024]
    out_dim = k.shape[1]
    w = np.transpose(k, (1, 0)).reshape(out_dim, 8, 8, 2048)
    return _t(np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, 2048 * 8 * 8))


def _mlp_inv(dst, prefix, p):
    """classifier MLP fc0/fc1/fc2 -> nn.Sequential indices 0/2/4."""
    for i, name in ((0, "fc0"), (2, "fc1"), (4, "fc2")):
        _linear_inv(dst, f"{prefix}.classifier.{i}", p[name])


def build_reference_state_dict(params, stages=(3, 4, 6, 3)):
    """Our params tree -> reference-named torch state dict (see module
    docstring for the conventions exercised); `stages`: the backbone's
    bottleneck blocks per stage."""
    sd = {}
    det = params["detector"]["params"]
    stats = params["detector"]["batch_stats"]

    # backbone: reference wraps resnet children in nn.Sequential
    # (object_detector.py:58): 0=conv1, 1=bn1, 4..7=layer1..4
    bb, bs = det["backbone"], stats["backbone"]
    _conv_inv(sd, "object_detector.backbone.0", bb["conv1"])
    _bn_inv(sd, "object_detector.backbone.1", bb["bn1"], bs["bn1"])
    for stage, blocks in enumerate(stages, start=1):
        for b in range(blocks):
            src, ssrc = bb[f"layer{stage}_{b}"], bs[f"layer{stage}_{b}"]
            t = f"object_detector.backbone.{3 + stage}.{b}"
            for i in (1, 2, 3):
                _conv_inv(sd, f"{t}.conv{i}", src[f"conv{i}"])
                _bn_inv(sd, f"{t}.bn{i}", src[f"bn{i}"], ssrc[f"bn{i}"])
            if "downsample_conv" in src:
                _conv_inv(sd, f"{t}.downsample.0", src["downsample_conv"])
                _bn_inv(sd, f"{t}.downsample.1", src["downsample_bn"],
                        ssrc["downsample_bn"])

    # quirk (1): the NEW torchvision rpn conv name
    _conv_inv(sd, "object_detector.rpn.head.conv.0.0", det["rpn_head"]["conv"])
    _conv_inv(sd, "object_detector.rpn.head.cls_logits",
              det["rpn_head"]["cls_logits"])
    _conv_inv(sd, "object_detector.rpn.head.bbox_pred",
              det["rpn_head"]["bbox_pred"])

    sd["object_detector.roi_heads.box_head.fc6.weight"] = _fc6_inv(
        det["box_head"]["fc6"])
    sd["object_detector.roi_heads.box_head.fc6.bias"] = _t(
        det["box_head"]["fc6"]["bias"])
    _linear_inv(sd, "object_detector.roi_heads.box_head.fc7",
                det["box_head"]["fc7"])
    _linear_inv(sd, "object_detector.roi_heads.box_predictor.cls_score",
                det["box_predictor"]["cls_score"])
    _linear_inv(sd, "object_detector.roi_heads.box_predictor.bbox_pred",
                det["box_predictor"]["bbox_pred"])
    _linear_inv(sd, "object_detector.roi_heads.dim_reduction",
                det["dim_reduction"])

    _mlp_inv(sd, "binary_classifier_region_selection",
             det["selection_classifier"])
    _mlp_inv(sd, "binary_classifier_region_abnormal",
             det["abnormal_classifier"])

    # language model: canonical gpt_with_lm_head.transformer.* hierarchy
    dec = params["decoder"]
    lm = "language_model.gpt_with_lm_head.transformer"
    sd[f"{lm}.wte.weight"] = _t(dec["wte"]["embedding"])
    sd[f"{lm}.wpe.weight"] = _t(dec["wpe"]["embedding"])
    _ln_inv(sd, f"{lm}.ln_f", dec["ln_f"])
    n_layers = len([k for k in dec if k.startswith("h_")])
    for i in range(n_layers):
        blk = dec[f"h_{i}"]
        h = f"{lm}.h.{i}"
        _ln_inv(sd, f"{h}.ln_1", blk["ln_1"])
        _ln_inv(sd, f"{h}.ln_2", blk["ln_2"])
        # quirk (2): HF Conv1D [in, out] layout, no transpose
        _conv1d_inv(sd, f"{h}.attn.c_attn", blk["attn"]["c_attn"])
        _conv1d_inv(sd, f"{h}.attn.c_proj", blk["attn"]["c_proj"])
        _linear_inv(sd, f"{h}.attn.uk", blk["attn"]["uk"])
        _linear_inv(sd, f"{h}.attn.uv", blk["attn"]["uv"])
        _conv1d_inv(sd, f"{h}.mlp.c_fc", blk["mlp"]["c_fc"])
        _conv1d_inv(sd, f"{h}.mlp.c_proj", blk["mlp"]["c_proj"])
    ft = dec["feature_transform"]
    _linear_inv(sd, "language_model.feature_space_transformation_nn.0",
                ft["fc0"])
    _linear_inv(sd, "language_model.feature_space_transformation_nn.2",
                ft["fc1"])

    # quirk (3): uniform DataParallel prefix on EVERY key
    return {f"module.{k}": v for k, v in sd.items()}


def _write_tokenizer_dir(tmp_path):
    """vocab.json/merges.txt reproducing GPT2Tokenizer.dummy() via from_dir."""
    tok = GPT2Tokenizer.dummy()
    d = tmp_path / "tok"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(tok.encoder), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    return str(d)


def test_synthetic_pt_through_product_entry_point(tmp_path):
    # quirk (4): the checkpoint-baked wte-position lookup must be ON for
    # the SMOKE config, or this test would not exercise the quirk path
    assert SMOKE_CFG.decoder.positions_from_wte

    model = RGRG(cfg=SMOKE_CFG)
    truth = model.init(jax.random.PRNGKey(3))
    sd = build_reference_state_dict(truth)
    ckpt_path = str(tmp_path / "full_model.pt")
    # the reference saves {"model": sd, "optimizer": ..., ...}
    # (evaluate_model.py:576-591); extra entries must be ignored
    torch.save({"model": sd, "current_epoch": 3, "overall_steps_taken": 9,
                "lowest_val_loss": 1.25}, ckpt_path)
    tok_dir = _write_tokenizer_dir(tmp_path)

    gen = ReportGenerator.from_torch_checkpoint(
        ckpt_path, tok_dir, cfg=SMOKE_CFG, similarity_fn=None)

    # converted tree must be numerically identical to the source tree
    flat_a = jax.tree_util.tree_leaves_with_path(truth)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(gen.params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_b[path]),
                                      err_msg=jax.tree_util.keystr(path))

    img_path = str(tmp_path / "cxr.png")
    img = np.random.default_rng(0).uniform(0, 255, (700, 600)).astype(np.uint8)
    cv2.imwrite(img_path, img)

    reps = gen.generate_reports([img_path], num_beams=1, max_length=6)
    ref_gen = ReportGenerator(truth, GPT2Tokenizer.dummy(), cfg=SMOKE_CFG,
                              similarity_fn=None)
    ref_reps = ref_gen.generate_reports([img_path], num_beams=1, max_length=6)
    assert len(reps) == 1
    assert reps[0].report == ref_reps[0].report
    assert reps[0].region_sentences == ref_reps[0].region_sentences
    np.testing.assert_array_equal(reps[0].selected_regions,
                                  ref_reps[0].selected_regions)
