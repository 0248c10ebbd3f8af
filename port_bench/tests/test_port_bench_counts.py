"""The yardstick's arithmetic against values worked out by hand."""

from __future__ import annotations

import pytest
import torch

from port_bench.counts import k3, serve
from port_bench.run import BENCH, device_union, load_json, load_module

CFG = load_json(BENCH, "configs", "rgrg-serve-bf16.json")


def test_resnet_flops_by_hand():
    # 64 px input, one bottleneck a stage: conv1 6,422,528; stage 1
    # 37,748,736; stages 2-4 60,817,408 each (1x1 reduce at the input's
    # size, the stride on the 3x3, expand and downsample at the output's)
    cfg = dict(CFG, image_size=64, backbone_stages=[1, 1, 1, 1])
    assert serve.resnet_flops(cfg) == 226_623_488


def test_resnet50_flops_against_the_published_count():
    # ResNet-50 at 224 px: 4.09 GMAC with a 3-channel stem and the 1000-way
    # fc; this stem has one channel and there is no fc
    published = 2 * 4.09e9 - 2 * 2 * 64 * 49 * 112 * 112 - 2 * 2048 * 1000
    assert serve.resnet_flops(dict(CFG, image_size=224)) == pytest.approx(published, rel=0.01)


def test_token_and_row_flops_by_hand():
    cfg = dict(CFG, region_feature_dim=3,
               decoder=dict(CFG["decoder"], hidden_dim=4, vocab_size=10, num_layers=1))
    # 1 layer: 2*4*(12 + 4 + 32) + 4*slots*4, LM head 2*4*10
    assert serve.token_flops(cfg, 3) == 384 + 48 + 80
    prefill = 2 * (3 * 4 + 16) + 2 * 2 * 16 + (384 + 32 + 80)
    # 3 generated tokens: the prefill gives token 1; steps for tokens 2, 3
    # attend 3 and 4 slots; two beams run two lanes a step
    steps = (384 + 48 + 80) + (384 + 64 + 80)
    assert serve.row_flops(cfg, 3, 1) == prefill + steps
    assert serve.row_flops(cfg, 3, 2) == prefill + 2 * steps


def test_batch_flops_counts_the_eos_of_short_rows():
    tr = {"max_length": 5, "num_beams": 1, "image_shape": [512, 512]}
    det = serve.detector_flops(CFG, (512, 512))
    got = serve.batch_flops(CFG, tr, {"images": 2, "row_tokens": [4, 1]})
    assert got == 2 * det + serve.row_flops(CFG, 4, 1) + serve.row_flops(CFG, 2, 1)


def test_k3_bytes_count_each_named_row_once():
    # two beams, slots 0-2 named [0, 0, 0] and [0, 1, 1]: rows 1 + 2 + 2
    anc = torch.tensor([[[0, 0, 0, 0], [0, 1, 1, 1]]], dtype=torch.int32)
    step = {"anc": anc, "slot": 2, "t0": 0, "heads": 1, "head_dim": 4,
            "cache_dtype": "torch.int8", "q_bytes": 2, "lanes": 2, "launches": 3}
    c = k3.step_counts(step)
    assert c["bytes"] == 5 * (2 * 4 + 8) + 2 * 4 * (2 + 4) + 2 * 3 * 4
    assert c["flops"] == 4 * 4 * 1 * 2 * 3
    peaks = {"hbm_bytes_per_s": 1.0, "f32_flops": 1e9}
    assert k3.bound_seconds([step], peaks) == 3 * c["bytes"]


def test_device_union_and_idle_share():
    events = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0)]
    busy, gaps = device_union(events)
    assert busy == pytest.approx(30e-6) and gaps == [("before c", pytest.approx(10e-6))]
    read = load_module(BENCH + "/metrics/idle_share.serve.py").read
    assert read({"trace": {"slice_s": 60e-6, "events": events}, "busy_s": busy}) == \
        pytest.approx(50.0)
