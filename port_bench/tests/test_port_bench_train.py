"""The training driver and its judge at a tiny size on the CPU: a sound
run follows the plain reference, and the faults a training cell can have
come out not correct."""

from __future__ import annotations

import os

import pytest
import torch

from port_bench import faults
from port_bench.run import BENCH, judge, load_json, load_module

TRAIN = load_module(os.path.join(BENCH, "drivers", "train_step.py"))
SEED = 2**31 + 99


def tiny_config():
    cfg = load_json(BENCH, "configs", "rgrg-train-f32.json")
    cfg["backbone_stages"] = [1, 1, 1, 1]
    cfg["representation_size"] = 16
    cfg["decoder"].update(vocab_size=300, hidden_dim=64, num_heads=4, num_layers=2,
                          max_positions=64, bos_token_id=299, eos_token_id=299, pad_token_id=299)
    cfg["train"].update(batch_size=2, grad_accumulation_steps=2, lm_budget=8, seq_len=16,
                        rpn_pre_nms_top_n_train=300, roi_batch_per_image=64)
    return cfg


def tiny_run():
    tr = load_json(BENCH, "traffic", "train-s3-b16-acc4.json")
    tr.update(corpus_images=4, raw_shape=[256, 300], workers=2, prefetch=1, batch_pool=3,
              check_steps=2, trace_steps=1, sentence_words=[3, 10], sentences_per_image=4,
              phrase_words=50)
    drv = TRAIN.Driver(tiny_config(), tr, SEED, torch.device("cpu"))
    drv.setup()
    drv.window(0.0)
    drv.finish()
    return drv.check()["program"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_a_sound_step_follows_the_reference():
    got = tiny_run()
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3, got
    assert got["steady_loss_gap"] < 1e-5 and got["steady_change_gap"] < 1e-3, got
    assert got["loader_mismatch"] == 0, got
    ok, checks = judge(got, load_json(BENCH, "limits", "train-s3-b16.json"))
    assert ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_comes_out_not_correct(fault):
    with faults.FAULTS[fault]():
        got = tiny_run()
    ok, checks = judge(got, load_json(BENCH, "limits", "train-s3-b16.json"))
    assert not ok, checks
