"""The Moonlight cell's files: found by name, its arithmetic against hand
counts at the published sizes, and its driver and judge at a tiny size on
the CPU (a sound run agrees with the reference, the control reads above
it, one altered token a row comes out not correct); on the card, a whole
run of the cell prints a correct result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.counts import moe
from port_bench.run import BENCH, ROOT, judge, load_json, load_module, peaks_for, resolve

CELL = "serve-moonlight-beam4-b16"
MOE = load_module(os.path.join(BENCH, "drivers", "serve_pipelined_moe.py"))
CFG = load_json(BENCH, "configs", "rgrg-moonlight-serve-bf16.json")
SEED = 2**31 + 12345


def test_the_cell_and_its_files_are_found_by_name():
    c = resolve(load_json(ROOT, "BENCHMARK.json"), CELL)
    assert c["config"]["name"] == "rgrg-moonlight-serve-bf16" and c["config"]["reduced"] == []
    assert c["traffic"]["driver"] == "serve_pipelined_moe"
    assert set(c["limits"]) == {"token_gap_mean", "token_rows_far_pct", "box_px",
                                "region_mismatch_pct", "malformed"}
    beam = load_json(BENCH, "traffic", "closed-b16-beam4.json")
    assert {k: v for k, v in c["traffic"].items() if k not in ("driver", "why")} == {
        k: v for k, v in beam.items() if k not in ("driver", "why")}
    for name in ("serve_mfu.moe", "moe_roofline", "moe_load_imbalance"):
        assert callable(load_module(os.path.join(BENCH, "metrics", name + ".py")).read)


def test_the_decoder_group_repeats_the_published_keys():
    d = CFG["decoder"]
    assert d["kind"] == "moonlight"
    for k, v in d.items():
        if k in CFG:
            assert CFG[k] == v, k
    assert CFG["ep_size"] == 1 and CFG["num_hidden_layers"] == 27 and CFG["vocab_size"] == 163840


def tiny_config():
    cfg = json.loads(json.dumps(CFG))
    cfg["backbone_stages"] = [1, 1, 1, 1]
    cfg["representation_size"] = 16
    cfg["decoder"].update(vocab_size=300, hidden_size=64, num_attention_heads=4,
                          num_hidden_layers=3, kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
                          moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
                          num_experts_per_tok=2, bos_token_id=298, eos_token_id=299,
                          pad_token_id=299)
    return cfg


def test_weight_layout_matches_the_programs_decoder():
    from rgrg_tpu_torch.models import moonlight
    cfg = tiny_config()
    mcfg = MOE.moonlight_config(cfg)
    tree = moonlight.init_decoder_params(torch.Generator().manual_seed(0), mcfg.decoder)

    def flat(node, prefix):
        for k, v in node.items():
            yield from (flat(v, prefix + k + ".") if isinstance(v, dict)
                        else [(prefix + k, tuple(v.shape))])
    assert {n: s for n, s, _, _ in MOE.decoder_layout(cfg)} == dict(flat(tree, "decoder."))


def test_counts_by_hand_at_the_published_sizes():
    p = moe.active_params(CFG)
    assert p["attn"] == 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert p["dense"] == 3 * 2048 * 11264
    assert p["moe"] == 64 * 2048 + (6 + 2) * 3 * 2048 * 1408
    # 2.58B active parameters a token: 5.16 GFLOP a lane before attention
    active = 27 * 13_762_560 + 69_206_016 + 26 * 69_337_088 + 2048 * 163840
    assert moe.token_flops(CFG, 0) == 2.0 * active == 5_158_207_488
    # absorbed attention: per head a 576-wide score and a 512-wide sum a slot
    assert moe.token_flops(CFG, 10) - moe.token_flops(CFG, 0) == 27 * 2.0 * 16 * 10 * (512 + 576)
    # every expert of the 26 layers in one step: 28.8 GB of weights
    steps = [[1] * 64 for _ in range(26)]
    assert moe.expert_bytes(CFG, [[0] * 64] * 26, steps) == 26 * 64 * 3 * 2048 * 1408 * 2
    rows = [[72] * 64 for _ in range(26)]
    assert (moe.expert_bytes(CFG, rows, steps) - moe.expert_bytes(CFG, [[0] * 64] * 26, steps)
            == 26 * 64 * 72 * 3 * 2048 * 2)


def test_the_metrics_read_the_counters_and_the_trace():
    rows = [[10, 30, 0, 40]] * 3 + [[5, 5, 5, 5]]
    rec = {"window": {"counters": {"moe.expert_rows": rows}}}
    imb = load_module(os.path.join(BENCH, "metrics", "moe_load_imbalance.py"))
    assert imb.read(rec) == pytest.approx(2.0)
    assert imb.read({"window": {"counters": {}}}) is None
    roof = load_module(os.path.join(BENCH, "metrics", "moe_roofline.py"))
    peaks = peaks_for("NVIDIA H100 80GB HBM3")
    counters = {"moe.expert_rows": [[0] * 64] * 26, "moe.expert_steps": [[1] * 64] * 26}
    events = [("cutlass_GroupProblemShape_gemm", 0.0, 10_000.0),
              ("cutlass_GroupProblemShape_gemm", 10_000.0, 20_000.0)]
    want = 100.0 * 26 * 64 * 3 * 2048 * 1408 * 2 / peaks["hbm_bytes_per_s"] / 0.02
    got = roof.read({"config": CFG, "peaks": peaks,
                     "trace": {"counters": counters, "events": events}})
    assert got == pytest.approx(want)
    # the parent program keeps no expert counters: nothing to read, no error
    assert roof.read({"config": CFG, "peaks": peaks, "trace": {"events": events}}) is None


def test_the_expert_layers_kernels_are_found_by_launch_order():
    step = ["embedding vectorized_gather_kernel", "nvjet_tst_router_gemm",
            "sigmoid_kernel_cuda", "sbtopk::gatherTopK", "reduce_kernel sum",
            "DeviceRadixSortOnesweepKernel", "searchsorted_cuda_kernel",
            "vectorized_gather_kernel", "cutlass GroupProblemShape gate_up",
            "silu_kernel", "MulFunctor", "cutlass GroupProblemShape down",
            "index_copy_kernel", "MulFunctor", "reduce_kernel sum",
            "nvjet_tst_shared_gate_up", "silu_kernel", "nvjet_tst_shared_down",
            "index_copy_kernel latent cache write"]
    # two steps, listed out of launch order; each kernel 1 us
    events = [(n, 100.0 * s + i, 100.0 * s + i + 1.0) for s in (1, 0) for i, n in enumerate(step)]
    got = [events[i][0] for i in moe.expert_kernels(events)]
    one = step[step.index("reduce_kernel sum"):step.index("nvjet_tst_shared_gate_up")]
    assert got == one + one
    assert moe.expert_seconds(events) == pytest.approx(2 * len(one) * 1e-6)
    # an upload's copy landing inside a layer's work is left out
    events.append(("Memcpy HtoD (Pinned -> Device)", 9.5, 9.6))
    assert len(moe.expert_kernels(events)) == 2 * len(one)


def tiny_run(control: bool):
    """A tiny run of the cell's driver on the CPU: its window's record and
    the judge's numbers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        tr = load_json(BENCH, "traffic", "closed-b16-beam4-moe.json")
        tr.update(pool_images=4, pool_cycles=6, image_shape=[600, 700], batch_size=2,
                  max_length=8, warmup_batches=1, trace_batches=1)
        drv = MOE.Driver(tiny_config(), tr, SEED, torch.device("cpu"))
        drv.setup()
        win = drv.window(0.0)
        while len(drv.kept) < 4:
            drv._keep(drv._next())
        drv.finish()
        return win, drv.check(control=control)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sound():
    return tiny_run(control=True)


def test_a_sound_run_agrees_and_the_control_reads_above(sound):
    win, res = sound
    p, c = res["program"], res["control"]
    assert p["rows"] > 0 and p["malformed"] == 0
    assert p["box_px"] < 4.0 and p["region_mismatch_pct"] < 10.0 and p["token_gap"] < 0.01
    assert c["box_px"] > p["box_px"] and c["region_mismatch_pct"] > p["region_mismatch_pct"]
    assert c["token_gap"] >= p["token_gap"]
    assert judge(p, load_json(BENCH, "limits", CELL + ".json"))[0]
    assert not judge(c, load_json(BENCH, "limits", CELL + ".json"))[0]
    rows = win["counters"]["moe.expert_rows"]
    assert len(rows) == 2 and len(rows[0]) == 8 and sum(rows[0]) == sum(rows[1]) > 0


def test_one_wrong_token_a_row_comes_out_not_correct(sound):
    from port_bench import faults
    with faults.token(4):
        _, res = tiny_run(control=False)
    p, limits = res["program"], load_json(BENCH, "limits", CELL + ".json")
    assert sound[1]["program"]["token_rows_far_pct"] == 0.0
    assert p["token_rows_far_pct"] > limits["token_rows_far_pct"]
    assert not judge(p, limits)[0]


@pytest.mark.cuda
def test_a_run_on_the_card_prints_a_correct_result():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELL,
                          "--seed", str(SEED), "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert {"serve_mfu.moe", "moe_roofline", "moe_load_imbalance", "decode_ms_per_step",
            "idle_share.serve"} <= set(line["metrics"])
