"""The serving driver and its judge at a tiny size on the CPU: a sound run
agrees with the plain reference, the control and broken runs do not, and
(on the card) a whole run of a cell prints a correct result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import faults
from port_bench.run import BENCH, ROOT, judge, load_json, load_module

SERVE = load_module(os.path.join(BENCH, "drivers", "serve_pipelined.py"))
SEED = 2**31 + 12345


def tiny_config():
    cfg = load_json(BENCH, "configs", "rgrg-serve-bf16.json")
    cfg["backbone_stages"] = [1, 1, 1, 1]
    cfg["representation_size"] = 16
    # BOS apart from EOS: a random tied-embedding GPT-2 this shallow
    # predicts its input token, and would end every row at once
    cfg["decoder"].update(vocab_size=300, hidden_dim=256, num_heads=4, num_layers=2,
                          max_positions=64, bos_token_id=298, eos_token_id=299,
                          pad_token_id=299)
    return cfg


def tiny_traffic(beams):
    tr = load_json(BENCH, "traffic", "closed-b16-beam4.json")
    tr.update(pool_images=4, pool_cycles=6, image_shape=[600, 700], batch_size=2,
              num_beams=beams, max_length=8, warmup_batches=1, trace_batches=1)
    return tr


def tiny_run(beams, control=False):
    drv = SERVE.Driver(tiny_config(), tiny_traffic(beams), SEED, torch.device("cpu"))
    drv.setup()
    drv.window(0.0)
    while len(drv.kept) < 4:
        drv._keep(drv._next())
    drv.finish()
    return drv.check(control=control)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[1, 4], ids=["greedy", "beam4"])
def sound(request):
    return request.param, tiny_run(request.param, control=True)


def test_a_sound_run_agrees_with_the_reference(sound):
    beams, res = sound
    p = res["program"]
    assert p["rows"] > 0 and p["malformed"] == 0
    assert p["box_px"] < 4.0 and p["region_mismatch_pct"] < 10.0
    assert p["token_gap"] < 0.01


def test_the_control_reads_above_the_program(sound):
    """The control reads above the program, and a run that served its
    outputs would come out not correct against the cell's limits. Beam:
    the control serves its own token of the served token's rank, which at
    this size stays inside the reference's 2K best, so its token gap is
    only not below the program's."""
    beams, res = sound
    p, c = res["program"], res["control"]
    assert c["box_px"] > p["box_px"] and c["region_mismatch_pct"] > p["region_mismatch_pct"]
    assert c["token_gap"] > p["token_gap"] if beams == 1 else c["token_gap"] >= p["token_gap"]
    cell = "serve-beam4-b16" if beams > 1 else "serve-greedy-b16"
    ok, checks = judge(c, load_json(BENCH, "limits", cell + ".json"))
    assert not ok, checks


def test_the_cells_limits_hold_the_sound_run(sound):
    beams, res = sound
    cell = "serve-beam4-b16" if beams > 1 else "serve-greedy-b16"
    ok, checks = judge(res["program"], load_json(BENCH, "limits", cell + ".json"))
    assert ok, checks


@pytest.mark.parametrize("fault", ["token", "box"])
@pytest.mark.parametrize("beams", [1, 4], ids=["greedy", "beam4"])
def test_a_broken_path_comes_out_not_correct(fault, beams):
    with faults.token(beams) if fault == "token" else faults.box():
        res = tiny_run(beams)
    cell = "serve-beam4-b16" if beams > 1 else "serve-greedy-b16"
    ok, checks = judge(res["program"], load_json(BENCH, "limits", cell + ".json"))
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-beam4-b16"])
def test_a_run_on_the_card_prints_a_correct_result(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
