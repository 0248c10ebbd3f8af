"""The benchmark's files: the contract's shape of BENCHMARK.json, every
name resolving to its files, a new cell picked up from files alone, the
weights' layout against the program's, and the import guard."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import weights
from port_bench.run import (BENCH, ROOT, applies, forbidden_modules, load_json, load_module,
                            resolve, result_line)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = load_json(ROOT, "BENCHMARK.json")


def test_benchmark_json_keeps_the_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert load_json(ROOT, c["file"])["reduced"] == c["reduced"]
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert applies(e2e[m["moves"]], w), (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in b["end_to_end"] if applies(m, w)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(applies(m, w) for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = resolve(BENCHMARK, cell)
    assert c["config"]["name"] == c["cell"]["config"]
    assert os.path.isfile(c["driver"]) and hasattr(load_module(c["driver"]), "Driver")
    assert set(c["limits"]) >= {"token_gap", "malformed"} or c["limits"]
    for m in BENCHMARK["per_layer"]:
        if applies(m, cell):
            assert callable(load_module(os.path.join(BENCH, "metrics", m["name"] + ".py")).read)


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """A later PR adds an entry to BENCHMARK.json, a traffic file and a
    limits file; nothing of the harness changes."""
    shutil.copytree(BENCH, tmp_path / "port_bench")
    bench = json.loads(json.dumps(BENCHMARK))
    base = tmp_path / "port_bench"
    traffic = load_json(str(base), "traffic", "closed-b16-greedy.json")
    traffic["batch_size"] = 32
    (base / "traffic" / "closed-b32-greedy.json").write_text(json.dumps(traffic))
    (base / "limits" / "serve-greedy-b32.json").write_text(
        (base / "limits" / "serve-greedy-b16.json").read_text())
    bench["workloads"].append({"name": "serve-greedy-b32", "config": "rgrg-serve-bf16",
                               "traffic": "closed-b32-greedy", "chips": 1, "why": "test"})
    c = resolve(bench, "serve-greedy-b32", root=str(tmp_path))
    assert c["traffic"]["batch_size"] == 32 and c["config"]["name"] == "rgrg-serve-bf16"


def test_result_line_has_the_contracts_keys_with_the_checks_last():
    win = {"attempted": 64, "failed": 0}
    device = {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1}
    line = result_line(True, win, {"setup_s": {"value": 1.0, "unit": "s"}}, device,
                       {"token_gap": {"value": 0.1, "limit": 1.0}})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    line = result_line(False, win, {}, device, {}, {"device_ops": [], "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]


def test_weight_layout_matches_the_programs_modules():
    from rgrg_tpu_torch.models import gpt2
    from rgrg_tpu_torch.models.detector import RegionDetector
    from port_bench.program import program_config
    cfg = load_json(BENCH, "configs", "rgrg-serve-bf16.json")
    cfg["backbone_stages"] = [1, 2, 1, 1]
    cfg["representation_size"] = 8
    cfg["decoder"].update(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=50, max_positions=16)
    mcfg = program_config(cfg)
    with torch.device("meta"):
        det = RegionDetector(mcfg.detector)
    ours = {n: tuple(s) for n, s, _, _ in weights.detector_layout(cfg)}
    assert ours == {k: tuple(v.shape) for k, v in det.state_dict().items()}
    tree = gpt2.init_decoder_params(torch.Generator().manual_seed(0), mcfg.decoder)

    def flat(node, prefix):
        for k, v in node.items():
            yield from flat(v, prefix + k + ".") if isinstance(v, dict) else [(prefix + k, tuple(v.shape))]
    assert {n: tuple(s) for n, s, _, _ in weights.decoder_layout(cfg)} == dict(flat(tree, "decoder."))


def test_weights_and_images_repeat_from_the_seed():
    cfg = load_json(BENCH, "configs", "rgrg-serve-bf16.json")
    cfg["backbone_stages"] = [1, 1, 1, 1]
    cfg["decoder"].update(num_layers=1, hidden_dim=16, num_heads=2, vocab_size=40, max_positions=8)
    a = weights.make_weights(cfg, 2**31 + 7, torch.device("cpu"))
    b = weights.make_weights(cfg, 2**31 + 7, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["decoder.wte.embedding"].dtype == torch.bfloat16
    x = weights.make_xrays(2, (96, 80), 2**31 + 7, torch.device("cpu"))
    assert x.dtype == torch.uint8 and torch.equal(x, weights.make_xrays(2, (96, 80), 2**31 + 7,
                                                                          torch.device("cpu")))


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rgrg_tpu_torch_like", sys)
    assert "rgrg_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "rgrg_tpu.ops", sys)
    assert forbidden_modules() == ["rgrg_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh interpreter: no jax, jaxlib,
    flax or rgrg_tpu by top-level name."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.run as r, port_bench.calibrate\n"
            "from port_bench.reference import rgrg, judge_serve\n"
            "from port_bench.counts import serve, k3\n"
            "import glob\n"
            "for p in glob.glob(r.BENCH + '/drivers/*.py') + glob.glob(r.BENCH + '/metrics/*.py'):\n"
            "    r.load_module(p)\n"
            "import rgrg_tpu_torch.serving, rgrg_tpu_torch.inference\n"
            "print('found:' + ','.join(r.forbidden_modules()))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "found:"


def test_no_benchmark_file_imports_jax_the_jax_package_or_the_jax_benches():
    banned = {"jax", "jaxlib", "flax", "rgrg_tpu", "bench", "chip_smoke", "scripts", "tests"}
    program_free = os.path.join(BENCH, "reference")
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    top = n.split(".")[0]
                    assert top not in banned, (path, n)
                    if dirpath.startswith(program_free):
                        assert top in ("torch", "numpy", "math", "typing", "__future__",
                                       "port_bench"), (path, n)
                        assert not n.startswith("port_bench.") or n.startswith(
                            "port_bench.reference"), (path, n)
