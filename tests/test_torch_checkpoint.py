"""The port's reference `.pt` loader and serving CLI against the JAX package's.

A synthetic reference checkpoint (tests/test_torch_roundtrip.py's inverse
conversion of JAX-initialized SMOKE_CFG weights: full ResNet-50 detector,
tiny decoder scaled x8) with all four weight quirks: the newer torchvision RPN conv
name, HF Conv1D layouts, a uniform DataParallel "module." prefix and the
{"model": state_dict, ...} wrapper.

- The port's `convert_full_checkpoint` gives JAX's parameter tree leaf for
  leaf, and `ReportGenerator.from_torch_checkpoint` gives JAX's reports on
  the same file and image paths (host preprocessing, JAX pointed at the
  test-built C++ library as in tests/test_torch_preprocess.py).
- `python -m rgrg_tpu_torch.generate_reports` writes (and prints) what
  scripts/generate_reports.py writes, two chunks of two X-rays of two
  shapes; the checkpoint-directory route (`core/checkpoint.save_checkpoint`
  of the loaded params) writes the file the `.pt` route writes.
- `python -m rgrg_tpu_torch.serve` writes the same report file as
  scripts/serve.py on two PNGs, and serves a checkpoint directory as
  `ReportGenerator.from_checkpoint` plus `generate_reports_pipelined` do.
  The JAX CLIs build the default (GPT-2 Medium) config, so the tests hand
  JAX's constructor SMOKE_CFG at run time and the port's `main` its config
  (`cfg=`).

Images are the first seeded ones whose detector and greedy decisions clear
the two libraries' f32 disagreement (tests/torch_parity.py).
"""

import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import sys

import cv2
import numpy as np
import jax
import pytest
import torch

import rgrg_tpu.data.native as jnative
from rgrg_tpu.core.checkpoint import convert_full_checkpoint as j_convert
from rgrg_tpu.inference import ReportGenerator as JReportGenerator
from rgrg_tpu.models.full_model import RGRG as JRGRG

import rgrg_tpu_torch.generate_reports as tgen
import rgrg_tpu_torch.serve as tserve
from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.core.checkpoint import (convert_full_checkpoint, load_torch_checkpoint,
                                            save_checkpoint)
from rgrg_tpu_torch.inference import ReportGenerator, write_generated_reports_to_txt
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.serving import generate_reports_pipelined

from tests.test_full_model import SMOKE_CFG
from tests.test_torch_preprocess import native_lib  # noqa: F401  (fixture)
from tests.test_torch_roundtrip import _write_tokenizer_dir, build_reference_state_dict
from tests.torch_parity import greedy_logit_margin, has_parity_margins

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAX_LEN = 6
SELECTION_BIAS = 4.0
PORT_CFG = TC.ModelConfig(
    detector=TC.DetectorConfig(rpn=TC.RPNConfig(pre_nms_top_n_test=32)),
    decoder=TC.DecoderConfig(**{f.name: getattr(SMOKE_CFG.decoder, f.name)
                                for f in dataclasses.fields(TC.DecoderConfig)}))


@pytest.fixture(autouse=True)
def exact_dedup(monkeypatch):
    monkeypatch.delenv("RGRG_DISTILBERT_DIR", raising=False)


def _images_with_margins(gen, shape, count):
    model = RGRG(PORT_CFG)
    found = []
    for seed in range(48):
        image = np.random.default_rng([shape[0], seed]).integers(0, 256, shape, dtype=np.uint8)
        x = gen.preprocess([image])
        if not has_parity_margins(gen.params["detector"], x):
            continue
        det = model.detect(gen.params, x)
        feats = det["region_features"][0][det["selected_regions"][0]]
        if feats.shape[0] and greedy_logit_margin(gen.params["decoder"], feats,
                                                  PORT_CFG.decoder, MAX_LEN) >= 1e-4:
            found.append(image)
            if len(found) == count:
                return found
    raise AssertionError(f"no seeded {shape} input with decision margins")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    # one jitted init compiles in a third of the time of the op-by-op one
    truth = jax.jit(JRGRG(cfg=SMOKE_CFG).init)(jax.random.PRNGKey(3))
    # decoder weights x8: a random decoder's logits are near-uniform otherwise
    truth["decoder"] = jax.tree.map(lambda a: a * 8.0, truth["decoder"])
    # the random full-depth detector selects almost no region: raise the
    # selection logits so that detected regions get decoded
    sel_head = truth["detector"]["params"]["selection_classifier"]["fc2"]
    sel_head["bias"] = sel_head["bias"] + SELECTION_BIAS
    sd = build_reference_state_dict(truth)
    path = str(d / "full_model.pt")
    torch.save({"model": sd, "current_epoch": 3, "lowest_val_loss": 1.25}, path)
    tok_dir = _write_tokenizer_dir(d)
    gen = ReportGenerator.from_torch_checkpoint(path, tok_dir, cfg=PORT_CFG, device="cpu")
    images = {}
    for shape in ((700, 600), (1024, 768)):
        images[shape] = []
        for i, image in enumerate(_images_with_margins(gen, shape, 2)):
            p = d / f"{shape[0]}_{i}.png"
            cv2.imwrite(str(p), image)
            images[shape].append(str(p))
    return dict(path=path, tok_dir=tok_dir, gen=gen, sd=sd, images=images, dir=d)


def test_convert_full_checkpoint_matches_jax(ckpt):
    sd = load_torch_checkpoint(ckpt["path"])
    got = jax.tree_util.tree_leaves_with_path(convert_full_checkpoint(sd, num_layers=2))
    want = dict(jax.tree_util.tree_leaves_with_path(j_convert(sd, num_layers=2)))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path], err_msg=jax.tree_util.keystr(path))
    assert all(p.device.type == "cpu" for p in ckpt["gen"].params["detector"].parameters())


def test_from_torch_checkpoint_reports_identical_to_jax(ckpt, native_lib, monkeypatch):  # noqa: F811
    monkeypatch.setattr(jnative, "_LIB_PATHS", [native_lib])
    monkeypatch.setattr(jnative, "_lib", None)
    jgen = JReportGenerator.from_torch_checkpoint(ckpt["path"], ckpt["tok_dir"], cfg=SMOKE_CFG,
                                                  similarity_fn=None)
    paths = ckpt["images"][(700, 600)]
    want = jgen.generate_reports(paths, num_beams=1, max_length=MAX_LEN)
    got = ckpt["gen"].generate_reports(paths, num_beams=1, max_length=MAX_LEN)
    assert any(g.region_sentences for g in got)
    for g, w in zip(got, want):
        assert g.report == w.report and g.region_sentences == w.region_sentences
        np.testing.assert_array_equal(g.selected_regions, w.selected_regions)


def _images(ckpt):
    return ckpt["images"][(1024, 768)] + ckpt["images"][(700, 600)]


def _args(ckpt, checkpoint, output):
    return ["--checkpoint", checkpoint, "--tokenizer-dir", ckpt["tok_dir"],
            "--images", *_images(ckpt), "--output", str(output), "--batch-size", "2",
            "--num-beams", "1", "--max-length", str(MAX_LEN)]


@pytest.fixture(scope="module")
def port_pt_run(ckpt, tmp_path_factory):
    """The port CLI's report file and printout from the `.pt`."""
    out = tmp_path_factory.mktemp("port") / "port.txt"
    capture = io.StringIO()
    with contextlib.redirect_stdout(capture):
        tgen.main(_args(ckpt, ckpt["path"], out) + ["--device", "cpu"], cfg=PORT_CFG)
    return out.read_text(), capture.getvalue().replace(str(out), "<output>")


def test_generate_reports_cli_writes_same_file_as_jax(ckpt, port_pt_run, native_lib,
                                                      monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(jnative, "_LIB_PATHS", [native_lib])
    monkeypatch.setattr(jnative, "_lib", None)
    j_from = JReportGenerator.from_torch_checkpoint.__func__
    monkeypatch.setattr(JReportGenerator, "from_torch_checkpoint", classmethod(
        lambda cls, path, tok, **kw: j_from(cls, path, tok, cfg=SMOKE_CFG,
                                            similarity_fn=None)))
    spec = importlib.util.spec_from_file_location(
        "generate_reports_cli", ROOT / "scripts" / "generate_reports.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    want = tmp_path / "jax.txt"
    monkeypatch.setattr(sys, "argv", ["generate_reports.py"] + _args(ckpt, ckpt["path"], want))
    capsys.readouterr()
    jcli.main()
    want_out = capsys.readouterr().out

    text, printed = port_pt_run
    assert text == want.read_text()
    assert printed == want_out.replace(str(want), "<output>")
    assert text.count("Image path: ") == 4 and text.count("Generated report: ") == 4
    assert any(len(line) > len("Generated report: ") for line in text.splitlines()
               if line.startswith("Generated report: "))
    defaults = tgen.build_parser().parse_args(["--checkpoint", "c", "--tokenizer-dir", "t",
                                               "--images", "a.png"])
    assert (defaults.num_beams, defaults.max_length, defaults.batch_size, defaults.device,
            defaults.no_early_stopping) == (4, 300, 8, "cuda", False)


def test_generate_reports_cli_checkpoint_directory_equals_pt(ckpt, port_pt_run, tmp_path):
    directory = tmp_path / "params"
    save_checkpoint(str(directory), ckpt["gen"].params)
    from_dir = tmp_path / "dir.txt"
    tgen.main(_args(ckpt, str(directory), from_dir) + ["--device", "cpu"], cfg=PORT_CFG)
    assert from_dir.read_text() == port_pt_run[0]
    assert port_pt_run[0].count("Image path: ") == 4


def test_serve_cli_serves_a_checkpoint_directory(ckpt, tmp_path):
    directory = tmp_path / "params"
    save_checkpoint(str(directory), ckpt["gen"].params)
    got = tmp_path / "served.txt"
    tserve.main(["--checkpoint", str(directory), "--tokenizer-dir", ckpt["tok_dir"],
                 "--image-dir", str(ckpt["dir"]), "--pattern", "*.png", "--batch-size", "2",
                 "--max-length", str(MAX_LEN), "--output", str(got), "--device", "cpu"],
                cfg=PORT_CFG)

    gen = ReportGenerator.from_checkpoint(str(directory), ckpt["tok_dir"], cfg=PORT_CFG,
                                          device="cpu")
    images = sorted(str(p) for p in pathlib.Path(ckpt["dir"]).glob("*.png"))
    assert len(images) == 4
    reports = [r for batch in generate_reports_pipelined(gen, images, batch_size=2,
                                                         max_length=MAX_LEN)
               for r in batch]
    want = tmp_path / "want.txt"
    write_generated_reports_to_txt(images, reports, str(want))
    assert got.read_text() == want.read_text()
    assert any(r.region_sentences for r in reports)


def test_serve_cli_writes_same_file_as_jax(ckpt, monkeypatch):
    image_dir = ckpt["dir"]
    for p in ckpt["images"][(700, 600)]:  # serve only the 1024x768 pair
        pathlib.Path(p).rename(p + ".skip")
    args = ["--checkpoint", ckpt["path"], "--tokenizer-dir", ckpt["tok_dir"],
            "--image-dir", str(image_dir), "--pattern", "*.png", "--batch-size", "2",
            "--max-length", str(MAX_LEN)]

    j_from = JReportGenerator.from_torch_checkpoint.__func__
    monkeypatch.setattr(JReportGenerator, "from_torch_checkpoint", classmethod(
        lambda cls, path, tok, **kw: j_from(cls, path, tok, cfg=SMOKE_CFG,
                                            similarity_fn=None)))

    spec = importlib.util.spec_from_file_location("serve_cli", ROOT / "scripts" / "serve.py")
    jserve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jserve)
    want_path = image_dir / "jax.txt"
    monkeypatch.setattr(sys, "argv", ["serve.py"] + args + ["--output", str(want_path)])
    jserve.main()
    got_path = image_dir / "port.txt"
    tserve.main(args + ["--output", str(got_path), "--device", "cpu"], cfg=PORT_CFG)

    text = got_path.read_text()
    assert text == want_path.read_text()
    assert text.count("Image path: ") == 2 and "Generated report: " in text
    assert tserve.build_parser().parse_args(args + ["--weights-int8"]).weights_int8 == "xla"
