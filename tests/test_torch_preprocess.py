"""The port's host preprocessing (rgrg_tpu_torch/data/preprocess.py) against
the JAX package's, and the entry points that use it.

1. Bit-identical to the C++ host pipeline (native/preprocess.cc), compiled
   here with g++ -O3 -ffp-contract=off as the repository's Makefile builds
   it (the Makefile's -march=native aside), on the shapes of
   tests/test_resize_device.py, 12 fuzzed shapes and a 2048x2500 X-ray.
2. Against the JAX package's cv2 fallback (used where the C++ library is
   not built): within tests/test_resize_device.py's bounds (cv2's uint8
   kernels round in fixed point).
3. End to end on a shape with fractional taps (700x600), where the device
   resize may round a pixel the other way: the port's generate_reports,
   generate_for_regions and generate_for_boxes equal the JAX package's
   (beam 4 at their defaults), JAX pointed at the test-built C++ library
   at run time. A batch of mixed shapes gives the same reports in both
   packages. Inputs are the first seeds whose decisions clear the two
   libraries' f32 disagreement (tests/torch_parity.py).
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import jax
import pytest
import torch

import rgrg_tpu.data.native as jnative
from rgrg_tpu.inference import ReportGenerator as JReportGenerator
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core.convert import from_jax_params
from rgrg_tpu_torch.data.preprocess import preprocess_batch
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

from tests.test_resize_device import SHAPES as DEVICE_SHAPES, _assert_matches_host
from tests.test_torch_pipeline import configs
from tests.torch_parity import beam_score_margin, has_parity_margins

ROOT = pathlib.Path(__file__).resolve().parent.parent
FUZZ = [(int(h), int(w)) for h, w in np.random.default_rng(7).integers(96, 1600, (12, 2))]
FRACTIONAL = (700, 600)
MAX_LEN = 8
MIN_BEAM_GAP = 1e-4


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """native/preprocess.cc built with the repository's float flags."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build native/preprocess.cc")
    path = tmp_path_factory.mktemp("native") / "librgrg_host.so"
    subprocess.run([cxx, "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
                    "-pthread", "-o", str(path), str(ROOT / "native" / "preprocess.cc")],
                   check=True)
    return str(path)


def native_batch(lib_path, images):
    lib = ctypes.CDLL(lib_path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = len(images)
    ptrs = (u8p * n)(*[im.ctypes.data_as(u8p) for im in images])
    out = np.empty((n, C.IMAGE_SIZE, C.IMAGE_SIZE), np.float32)
    lib.rgrg_preprocess_batch(
        ptrs, (ctypes.c_int * n)(*[im.shape[0] for im in images]),
        (ctypes.c_int * n)(*[im.shape[1] for im in images]), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), C.IMAGE_SIZE,
        ctypes.c_float(C.IMAGE_MEAN), ctypes.c_float(C.IMAGE_STD), ctypes.c_float(255.0), 0)
    return out[..., None]


SHAPES = DEVICE_SHAPES + [(2048, 2500), (961, 1024)] + FUZZ


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_preprocess_bit_identical_to_native(native_lib, shape):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2)]
    got = preprocess_batch(imgs)
    want = native_batch(native_lib, imgs)
    assert got.shape == want.shape == (2, 512, 512, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", DEVICE_SHAPES, ids=[f"{h}x{w}" for h, w in DEVICE_SHAPES])
def test_preprocess_matches_jax_cv2_fallback(monkeypatch, shape):
    monkeypatch.setattr(jnative, "_LIB_PATHS", [])
    monkeypatch.setattr(jnative, "_lib", None)
    rng = np.random.default_rng(hash(shape) % 2**32)
    imgs = list(rng.integers(0, 256, (2, *shape), dtype=np.uint8))
    diff = np.abs(preprocess_batch(imgs) - jnative.preprocess_batch(imgs))
    _assert_matches_host(diff, shape)


# ---------------------------------------------------------------- end to end

def _scaled(tree):
    return jax.tree.map(lambda a: a * 8.0, tree)


def _has_margins(tp, tcfg, x):
    if not has_parity_margins(tp["detector"], x):
        return False
    det = RGRG(tcfg).detect(tp, x)
    feats = det["region_features"][det["selected_regions"]]
    return bool(feats.shape[0]) and beam_score_margin(
        tp["decoder"], feats, tcfg.decoder, MAX_LEN, 4, True) >= MIN_BEAM_GAP


def _images_with_margins(tp, tcfg, gen, shape, count):
    found = []
    for seed in range(64):
        image = np.random.default_rng([shape[0], shape[1], seed]).integers(
            0, 256, shape, dtype=np.uint8)
        if _has_margins(tp, tcfg, gen.preprocess([image])):
            found.append(image)
            if len(found) == count:
                return found
    raise AssertionError(f"no seeded {shape} input with decision margins")


@pytest.fixture(scope="module")
def e2e():
    jcfg, tcfg = configs()
    # one jitted init compiles in a third of the time of the op-by-op one
    jp = jax.jit(JRGRG(jcfg).init)(jax.random.PRNGKey(0))
    jp = {"detector": jp["detector"], "decoder": _scaled(jp["decoder"])}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    gen = ReportGenerator(tp, GPT2Tokenizer.dummy(), cfg=tcfg)
    # decisions are per image, so images picked one by one keep their
    # margins in any batch
    same = _images_with_margins(tp, tcfg, gen, FRACTIONAL, 2)
    mixed = [same[0]] + _images_with_margins(tp, tcfg, gen, FRACTIONAL[::-1], 1)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, gen=gen, same=same, mixed=mixed)


@pytest.fixture
def jgen(e2e, native_lib, monkeypatch):
    """The JAX generator, preprocessing with the test-built C++ library."""
    monkeypatch.setattr(jnative, "_LIB_PATHS", [native_lib])
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.native_available()
    return JReportGenerator(e2e["jp"], JTokenizer.dummy(), cfg=e2e["jcfg"],
                            similarity_fn=None)


def _same_reports(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.report == w.report
        assert g.region_sentences == w.region_sentences
        np.testing.assert_array_equal(g.selected_regions, w.selected_regions)
        np.testing.assert_array_equal(g.class_detected, w.class_detected)
        np.testing.assert_allclose(g.top_region_boxes, w.top_region_boxes,
                                   rtol=1e-4, atol=1e-3)


def test_generate_reports_on_fractional_shape_identical_to_jax(e2e, jgen):
    images = e2e["same"]
    # the host route gives JAX's pixels bit for bit
    np.testing.assert_array_equal(e2e["gen"].preprocess(images).numpy(),
                                  np.asarray(jgen.preprocess(images)))
    got = e2e["gen"].generate_reports(images, max_length=MAX_LEN)
    assert any(g.region_sentences for g in got)
    _same_reports(got, jgen.generate_reports(images, max_length=MAX_LEN))


def test_generate_for_regions_and_boxes_on_fractional_shape_identical_to_jax(e2e, jgen):
    image = e2e["same"][0]
    det = RGRG(e2e["tcfg"]).detect(e2e["tp"], e2e["gen"].preprocess([image]))
    names = [C.REGION_NAMES[r] for r in np.nonzero(det["selected_regions"][0].numpy())[0][:4]]
    got = e2e["gen"].generate_for_regions(image, names, max_length=MAX_LEN)
    assert got and got == jgen.generate_for_regions(image, names, max_length=MAX_LEN)

    tdet = e2e["tp"]["detector"]
    fmap = tdet.backbone(e2e["gen"].preprocess([image]))
    for seed in range(16):
        rng = np.random.default_rng(seed)
        xy = rng.uniform(0, 400, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 112, (3, 2))], 1).astype(np.float32)
        feats = tdet.region_features_from_boxes(fmap, torch.from_numpy(boxes[None]))[0]
        if beam_score_margin(e2e["tp"]["decoder"], feats.detach(), e2e["tcfg"].decoder,
                             MAX_LEN, 4, True) >= MIN_BEAM_GAP:
            break
    assert (e2e["gen"].generate_for_boxes(image, boxes, max_length=MAX_LEN)
            == jgen.generate_for_boxes(image, boxes, max_length=MAX_LEN))


def test_mixed_shape_batch_identical_to_jax(e2e, jgen):
    images = e2e["mixed"]
    assert images[0].shape != images[1].shape
    _same_reports(e2e["gen"].generate_reports(images, max_length=MAX_LEN),
                  jgen.generate_reports(images, max_length=MAX_LEN))
    assert e2e["gen"].preprocess_raw(images)[0] is None


def test_preprocess_uploads_in_transfer_dtype(e2e):
    images = e2e["same"]
    f32 = e2e["gen"].preprocess(images)
    bf16 = e2e["gen"].preprocess(images, transfer_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
