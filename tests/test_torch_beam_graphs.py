"""Beam steps replayed from CUDA graphs (decode/beam.StepGraphs), on the card.

These tests need an NVIDIA GPU and `nvcc`; they skip where
torch.cuda.is_available() is false. The file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_beam_graphs.py

The CPU tests of the graph-ready step (its segments run eagerly against
the eager decode) are in tests/test_torch_beam.py.
"""

import weakref

import numpy as np
import pytest
import torch

from rgrg_tpu_torch.core.config import DecoderConfig
from rgrg_tpu_torch.decode import beam
from rgrg_tpu_torch.decode.beam import beam_generate
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.ops import kernels
from rgrg_tpu_torch.ops.beam_attn import beam_attention
from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8

CFG = DecoderConfig(vocab_size=512, hidden_dim=64, num_heads=4, num_layers=3,
                    max_positions=64, bos_token_id=0, eos_token_id=7, pad_token_id=7,
                    image_feature_dim=32)
MAX_LEN = 14


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["beam_attn", "dense_wint8"])
    return torch.device("cuda")


def _params(cuda, dtype, layout):
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = gpt2.init_decoder_params(gen, CFG, dtype=torch.float32, device=cuda)
    # scaled up so that rows differ and beams end at different steps
    p = _map(p, lambda t: (t * 8).to(dtype))
    return p if layout is None else gpt2.quantize_decoder_weights(p, layout=layout)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _feats(cuda, seed, items=4, dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((items, CFG.image_feature_dim), generator=g, device=cuda) * 3).to(dtype)


def _counts():
    return np.array([beam_generate.steps, beam_generate.graph_steps,
                     beam_generate.graph_captures, beam_attention.launches,
                     dense_wint8.launches])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout,cache,no_image", [
    (torch.float32, None, None, False),
    (torch.bfloat16, None, torch.int8, False),
    (torch.bfloat16, "pallas", torch.int8, False),
    (torch.bfloat16, None, torch.int8, True),
], ids=["f32", "bf16_int8kv", "k4_int8kv", "no_image"])
def test_replayed_steps_equal_eager_and_are_counted(cuda, dtype, layout, cache, no_image):
    """A key's first call decodes eagerly, its second captures (its first
    step runs eagerly while capturing) and replays the rest, later calls
    replay every step; ids and `done` equal the eager decode's. K3 runs
    eagerly at every layer of every step; K4's launches inside the graphs
    are counted at each replay. The two inputs differ in their features
    (none for vanilla GPT-2) and in the rows decoded."""
    p = _params(cuda, dtype, layout)
    a = (None if no_image else _feats(cuda, 1, dtype=dtype),
         torch.tensor([True, True, False, True], device=cuda))
    b = (None if no_image else _feats(cuda, 2, dtype=dtype),
         torch.tensor([True, False, True, True], device=cuda))
    kw = dict(max_length=MAX_LEN, num_beams=4, length_penalty=0.7, early_stopping=True,
              cache_dtype=cache, return_done=True, no_image=no_image, batch=4)
    beam.GRAPH_SETS.clear()

    def run(inputs):
        feats, active = inputs
        c0 = _counts()
        ids, done = beam_generate(p, feats, CFG, active=active, **kw)
        torch.cuda.synchronize()
        return ids.cpu(), done.cpu(), _counts() - c0

    eager_a = run(a)
    captured_b = run(b)
    replayed_a = run(a)
    replayed_b = run(b)
    beam.GRAPH_SETS.clear()
    eager_b = run(b)
    for got, want in ((captured_b, eager_b), (replayed_a, eager_a), (replayed_b, eager_b)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(eager_a[0], eager_b[0])

    per_step_k4 = 4 * CFG.num_layers if layout == "pallas" else 0
    for (_, _, d), graphs, captures in ((eager_a, False, 0), (captured_b, True, 1),
                                        (replayed_a, True, 0), (replayed_b, True, 0),
                                        (eager_b, False, 0)):
        steps, graph_steps = d[0], d[1]
        assert steps > 1
        assert graph_steps == (steps - captures if graphs else 0) and d[2] == captures
        assert d[3] == CFG.num_layers * steps
        assert d[4] == per_step_k4 * (steps + 1)   # and the prefill's


@pytest.mark.cuda
def test_beam_attention_out_on_the_card(cuda):
    rng = np.random.default_rng(4)
    bk, h, t, d, kb = 32, 4, 20, 16, 4
    q = torch.from_numpy(rng.normal(0, 1, (bk, h, d)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.normal(0, 1, (h, bk, t, d)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(0, 1, (h, bk, t, d)).astype(np.float32)).to(cuda)
    anc = torch.from_numpy(rng.integers(0, kb, (bk // kb, kb, t)).astype(np.int32)).to(cuda)
    want = beam_attention(q, k, v, anc, 13, scale=0.25)
    buf = torch.full_like(want, float("nan"))
    assert beam_attention(q, k, v, anc, 13, scale=0.25, out=buf) is buf
    torch.cuda.synchronize()
    assert torch.equal(buf, want)


@pytest.mark.cuda
def test_third_key_evicts_the_least_recently_used_set(cuda):
    p = _params(cuda, torch.bfloat16, None)
    kw = dict(max_length=8, num_beams=2, cache_dtype=torch.int8)
    beam.GRAPH_SETS.clear()

    def lanes():
        return [key[1] for key in beam.GRAPH_SETS.sets]

    for items in (2, 3):
        for _ in range(2):
            beam_generate(p, _feats(cuda, items, items, torch.bfloat16), CFG, **kw)
    assert lanes() == [4, 6]
    beam_generate(p, _feats(cuda, 2, 2, torch.bfloat16), CFG, **kw)   # 4 lanes: most recent
    evicted = weakref.ref(next(s for key, s in beam.GRAPH_SETS.sets.items()
                               if key[1] == 6).cache["k_0"])
    for _ in range(2):
        beam_generate(p, _feats(cuda, 5, 5, torch.bfloat16), CFG, **kw)
    assert lanes() == [4, 10]
    assert evicted() is None
    beam.GRAPH_SETS.clear()


@pytest.mark.cuda
def test_division_by_the_divisor_tensor_rounds_as_by_the_float(cuda):
    """The graph-ready step's x / lp (a one-element tensor) equals the eager
    step's x / float bit for bit, for the divisors of every cur_len."""
    x = torch.from_numpy(np.random.default_rng(0).normal(-8, 4, 4096).astype(np.float32)).to(cuda)
    for penalty in (0.7, 1.0, 1.3, 2.0):
        for n in range(1, 305):
            lp = beam.length_penalty_divisor(n, penalty)
            want = x / lp
            got = beam._over(x, torch.tensor([lp], device=cuda))
            assert torch.equal(got, want), (penalty, n)
