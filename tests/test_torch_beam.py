"""The port's beam-search slice against the JAX package, on the CPU.

Layers, bottom up: the plain version of kernel K3 (ops/beam_attn.py)
against the Pallas kernel in interpret mode and the dense oracle of
tests/test_beam_attn_pallas.py; decode_step_beam and beam_generate against
JAX (and the HF 4.19 oracle of tests/test_beam.py); the graph-ready step
that CUDA graphs replay (decode/beam.StepGraphs, its segments run eagerly
here) against the eager beam_generate, and the policy that keeps its sets
(the card's replays: tests/test_torch_beam_graphs.py); the full model's beam
decode, cascade, generate_reports at its beam-4 default and the two
interactive APIs against the JAX pipeline stage by stage.

Weights are JAX-initialized and carried across by core/convert.py. The
decoder weights are scaled up (x8) so random networks produce distinct,
input-dependent sentences that end with EOS, instead of one token
repeated. Inputs come from numpy seeds; beam decisions on a random network
can sit on near-ties, so every ids comparison runs on the first seed whose
beam decisions all clear the two libraries' f32 disagreement (~1e-6) by
~100x (tests/torch_parity.beam_score_margin).
"""

import dataclasses
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgrg_tpu.decode.beam import beam_generate as j_beam
from rgrg_tpu.inference import ReportGenerator as JReportGenerator
from rgrg_tpu.models import gpt2 as jg
from rgrg_tpu.models.full_model import RGRG as JRGRG
from rgrg_tpu.ops.beam_attn_pallas import ITEM_BLOCK, beam_attention_pallas
from rgrg_tpu.text.report import assemble_report as j_assemble
from rgrg_tpu.text.tokenizer import GPT2Tokenizer as JTokenizer

from rgrg_tpu_torch.core import constants as C
from rgrg_tpu_torch.core.config import DecoderConfig, GenerationConfig
from rgrg_tpu_torch.core.convert import decoder_from_jax, from_jax_params
from rgrg_tpu_torch.decode import beam
from rgrg_tpu_torch.decode.beam import beam_generate
from rgrg_tpu_torch.inference import ReportGenerator
from rgrg_tpu_torch.models import gpt2
from rgrg_tpu_torch.models.full_model import RGRG
from rgrg_tpu_torch.ops.beam_attn import beam_attention, beam_attention_plain
from rgrg_tpu_torch.ops.topk import stable_topk
from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

from tests.test_beam import hf_beam_oracle
from tests.test_beam_attn_pallas import _oracle as dense_oracle
from tests.test_gpt2 import TINY as J_TINY
from tests.test_torch_pipeline import SHAPE, configs
from tests.torch_parity import beam_score_margin, has_parity_margins

CPU = torch.device("cpu")
TINY = DecoderConfig(**{f.name: getattr(J_TINY, f.name)
                        for f in dataclasses.fields(DecoderConfig)})
WEIGHT_SCALE = 8.0
# f32 attention/logits: the two libraries sum in another order (~1e-7 of
# unit-scale values); 2e-5 is the Pallas kernel's own oracle tolerance
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
MIN_BEAM_GAP = 1e-4
MAX_LEN = 12


def _scaled(tree):
    return jax.tree.map(lambda a: a * WEIGHT_SCALE, tree)


# ------------------------------------------------------------ K3, plain

def _attn_case(seed, k_beams, items, heads=4, t=9, d=8, slot=6):
    rng = np.random.default_rng(seed)
    bk = items * k_beams
    q = rng.normal(0, 1, (bk, heads, d)).astype(np.float32)
    k = rng.normal(0, 1, (heads, bk, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (heads, bk, t, d)).astype(np.float32)
    anc = rng.integers(0, k_beams, (items, k_beams, t)).astype(np.int32)
    return q, k, v, anc, slot


def _pack_for_pallas(q, k, v, anc, slot, t0, scale):
    """The port's unpacked inputs in the Pallas kernel's layout: head pairs
    in the lane dim, zero-interleaved pre-scaled queries (row lane*2 + p
    holds head 2*h2 + p in lane half p), anc_q -1 on hidden slots."""
    bk, h, d = q.shape
    h2, t = h // 2, k.shape[2]
    qz = np.zeros((h2, 2 * bk, 2 * d), np.float32)
    for p in range(2):
        qz[:, p::2, p * d:(p + 1) * d] = (q[:, p::2] * scale).transpose(1, 0, 2)

    def pack(x):
        return x.reshape(h2, 2, bk, t, d).transpose(0, 2, 3, 1, 4).reshape(h2, bk, t, 2 * d)

    anc_q = np.repeat(anc.reshape(bk, t), 2, axis=0)
    hidden = (np.arange(t) > slot) | (np.arange(t) < t0)
    anc_q[:, hidden] = -1
    return qz, pack(k), pack(v), anc_q


def _unpack_ctx(ctx, bk, h, d):
    """[H2, 2*BK, 2D] -> [BK, H, D]: lane half p of row lane*2 + p."""
    out = np.zeros((bk, h, d), np.float32)
    for p in range(2):
        out[:, p::2] = ctx[:, p::2, p * d:(p + 1) * d].transpose(1, 0, 2)
    return out


@pytest.mark.parametrize("k_beams,items,t0", [(4, ITEM_BLOCK * 2, 0),
                                              (2, ITEM_BLOCK * 3, 0),
                                              (4, ITEM_BLOCK, 1)],
                         ids=["k4", "k2", "k4_slot0_hidden"])
def test_plain_beam_attention_matches_pallas_and_oracle(k_beams, items, t0):
    q, k, v, anc, slot = _attn_case(items + k_beams, k_beams, items)
    scale = 1.0 / np.sqrt(np.float32(q.shape[-1]))
    got = beam_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(anc), slot,
                               scale=float(scale), t0=t0).numpy()
    qz, kp, vp, anc_q = _pack_for_pallas(q, k, v, anc, slot, t0, scale)
    ctx = np.asarray(beam_attention_pallas(jnp.asarray(qz), jnp.asarray(kp),
                                           jnp.asarray(vp), jnp.asarray(anc_q),
                                           k_beams=k_beams, interpret=True))
    np.testing.assert_allclose(got, _unpack_ctx(ctx, *q.shape), **ATTN_TOL)
    oracle = dense_oracle(qz, kp, vp, anc_q, k_beams)
    np.testing.assert_allclose(got, _unpack_ctx(oracle, *q.shape), **ATTN_TOL)


def test_beam_attention_cpu_uses_plain_int8_dequantizes():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; an int8 cache reads as value * scale."""
    q, k, v, anc, slot = _attn_case(5, 4, 2)
    tq, tanc = torch.from_numpy(q), torch.from_numpy(anc)
    qk, sk = gpt2._quantize_kv(torch.from_numpy(k))
    qv, sv = gpt2._quantize_kv(torch.from_numpy(v))
    before = beam_attention.launches
    got = beam_attention(tq, qk, qv, tanc, slot, scale=0.3, k_scale=sk, v_scale=sv)
    assert beam_attention.launches == before
    want = beam_attention_plain(tq, qk.float() * sk, qv.float() * sv, tanc, slot, scale=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="scale"):
        beam_attention(tq, qk, qv, tanc, slot, scale=0.3)
    with pytest.raises(ValueError, match="slot"):
        beam_attention(tq, torch.from_numpy(k), torch.from_numpy(v), tanc, 9, scale=0.3)


# ------------------------------------------------------ decoder, beam step

@pytest.fixture(scope="module")
def weights():
    jp = _scaled(jg.init_decoder_params(jax.random.PRNGKey(5), J_TINY))
    return jp, decoder_from_jax(jax.tree.map(np.asarray, jp), CPU)


@pytest.fixture(scope="module")
def step_weights():
    """Unscaled weights: logits of order 1, so the 1e-5 tolerance of the
    greedy step tests (tests/test_torch_gpt2.py) applies as it is."""
    jp = jg.init_decoder_params(jax.random.PRNGKey(5), J_TINY)
    return jp, decoder_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _unpack_jax_cache(cache, heads):
    """JAX beam cache (pair-packed or not) -> {name: [H, BK, T, D]} numpy."""
    out = {}
    for name, c in cache.items():
        c = np.asarray(c).astype(np.float32)
        if name[0] in "kv" and "scale" not in name and c.shape[0] != heads:
            h2, bk, t, dd = c.shape
            c = c.reshape(h2, bk, t, 2, dd // 2).transpose(0, 3, 1, 2, 4).reshape(
                heads, bk, t, dd // 2)
        out[name] = c
    return out


@pytest.mark.parametrize("cache,packed,pallas", [("f32", False, False),
                                                 ("f32", True, False),
                                                 ("f32", True, True),
                                                 ("int8", False, False)],
                         ids=["f32", "f32_packed", "f32_pallas", "int8"])
def test_decode_step_beam_matches_jax(step_weights, cache, packed, pallas):
    jp, tp = step_weights
    jdt, tdt = {"f32": (None, None), "int8": (jnp.int8, torch.int8)}[cache]
    items, kb, max_len = ITEM_BLOCK, 4, 8
    rng = np.random.default_rng(11)
    feats = np.repeat(rng.normal(0, 2, (items, J_TINY.image_feature_dim)), kb,
                      axis=0).astype(np.float32)
    _, jc = jg.prefill(jp, jnp.asarray(feats), J_TINY.bos_token_id, max_len, J_TINY,
                       cache_dtype=jdt)
    _, tc = gpt2.prefill(tp, torch.from_numpy(feats), TINY.bos_token_id, max_len,
                         TINY, cache_dtype=tdt)
    jc = jg.cache_to_beam_layers(jc, pack_pairs=packed)
    tc = gpt2.cache_to_beam_layers(tc)
    assert set(tc) == set(jc)
    for step in range(3):
        tok = rng.integers(0, J_TINY.vocab_size, items * kb)
        anc = rng.integers(0, kb, (items, kb, max_len + 1)).astype(np.int32)
        jl, jc = jg.decode_step_beam(jp, jnp.asarray(tok, jnp.int32), jnp.int32(step),
                                     jc, jnp.asarray(anc), J_TINY, pallas_attn=pallas)
        tl, tc = gpt2.decode_step_beam(tp, torch.from_numpy(tok), step, tc,
                                       torch.from_numpy(anc), TINY)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"step {step}")
        want = _unpack_jax_cache(jc, TINY.num_heads)
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy().astype(np.float32), want[name],
                                       **LOGIT_TOL, err_msg=f"{name} step {step}")


# ---------------------------------------------------------- beam_generate

def _pick_feats(tp, cfg, shape, num_beams, early, scale=3.0):
    for seed in range(32):
        feats = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
        if beam_score_margin(tp, torch.from_numpy(feats), cfg, MAX_LEN, num_beams,
                             early) >= MIN_BEAM_GAP:
            return feats
    raise AssertionError("no seeded input with beam decision margins")


@pytest.fixture(scope="module")
def eos_cfgs(weights):
    """Make a frequently generated token EOS (and pad), so beams finish at
    different steps and the finished pool, the done rule and early
    stopping all act."""
    jp, _ = weights
    feats = np.random.default_rng(0).normal(0, 3, (4, 16)).astype(np.float32)
    free = np.asarray(j_beam(jp, jnp.asarray(feats), J_TINY, max_length=16, num_beams=4))
    vals, counts = np.unique(free[:, 1:], return_counts=True)
    order = [int(x) for x in vals[np.argsort(-counts, kind="stable")] if x != 0]
    eos = order[0]
    return (dataclasses.replace(J_TINY, eos_token_id=eos, pad_token_id=eos),
            dataclasses.replace(TINY, eos_token_id=eos, pad_token_id=eos))


@pytest.mark.parametrize("num_beams,early", [(2, False), (4, False), (4, True)])
def test_beam_generate_ids_identical_to_jax_and_hf_oracle(weights, eos_cfgs, num_beams,
                                                          early):
    jp, tp = weights
    jcfg, tcfg = eos_cfgs
    feats = _pick_feats(tp, tcfg, (4, 16), num_beams, early)
    kw = dict(max_length=MAX_LEN, num_beams=num_beams, early_stopping=early)
    got = beam_generate(tp, torch.from_numpy(feats), tcfg, **kw).numpy()
    for pack in (False, True):
        want = np.asarray(j_beam(jp, jnp.asarray(feats), jcfg, pack_kv_pairs=pack, **kw))
        np.testing.assert_array_equal(got, want, err_msg=f"pack_kv_pairs={pack}")
    oracle = hf_beam_oracle(jp, feats, jcfg, MAX_LEN, num_beams, early_stopping=early)
    np.testing.assert_array_equal(got, oracle)
    # the decode is not trivial: rows differ and some end with EOS early
    assert len({tuple(r) for r in got}) > 1
    assert (got[:, 1:-1] == tcfg.eos_token_id).any()


def test_beam_generate_active_done_and_int8_identical_to_jax(weights, eos_cfgs):
    jp, tp = weights
    jcfg, tcfg = eos_cfgs
    feats = _pick_feats(tp, tcfg, (4, 16), 2, True)
    active = np.array([True, False, True, True])
    kw = dict(max_length=MAX_LEN, num_beams=2, early_stopping=True)
    ids, done = beam_generate(tp, torch.from_numpy(feats), tcfg,
                              active=torch.from_numpy(active), return_done=True, **kw)
    jids, jdone = j_beam(jp, jnp.asarray(feats), jcfg, active=jnp.asarray(active),
                         return_done=True, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert (ids.numpy()[~active] == tcfg.pad_token_id).all()
    assert done.numpy()[~active].all()

    for m in range(2, 12):
        feats8 = np.random.default_rng(m).normal(0, 3, (4, 16)).astype(np.float32)
        if beam_score_margin(tp, torch.from_numpy(feats8), tcfg, MAX_LEN, 2, True,
                             cache_dtype=torch.int8) >= MIN_BEAM_GAP:
            break
    got = beam_generate(tp, torch.from_numpy(feats8), tcfg, cache_dtype=torch.int8, **kw)
    for pack in (False, True):  # JAX never packs an int8 cache
        want = j_beam(jp, jnp.asarray(feats8), jcfg, cache_dtype=jnp.int8,
                      pack_kv_pairs=pack, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- graph-ready step, on the CPU

@pytest.mark.parametrize("early", [False, True], ids=["late", "early"])
@pytest.mark.parametrize("no_image", [False, True], ids=["t0_0", "t0_1"])
@pytest.mark.parametrize("cache", [None, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_graph_ready_step_identical_to_eager(weights, eos_cfgs, cache, no_image, early):
    """The step that CUDA graphs replay (position, slot and cur_len held on
    the device, fixed buffers, its segments run eagerly here) against the
    eager beam_generate, ids and `done` identical: two batches in turn
    through one set of buffers, whose cache starts filled with a value no
    decode writes, so a read of a stale row past the slot would show."""
    _, tp = weights
    _, tcfg = eos_cfgs
    items, k = 4, 4
    graphs = beam.StepGraphs(tp, tcfg, items, k, MAX_LEN, cache or torch.float32, 0.7,
                             early, no_image)
    for buf in graphs.cache.values():
        buf.fill_(100)
    kw = dict(max_length=MAX_LEN, num_beams=k, length_penalty=0.7, early_stopping=early,
              cache_dtype=cache, no_image=no_image, return_done=True)
    ended = 0
    for seed, active in ((2, [True, False, True, True]), (3, [True, True, True, False])):
        feats = None if no_image else torch.from_numpy(
            np.random.default_rng(seed).normal(0, 3, (items, 16)).astype(np.float32))
        act = torch.tensor(active)
        steps = beam_generate.steps
        want_ids, want_done = beam_generate(tp, feats, tcfg, active=act, batch=items, **kw)
        eager_steps, steps = beam_generate.steps - steps, beam_generate.steps
        ids, done = beam._decode(tp, feats, items, tcfg, graphs, active=act, **kw)
        assert beam_generate.steps - steps == eager_steps
        np.testing.assert_array_equal(ids.numpy(), want_ids.numpy(), err_msg=f"seed {seed}")
        np.testing.assert_array_equal(done.numpy(), want_done.numpy())
        assert done is not graphs.state["done"]
        # the device step advanced once a step, as the host's
        assert graphs.idx.tolist() == [eager_steps + 1, eager_steps + 2, eager_steps + 3]
        ended += int((ids.numpy()[np.array(active), 1:-1] == tcfg.eos_token_id).sum())
    # with features, beams finished early, so the pool and the done rule acted
    # (BOS alone leads this network to no early EOS)
    assert ended > 0 or no_image


def test_beam_attention_out_receives_the_context():
    q, k, v, anc, slot = _attn_case(3, 4, 2)
    args = [torch.from_numpy(x) for x in (q, k, v, anc)]
    want = beam_attention(*args, slot, scale=0.3)
    buf = torch.full_like(want, float("nan"))
    assert beam_attention(*args, slot, scale=0.3, out=buf) is buf
    assert torch.equal(buf, want)
    for bad in (torch.empty(want.shape, dtype=torch.float64),
                torch.empty(want.shape[0], 1, *want.shape[1:]),
                torch.empty(want.shape[::-1]).transpose(0, 2)):
        with pytest.raises(ValueError, match="out must be"):
            beam_attention(*args, slot, scale=0.3, out=bad)


def test_graph_sets_second_sight_and_lru_eviction():
    """A key gets its set the second time it is seen; two sets are kept,
    the least recently used evicted and freed; keys seen once are
    remembered up to a bound."""
    class Set:
        pass

    sets = beam._GraphSets(keep=2, remember=2)
    made = []

    def get(key):
        return sets.get(key, lambda: made.append(key) or Set())

    assert get("a") is None and made == []
    a = get("a")
    assert made == ["a"] and get("a") is a
    assert get("b") is None
    b = get("b")
    assert get("a") is a   # a is now the most recently used
    assert get("c") is None
    freed = weakref.ref(b)
    del b
    c = get("c")
    assert list(sets.sets) == ["a", "c"] and freed() is None
    assert get("c") is c and made == ["a", "b", "c"]
    for key in ("x", "y", "z"):
        assert get(key) is None
    assert get("x") is None   # forgotten: only the last two one-off keys are kept
    assert get("z") is not None
    sets.clear()
    assert not sets.sets and not sets.seen


def test_stable_topk_tie_order_matches_lax_top_k():
    """Exact ties resolve to the lower index, as jax.lax.top_k does, in f32
    and bf16, with -0.0 below +0.0 and -inf last."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, (6, 40)).astype(np.float32)
    x[0, :5] = 3.0
    x[1, 10] = -0.0
    x[1, 3] = 0.0
    x[2, ::3] = -np.inf
    for m in (1, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), m)
        tv, ti = stable_topk(torch.from_numpy(x), m)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jv, ji = jax.lax.top_k(jnp.asarray(x, jnp.bfloat16), m)
        tv, ti = stable_topk(torch.from_numpy(x).to(torch.bfloat16), m)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_beam_step_tie_order_is_lane_major_then_token():
    """Crafted logits with exact ties inside and across lanes: the first
    beam step takes its 2K candidates from lane 0 only (the other lanes
    carry -1e9), and a later step orders tied joint scores lane-major,
    then by token id, like HF's flat [B, K*V] top-k (the oracle: a stable
    argsort of the flat joint scores)."""
    k, v = 2, 10
    cfg = dataclasses.replace(TINY, vocab_size=v, eos_token_id=9, pad_token_id=9)
    logits = torch.zeros((k, v))
    logits[:, [1, 4, 6]] = 2.0          # three-way tie inside each lane
    state = beam.init_state(1, k, 6, cfg, CPU)
    new_beam, tok, state = beam.process(logits, state, 1, k, cfg, 1.0, False)
    assert new_beam.tolist() == [[0, 0]] and tok.tolist() == [1, 4]
    # both beams now score the same, so the lanes tie as well
    scores = state["beam_scores"].clone()
    assert scores[0, 0] == scores[0, 1]
    new_beam, tok, state = beam.process(logits, state, 2, k, cfg, 1.0, False)
    lse = torch.logsumexp(logits, -1, keepdim=True)
    joint = (logits - lse + scores.reshape(-1, 1)).reshape(-1).numpy()
    order = np.argsort(-joint, kind="stable")[:k]
    assert new_beam[0].tolist() == (order // v).tolist() == [0, 0]
    assert tok.tolist() == (order % v).tolist() == [1, 4]


# ------------------------------------------------------------ full model

@pytest.fixture(scope="module")
def model_setup():
    jcfg, tcfg = configs()
    gen_cfg = GenerationConfig()
    jp = JRGRG(jcfg).init(jax.random.PRNGKey(0))
    jp = {"detector": jp["detector"], "decoder": _scaled(jp["decoder"])}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    gen = ReportGenerator(tp, GPT2Tokenizer.dummy(), cfg=tcfg)
    model = RGRG(tcfg)
    for seed in range(24):
        images = list(np.random.default_rng(seed).integers(0, 256, (2, *SHAPE),
                                                           dtype=np.uint8))
        x = gen.preprocess(images)
        if not has_parity_margins(tp["detector"], x):
            continue
        det = model.detect(tp, x)
        feats = det["region_features"][det["selected_regions"]]
        if (feats.shape[0] and beam_score_margin(tp["decoder"], feats, tcfg.decoder,
                                                 8, gen_cfg.num_beams, True) >= MIN_BEAM_GAP):
            break
    else:
        raise AssertionError("no seeded input with decision margins")
    jgen = JReportGenerator(jp, JTokenizer.dummy(), cfg=jcfg, similarity_fn=None)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, gen=gen, jgen=jgen, images=images)


def _region_feats(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (2, 29, 1024)).astype(np.float32),
            rng.uniform(size=(2, 29)) < 0.3)


@pytest.mark.parametrize("early", [False, True])
def test_beam_decode_selected_and_cascade_identical_to_jax(model_setup, early):
    """num_beams=3 through a short bucket ladder (4, 8) up to max_length 12
    (so the appended last rung runs too), and the single full-length
    decode with return_done."""
    s = model_setup
    jm, tm = JRGRG(s["jcfg"]), RGRG(s["tcfg"])
    for seed in range(16):
        feats, sel = _region_feats(seed)
        if beam_score_margin(s["tp"]["decoder"], torch.from_numpy(feats[sel]),
                             s["tcfg"].decoder, MAX_LEN, 3, early) >= MIN_BEAM_GAP:
            break
    jf, js, tf, ts = jnp.asarray(feats), jnp.asarray(sel), torch.from_numpy(feats), \
        torch.from_numpy(sel)
    kw = dict(num_beams=3, early_stopping=early)
    want = jm.decode_selected_cascade(s["jp"], jf, js, MAX_LEN, buckets=(4, 8), **kw)
    got = tm.decode_selected_cascade(s["tp"], tf, ts, MAX_LEN, buckets=(4, 8), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    budget = tm.budget_for(int(sel.sum()), 2)
    want = jm.decode_selected(s["jp"], jf, js, budget, 6, return_done=True, **kw)
    got = tm.decode_selected(s["tp"], tf, ts, budget, 6, return_done=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="return_done"):
        tm.decode_selected(s["tp"], tf, ts, budget, 6, return_done=True)


def test_generate_reports_default_is_beam4_identical_to_jax(model_setup):
    """The port's generate_reports at its defaults (beam 4, early stopping)
    against the JAX package's beam-4 path, stage by stage on the JAX
    device-preprocessed batch."""
    s = model_setup
    jm = s["jgen"].model
    (batch, mats), _ = s["jgen"].preprocess_raw(s["images"])
    det = jm.detect(s["jp"], batch, mats)
    sel = det["selected_regions"]
    ids, decoded = jm.decode_selected_cascade(s["jp"], det["region_features"], sel, 8,
                                              first_count=int(jnp.sum(sel)),
                                              num_beams=4, early_stopping=True)
    ids, decoded = np.asarray(ids), np.asarray(decoded)
    got = s["gen"].generate_reports(s["images"], max_length=8)
    assert any(g.region_sentences for g in got)
    for b, g in enumerate(got):
        sents = {C.REGION_NAMES[r]: s["jgen"].tokenizer.decode(ids[b, r])
                 for r in range(C.NUM_REGIONS) if decoded[b, r]}
        assert g.region_sentences == sents
        assert g.report == j_assemble(list(sents.values()), None)
        np.testing.assert_array_equal(g.selected_regions, np.asarray(sel[b]))


def test_generate_beam_with_selection_override_identical_to_jax(model_setup):
    """RGRG.generate(num_beams=4) decodes (it raised before the beam slice)
    a caller-chosen selection, as the JAX package does."""
    s = model_setup
    (batch, mats), _ = s["jgen"].preprocess_raw(s["images"])
    x = s["jgen"].model._prepare_images(batch, mats)
    # a subset of the detector's selection, whose decisions have margins
    override = np.asarray(s["jgen"].model.detect(s["jp"], x)["selected_regions"]).copy()
    override[0, np.argmax(override[0])] = False
    want = JRGRG(s["jcfg"]).generate(s["jp"], x, max_length=8, num_beams=4,
                                     early_stopping=True,
                                     selection_override=jnp.asarray(override))
    got = RGRG(s["tcfg"]).generate(s["tp"], torch.from_numpy(np.array(x)), max_length=8,
                                   num_beams=4, early_stopping=True,
                                   selection_override=torch.from_numpy(override))
    np.testing.assert_array_equal(got["output_ids"].numpy(), np.asarray(want["output_ids"]))
    np.testing.assert_array_equal(got["decoded_mask"], override)


def test_generate_for_regions_and_boxes_identical_to_jax(model_setup):
    s = model_setup
    jm, jp, image = s["jgen"].model, s["jp"], s["images"][0]
    (batch, mats), _ = s["jgen"].preprocess_raw([image])
    det = jm.detect(jp, batch, mats)
    # selected regions (their decisions have margins) and one undetected
    sel0 = np.asarray(det["selected_regions"][0])
    names = [C.REGION_NAMES[r] for r in np.nonzero(sel0)[0][:4]]
    names += [C.REGION_NAMES[int(np.argmin(np.asarray(det["class_detected"][0])))]]
    mask = np.zeros((1, 29), bool)
    mask[0, [C.ANATOMICAL_REGIONS[n] for n in names]] = True
    mask &= np.asarray(det["class_detected"])
    ids, decoded = jm.decode_selected(jp, det["region_features"], jnp.asarray(mask),
                                      jm.budget_for(int(mask.sum()), 1), 8,
                                      num_beams=4, early_stopping=True)
    ids = np.asarray(ids)
    want = {n: s["jgen"].tokenizer.decode(ids[0, C.ANATOMICAL_REGIONS[n]])
            for n in names if decoded[0, C.ANATOMICAL_REGIONS[n]]}
    got = s["gen"].generate_for_regions(image, names, max_length=8)
    assert got and got == want

    tdet = s["tp"]["detector"]
    tmap = tdet.backbone(s["gen"].preprocess([image]))
    for seed in range(16):
        rng = np.random.default_rng(seed)
        xy = rng.uniform(0, 400, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 112, (3, 2))], 1).astype(np.float32)
        feats = tdet.region_features_from_boxes(tmap, torch.from_numpy(boxes[None]))[0]
        if beam_score_margin(s["tp"]["decoder"], feats, s["tcfg"].decoder, 8, 4,
                             True) >= MIN_BEAM_GAP:
            break
    variables = jp["detector"]
    dm = jm.detector
    fmap = dm.apply(variables, jm._prepare_images(batch, mats),
                    method=dm.backbone_features)
    region = dm.apply(variables, fmap, jnp.asarray(boxes[None]),
                      method=dm.region_features_from_boxes)[0]
    jids = j_beam(jp["decoder"], region, s["jcfg"].decoder, max_length=8, num_beams=4,
                  early_stopping=True)
    want = s["jgen"].tokenizer.batch_decode(np.asarray(jids))
    assert s["gen"].generate_for_boxes(image, boxes, max_length=8) == want
