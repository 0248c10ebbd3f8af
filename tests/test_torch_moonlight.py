"""The Moonlight (DeepSeek-V3 block) decoder of the port against its plain
float32 reference (tests/moonlight_ref.py), at a tiny size on the CPU.

- prefill and the greedy step: the logits at every position agree with
  the reference's teacher-forced full forward;
- the beam step: each lane's logits agree with the reference run over the
  tokens of that lane's ancestry, eagerly and through the graph-ready
  step's segments (decode/beam.StepGraphs, run eagerly here);
- the sort-based expert dispatch (ops/moe.py) against a per-expert loop,
  where the correction bias decides the choice and where an expert gets
  no rows, with the device counters it keeps;
- a small run through `generate_reports_pipelined` at greedy and beam 2;
- what the decoder does not do raises NotImplementedError.

Routing near-ties would let the two sides pick different experts by
rounding alone, so every input here asserts that each routing decision of
the reference clears ROUTE_MARGIN. Logits agree to LOGIT_TOL: both sides
compute in float32, in another order (absorbed against non-absorbed
attention, sorted against looped experts), ~1e-6 of logits of size ~5.

The card's tests of the same decoder (graph replay, sync-free capture,
full width against the benchmark's reference) are marked `cuda` at the
end and skip here.
"""

import numpy as np
import pytest
import torch

from rgrg_tpu_torch.core import config as TC
from rgrg_tpu_torch.decode import beam
from rgrg_tpu_torch.models import decoder_module, moonlight as ml
from rgrg_tpu_torch.ops import moe as moe_ops
from tests import moonlight_ref as ref

TINY = TC.MoonlightConfig(
    vocab_size=300, hidden_dim=64, num_heads=4, num_layers=3, bos_token_id=297,
    eos_token_id=299, pad_token_id=299, image_feature_dim=32, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
    moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2)
# N(0, 0.02) at width 64 gives logits within ~0.1 of each other: scaled up
# so that tokens and experts win by margins rounding cannot close
WEIGHT_SCALE = 10.0
LOGIT_TOL = 5e-5
ROUTE_MARGIN = 1e-4
# full width, bf16 against the float32 reference, the mean |logit error| over
# 16 rows x 5 positions: bf16 rounding flips near-tied routing choices and a
# flip moves every later layer's, so most rows route otherwise by the last
# layers; bf16 reads 0.21-0.30 and float8 operands 0.56-0.58 (logit std
# 0.905; measured on one NVIDIA H100). The
# largest error (2.5-4.0 and 3.8-4.6) cannot tell the two apart.
FULL_WIDTH_MEAN_TOL = 0.42


def scaled_params(cfg, seed=0):
    p = ml.init_decoder_params(torch.Generator().manual_seed(seed), cfg)

    def scale(t):
        for k, v in t.items():
            if isinstance(v, dict):
                scale(v)
            elif v.ndim >= 2 or k == "bias":
                v.mul_(WEIGHT_SCALE)
    scale(p)
    return p


@pytest.fixture(scope="module")
def params():
    return scaled_params(TINY)


def route_margin(w, d, m, prefix):
    """The least gap between an expert chosen and one not, over rows m."""
    s = torch.sigmoid(m @ w[prefix + "router"].float().T) + w[prefix + "bias"].float()
    top = torch.topk(s, d["num_experts_per_tok"] + 1, dim=-1).values
    return float((top[:, -2] - top[:, -1]).min())


def reference(params, feats, inputs):
    """The reference's logits, and the least routing margin over every
    expert layer and position."""
    w, d = ref.flatten(params), ref.sizes(TINY)
    margins = []
    orig = ref.moe

    def tapped(m, w_, p, d_):
        margins.append(route_margin(w_, d_, m, p))
        return orig(m, w_, p, d_)
    ref.moe = tapped
    try:
        logits = ref.decoder_logits(w, d, feats, inputs)
    finally:
        ref.moe = orig
    return logits, min(margins)


def test_prefill_and_greedy_steps_match_the_reference(params):
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(3, TINY.image_feature_dim, generator=g)
    toks = torch.randint(0, 297, (3, 7), generator=g)
    logits, cache = ml.prefill(params, feats, TINY.bos_token_id, 8, TINY)
    out = [logits]
    for t in range(toks.shape[1]):
        logits, cache = ml.decode_step(params, toks[:, t], t, cache, TINY)
        out.append(logits)
    inputs = torch.cat([torch.full((3, 1), TINY.bos_token_id), toks], 1)
    want, margin = reference(params, feats, inputs)
    assert margin > ROUTE_MARGIN
    torch.testing.assert_close(torch.stack(out, 1), want, rtol=0, atol=LOGIT_TOL)


def lanes_history(anc_steps, tokens, b, k):
    """Each lane's tokens after every step, following the reorders."""
    hist = [[[TINY.bos_token_id] for _ in range(k)] for _ in range(b)]
    out = []
    for parents, tok in zip(anc_steps, tokens):
        hist = [[hist[i][int(parents[i, j])] + [int(tok[i * k + j])] for j in range(k)]
                for i in range(b)]
        out.append([h for item in hist for h in item])
    return out


@pytest.mark.parametrize("graph_ready", [False, True], ids=["eager", "segments"])
def test_each_beam_lane_matches_the_reference_over_its_ancestry(params, graph_ready):
    """Three items of three beams through five steps whose parents and
    tokens are drawn at random; the ancestry table and the cache evolve as
    beam search evolves them (reorder_ancestry, one slot a step)."""
    b, k, steps, max_length = 3, 3, 5, 8
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(b, TINY.image_feature_dim, generator=g)
    t_total = max_length + 1
    logits0, cache = ml.prefill(params, feats.repeat_interleave(k, 0), TINY.bos_token_id,
                                max_length, TINY)
    anc = torch.arange(k, dtype=torch.int32)[None, :, None].expand(b, k, t_total).contiguous()
    parents = [torch.zeros(b, k, dtype=torch.long)]
    tokens = [torch.randint(0, 297, (b * k,), generator=g)]
    anc = beam.reorder_ancestry(anc, parents[0], 2)
    if graph_ready:
        graphs = beam.StepGraphs(params, TINY, b, k, max_length, torch.float32, 1.0, False,
                                 False)
        cache = ml.cache_to_beam_layers(cache, out=graphs.cache)
    got = []
    for t in range(steps):
        if graph_ready:
            # the set's step with its parents and tokens set by hand
            graphs.tok.copy_(tokens[-1])
            graphs.anc.copy_(anc)
            graphs.idx.copy_(torch.tensor([t + 1, t + 2, t + 3]))
            x = ml.beam_embed(params, graphs.tok, graphs.idx[0:1], TINY)
            x = ml.beam_layers(params, x, graphs.cache, graphs.idx[1:2], graphs.anc, TINY)
            logits = ml._logits(params, x, TINY)
        else:
            logits, cache = ml.decode_step_beam(params, tokens[-1], t, cache, anc, TINY)
        got.append(logits)
        parents.append(torch.randint(0, k, (b, k), generator=g))
        tokens.append(torch.randint(0, 297, (b * k,), generator=g))
        anc = beam.reorder_ancestry(anc, parents[-1], t + 3)
    hist = lanes_history(parents, tokens, b, k)
    for t in range(steps):
        inputs = torch.tensor(hist[t])                     # [B*K, t + 2]
        want, margin = reference(params, feats.repeat_interleave(k, 0), inputs)
        assert margin > ROUTE_MARGIN
        torch.testing.assert_close(got[t], want[:, -1], rtol=0, atol=LOGIT_TOL)


def test_graph_ready_beam_decode_equals_the_eager_decode(params):
    """beam_generate's search through a StepGraphs set (its one segment
    run eagerly on the CPU) serves the ids of the eager search."""
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(4, TINY.image_feature_dim, generator=g)
    kw = dict(max_length=9, num_beams=3, length_penalty=1.0, early_stopping=False,
              active=None, cache_dtype=None, return_done=True, no_image=False)
    graphs = beam.StepGraphs(params, TINY, 4, 3, 9, torch.float32, 1.0, False, False)
    assert graphs.segments == 1
    ids_g, done_g = beam._decode(params, feats, 4, TINY, graphs, **kw)
    ids_e, done_e = beam._decode(params, feats, 4, TINY, None, **kw)
    assert torch.equal(ids_g, ids_e) and torch.equal(done_g, done_e)


# ------------------------------------------------------------------ experts

def moe_params(seed, bias_shift=None):
    g = torch.Generator().manual_seed(seed)
    e, d, i = 8, 16, 8

    def n(*shape):
        return torch.randn(shape, generator=g)
    p = {"router": n(e, d), "bias": n(e) * 0.5, "gate_up": n(e, d, 2 * i) * 0.3,
         "down": n(e, i, d) * 0.3, "shared_gate_up": n(d, 2 * i) * 0.3,
         "shared_down": n(i, d) * 0.3}
    if bias_shift is not None:
        p["bias"] = p["bias"] + bias_shift
    return p


def loop_moe(m, p, top_k):
    w = {"x." + k: v for k, v in p.items()}
    d = {"num_experts_per_tok": top_k, "norm_topk_prob": True,
         "routed_scaling_factor": TINY.routed_scaling_factor}
    return ref.moe(m, w, "x.", d), route_margin(w, d, m, "x.")


@pytest.mark.parametrize("case", ["random", "bias_decides", "idle_expert"])
def test_sorted_dispatch_matches_a_loop_over_experts(case):
    shift = {"random": None,
             # expert 3 wins every row on the bias alone: its score never would
             "bias_decides": torch.tensor([0.0, 0, 0, 4.0, 0, 0, 0, 0]),
             # expert 5 is never chosen
             "idle_expert": torch.tensor([0.0, 0, 0, 0, 0, -4.0, 0, 0])}[case]
    p = moe_params(4, shift)
    m = torch.randn(40, 16, generator=torch.Generator().manual_seed(5))
    counters = torch.zeros((2, 2, 8), dtype=torch.int64)
    got = moe_ops.moe(m, p, 2, TINY.routed_scaling_factor, True, counters, layer=1)
    want, margin = loop_moe(m, p, 2)
    assert margin > ROUTE_MARGIN
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    choice, _ = moe_ops.route(m, p["router"], p["bias"], 2, 1.0, True)
    rows = torch.bincount(choice.reshape(-1), minlength=8)
    assert torch.equal(counters[0, 1], rows) and torch.equal(counters[1, 1], (rows > 0).long())
    assert not counters[:, 0].any()
    if case == "bias_decides":
        scores = torch.sigmoid(m @ p["router"].T)
        assert (choice == 3).any(-1).all()
        assert not (torch.topk(scores, 2, -1).indices == 3).any(-1).all()
    if case == "idle_expert":
        assert rows[5] == 0 and counters[1, 1, 5] == 0


# -------------------------------------------------------- the serving path

@pytest.fixture(scope="module")
def tiny_gen():
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
    import dataclasses
    dec = dataclasses.replace(TINY, image_feature_dim=1024, vocab_size=300)
    cfg = TC.ModelConfig(detector=TC.DetectorConfig(
        backbone_stages=(1, 1, 1, 1), rpn=TC.RPNConfig(pre_nms_top_n_test=32)), decoder=dec)
    params = RGRG(cfg).init(0, "cpu")
    params["decoder"] = scaled_params(dec)
    with torch.no_grad():   # select every detected region
        params["detector"].selection_classifier.fc2.bias += 50.0
    return ReportGenerator(params, GPT2Tokenizer.dummy(), cfg=cfg, similarity_fn=None)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_reports_served_through_the_pipelined_server(tiny_gen, num_beams):
    from rgrg_tpu_torch.serving import generate_reports_pipelined
    from rgrg_tpu_torch.utils import logging as L
    images = list(np.random.default_rng(0).integers(0, 256, (4, 300, 260), dtype=np.uint8))
    moe_ops._COUNTERS.clear()
    c0 = L.counters()
    batches = list(generate_reports_pipelined(tiny_gen, images, batch_size=2,
                                              num_beams=num_beams, max_length=6,
                                              kv_cache_dtype=None))
    c1 = L.counters(device=True)
    reports = [r for b in batches for r in b]
    assert len(reports) == 4
    assert sum(len(r.region_sentences) for r in reports) == sum(
        int(r.selected_regions.sum()) for r in reports) > 0
    counted = "beam_generate" if num_beams > 1 else "greedy_generate"
    steps = c1[f"{counted}.steps"] - c0[f"{counted}.steps"]
    assert steps > 0
    # every expert layer routed each lane of each prefill and step to top_k experts
    rows = np.asarray(c1["moe.expert_rows"])
    assert rows.shape == (TINY.num_moe_layers, TINY.n_routed_experts)
    per_layer = rows.sum(1)
    assert (per_layer == per_layer[0]).all() and per_layer[0] % TINY.num_experts_per_tok == 0
    assert (np.asarray(c1["moe.expert_steps"]) <= steps + 2 * len(batches) * 4).all()


def test_what_the_decoder_does_not_do_raises(params):
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.decode.sample import sample_generate
    with pytest.raises(NotImplementedError, match="Moonlight"):
        beam_generate(params, None, TINY, max_length=4, num_beams=2, no_image=True, batch=2)
    with pytest.raises(NotImplementedError, match="moonlight"):
        sample_generate(params, torch.zeros(2, 32), torch.Generator(), TINY, max_length=4)
    with pytest.raises(NotImplementedError, match="Moonlight"):
        ml.prefill(params, torch.zeros(2, 32), TINY.bos_token_id, 4, TINY,
                   cache_dtype=torch.int8)
    assert decoder_module(TINY) is ml and decoder_module(TC.DecoderConfig()).__name__.endswith(
        "gpt2")


# ------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, device, dtype=None):
    return {k: _to(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype if v.is_floating_point() else None) for k, v in tree.items()}


def _graph_and_eager_ids(params, cfg, feats, k, max_length):
    """Ids of beam_generate's search with its step replayed from CUDA
    graphs, and of the same search with every step run eagerly through the
    same set's segments (the set never captured)."""
    kw = dict(max_length=max_length, num_beams=k, length_penalty=1.0, early_stopping=False,
              active=None, cache_dtype=None, return_done=False, no_image=False)
    dtype = params["wte"]["embedding"].dtype
    b = feats.shape[0]
    graphs = beam.StepGraphs(params, cfg, b, k, max_length, dtype, 1.0, False, False)
    replayed = beam._decode(params, feats, b, cfg, graphs, **kw)
    assert graphs.graphs is not None and len(graphs.graphs) == 1
    eager = beam.StepGraphs(params, cfg, b, k, max_length, dtype, 1.0, False, False)
    eager.capture = eager.step       # each step eagerly, as the capture's warm-up runs it
    return replayed, beam._decode(params, feats, b, cfg, eager, **kw), graphs


@pytest.mark.cuda
def test_replayed_steps_serve_the_eager_ids_tiny_bf16(cuda, params):
    feats = torch.randn(4, TINY.image_feature_dim, generator=torch.Generator().manual_seed(6))
    got, want, _ = _graph_and_eager_ids(_to(params, cuda, torch.bfloat16), TINY,
                                        feats.to(cuda), 3, 10)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_float32_experts_on_the_card_raise(cuda, params):
    feats = torch.randn(2, TINY.image_feature_dim, device=cuda)
    with pytest.raises(NotImplementedError, match="Moonlight"):
        ml.prefill(_to(params, cuda), feats, TINY.bos_token_id, 4, TINY)


def _full_width(cuda):
    """The benchmark's Moonlight weights at the published sizes (bf16, 32
    GB), the program's params over them, and the reference."""
    import os
    from port_bench.run import BENCH, load_json, load_module
    drv = load_module(os.path.join(BENCH, "drivers", "serve_pipelined_moe.py"))
    cfg = load_json(BENCH, "configs", "rgrg-moonlight-serve-bf16.json")
    w = drv.make_weights(cfg, 7, cuda)
    mcfg = drv.moonlight_config(cfg)
    return cfg, w, mcfg.decoder, drv.moonlight_params(w, mcfg, cuda)["decoder"]


@pytest.fixture(scope="module")
def full_width(cuda):
    out = _full_width(cuda)
    yield out
    del out
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_replayed_steps_serve_the_eager_ids_full_width_bf16(cuda, full_width):
    _, _, cfg, params = full_width
    feats = torch.randn(4, 1024, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    got, want, graphs = _graph_and_eager_ids(params, cfg, feats, 4, 6)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_captured_step_reads_nothing_on_the_host(cuda, full_width):
    """Capture and replay, and the step's segment run eagerly, under sync
    debug mode "error": the routing, the dispatch and the attention through
    the ancestry never wait for the device."""
    _, _, cfg, params = full_width
    feats = torch.randn(4, 1024, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    _, _, graphs = _graph_and_eager_ids(params, cfg, feats, 4, 6)
    fresh = beam.StepGraphs(params, cfg, 4, 4, 6, torch.bfloat16, 1.0, False, False)
    fresh.load(graphs.tok, graphs.anc, graphs.state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fresh.capture(2)
        fresh.step(3)
        fresh._segment(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_full_width_logits_match_the_benchmarks_reference(cuda, full_width):
    """Prefill and four greedy steps of 16 rows at the published sizes in
    bf16 against the plain float32 reference's full forward
    (port_bench/reference/moonlight.py) over the same tokens: the mean
    error below FULL_WIDTH_MEAN_TOL, the float8 control's above it."""
    from port_bench.reference.moonlight import Reference
    bench_cfg, w, cfg, params = full_width
    g = torch.Generator(cuda).manual_seed(10)
    feats = torch.randn(16, 1024, device=cuda, generator=g)
    toks = torch.randint(0, cfg.vocab_size - 2, (16, 4), device=cuda, generator=g)
    with torch.inference_mode():
        logits, cache = ml.prefill(params, feats, cfg.bos_token_id, 5, cfg)
        out = [logits]
        for t in range(4):
            logits, cache = ml.decode_step(params, toks[:, t], t, cache, cfg)
            out.append(logits)
        got = torch.stack(out, 1).float()
        inputs = torch.cat([torch.full((16, 1), cfg.bos_token_id, device=cuda), toks], 1)
        want = Reference(bench_cfg, w).decoder_logits(feats, inputs)
        ctrl = Reference(bench_cfg, w, precision="fp8").decoder_logits(feats, inputs)
    err, ctrl_err = float((got - want).abs().mean()), float((ctrl - want).abs().mean())
    print(f"full width: mean |logit error| {err:.4f}, the control's {ctrl_err:.4f}, "
          f"logit std {float(want.std()):.4f}")
    assert err < FULL_WIDTH_MEAN_TOL < ctrl_err
