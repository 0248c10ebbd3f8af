"""Operations and bytes of the Moonlight decoder's served work, counted
from the shapes of `configs/rgrg-moonlight-serve-bf16.json` (2 operations
per multiply-add), for `serve_mfu.moe` and `moe_roofline`.

A token of one lane costs 2 x its active parameters (attention's four
matrices, the dense SwiGLU or the router, its top-k routed experts and
the shared ones, the untied head) plus the absorbed attention over the
slots it reads: per head a score of R + dr and a sum of R wide rows. A
decoded row costs its prefill once (the feature transform, each layer's
image row, BOS over two slots) and one step per generated token after
the first on each beam lane, as counts/serve.py counts GPT-2's rows.

The expert layers' bytes a traced slice needs: each expert's three
matrices once in every step in which it took a row (`moe.expert_steps`),
and each routed row gathered (read and written) and its output written
(`moe.expert_rows`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from port_bench.counts import serve

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}

# the kernels of an expert layer in a device trace are found by launch order
# (the decode step is one graph on one stream, and prefill runs on the same
# stream): the grouped products come in pairs, gate|up then down, one pair a
# layer and call, by cutlass's GroupProblemShape GEMM on the H100 with torch
# 2.11; the layer's expert work runs from just after the route's top-k to
# just before the shared experts' first product
GROUPED = "GroupProblemShape"
COPIES = ("Memcpy", "Memset")


def _gemm(name: str) -> bool:
    low = name.lower()
    return GROUPED not in name and ("gemm" in low or "nvjet" in low or "xmma" in low)


def active_params(cfg: Dict) -> Dict[str, float]:
    """Matrix parameters one token multiplies by, per kind of layer."""
    d = cfg["decoder"]
    hid, h, r = d["hidden_size"], d["num_attention_heads"], d["kv_lora_rank"]
    dn, dr, dv = d["qk_nope_head_dim"], d["qk_rope_head_dim"], d["v_head_dim"]
    im = d["moe_intermediate_size"]
    attn = hid * h * (dn + dr) + hid * (r + dr) + r * h * (dn + dv) + h * dv * hid
    dense = 3 * hid * d["intermediate_size"]
    moe = (d["n_routed_experts"] * hid + d["num_experts_per_tok"] * 3 * hid * im
           + d["n_shared_experts"] * 3 * hid * im)
    return {"attn": attn, "dense": dense, "moe": moe, "head": hid * d["vocab_size"]}


def token_flops(cfg: Dict, slots: int) -> float:
    """One token of one lane through the decoder, attending `slots` cache
    slots, and the head."""
    d = cfg["decoder"]
    p = active_params(cfg)
    layers, dense = d["num_hidden_layers"], d["first_k_dense_replace"]
    r, dr, h = d["kv_lora_rank"], d["qk_rope_head_dim"], d["num_attention_heads"]
    per_layer = 2.0 * p["attn"] + 2.0 * h * slots * (2 * r + dr)
    return (layers * per_layer + dense * 2.0 * p["dense"] + (layers - dense) * 2.0 * p["moe"]
            + 2.0 * p["head"])


def row_flops(cfg: Dict, generated: int, beams: int) -> float:
    """A decoded row that generated `generated` tokens: the prefill once,
    then one step per token after the first on each of `beams` lanes; the
    step for token i (i >= 2) attends i + 1 slots."""
    d = cfg["decoder"]
    hid = d["hidden_size"]
    prefill = 2.0 * (cfg["region_feature_dim"] * hid + hid * hid)
    prefill += d["num_hidden_layers"] * 2.0 * hid * (d["kv_lora_rank"] + d["qk_rope_head_dim"])
    prefill += token_flops(cfg, 2)
    steps = sum(token_flops(cfg, i + 1) for i in range(2, generated + 1))
    return prefill + max(beams, 1) * steps


def window_flops(cfg: Dict, traffic: Dict, works: Iterable[Dict]) -> float:
    """The served batches' operations: each image's resize and detector
    (counts/serve.py), each decoded row's."""
    cap = traffic["max_length"] - 1
    total = 0.0
    for w in works:
        total += w["images"] * serve.detector_flops(cfg, traffic["image_shape"])
        for n in w["row_tokens"]:
            total += row_flops(cfg, min(n + 1, cap), traffic["num_beams"])
    return total


def expert_bytes(cfg: Dict, rows: List[List[int]], steps: List[List[int]]) -> float:
    """Bytes the expert layers need for `rows` and `steps` ([layers][experts])."""
    d = cfg["decoder"]
    elem = ELEM[cfg["decoder_dtype"]]
    hid, im = d["hidden_size"], d["moe_intermediate_size"]
    weights = 3.0 * hid * im * elem * sum(map(sum, steps))
    return weights + 3.0 * hid * elem * sum(map(sum, rows))


def expert_kernels(events) -> List[int]:
    """Indexes into `events` (name, start us, end us) of the expert layers'
    kernels: for each pair of grouped products, the dispatch before the
    first (back to the route's top-k or an earlier product: the routing
    weights' normalisation, the sort by expert, the group ends, the row
    gather), both products and the SwiGLU between them, and the combine
    after the second (forward to the next product, the shared experts'
    gate|up: the un-permute and the weighted sum). Copies are left out."""
    order = sorted(range(len(events)), key=lambda i: events[i][1])
    names = [events[i][0] for i in order]
    grouped = [j for j, n in enumerate(names) if GROUPED in n]
    keep = set()
    for first, second in zip(grouped[0::2], grouped[1::2]):
        lo = first
        while lo > 0 and not (_gemm(names[lo - 1]) or GROUPED in names[lo - 1]
                              or "topk" in names[lo - 1].lower()):
            lo -= 1
        hi = second
        while hi + 1 < len(names) and not (_gemm(names[hi + 1]) or GROUPED in names[hi + 1]):
            hi += 1
        keep.update(j for j in range(lo, hi + 1) if not names[j].startswith(COPIES))
    return sorted(order[j] for j in keep)


def expert_seconds(events) -> float:
    """Device seconds of the expert layers' kernels (`expert_kernels`)
    among trace events (name, start us, end us)."""
    return sum(events[i][2] - events[i][1] for i in expert_kernels(events)) * 1e-6
