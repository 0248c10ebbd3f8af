"""The comparison that decides `correct` for a served cell.

The program's outputs for an image are what its reports say: per region
whether it was detected, whether it was selected, its box, and for each
selected region the served token ids. The plain reference
(`reference/rgrg.py`, float32) works the image out again and judges them:

- `box_px`: each region's box against the reference's refined box of the
  same proposal, the one among the reference's proposals whose box lies
  nearest (the program names its proposal by its box; the candidates
  reach EXTRA past the cut). Its largest distance in pixels.
- `region_mismatch_pct`: the share of regions whose detection, proposal
  or selection differs from the reference's: detected where the
  reference detects nothing or the reverse, another proposal than the
  reference's best, or a selection that the reference's classifier gives
  otherwise on that proposal's features. Rounding moves these decisions
  where they near-tie, so the share is not zero; a broken detector moves
  most of them.
- `token_gap`: every selected region's served tokens, teacher-forced
  through the reference's decoder from the reference's features of that
  proposal. Greedy: the largest amount by which a served token's logit
  lies below the reference's best at its position. Beam search with K
  beams extends each hypothesis only by one of its 2K best tokens, so
  there: the largest amount by which it lies below the reference's
  2K-th best.
- `malformed`: reports that break the output's own rules (a selected
  region without a sentence or the reverse, a selection of an
  undetected region, an id outside the vocabulary); an exact count.

The control (`precision="fp8"`) takes the program's place: its own
detections are judged as the program's are, and at each position of the
program's rows it serves its own token of the rank that the served token
has by the reference (at most 2K): greedy, the token it puts first;
beam, the choice a beam search at that precision makes where the
program's beam made that choice. That token is judged against the
reference as a served one.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench.reference.rgrg import Reference

# proposals beyond the top pre_nms_top_n that the reference also works
# out: the program's bfloat16 objectness ranks some of them above the cut
# (ranks up to 1,044 of the reference's seen on the card)
EXTRA = 500


def _rank_value(logits: torch.Tensor, rank: int) -> torch.Tensor:
    return torch.topk(logits, rank, dim=-1).values[..., -1]


def _token_gaps(ref: Reference, rows: List[Dict], beams: int, judge_ctrl=None,
                block: int = 32) -> float:
    """Largest gap over the rows' positions (see the module docstring);
    with `judge_ctrl`, the gap of the control's own token of the served
    token's rank instead of the served token's."""
    d = ref.cfg["decoder"]
    rank = 1 if beams <= 1 else 2 * beams
    worst = 0.0
    for at in range(0, len(rows), block):
        part = rows[at:at + block]
        length = max(len(r["tokens"]) for r in part)
        inputs = torch.full((len(part), length), d["pad_token_id"], dtype=torch.long,
                            device=ref.device)
        target = torch.full_like(inputs, -1)
        for i, r in enumerate(part):
            toks = torch.as_tensor(r["tokens"], dtype=torch.long, device=ref.device)
            inputs[i, 0] = d["bos_token_id"]
            inputs[i, 1:len(toks)] = toks[:-1]
            target[i, :len(toks)] = toks
        feats = torch.stack([r["features"] for r in part])
        logits = ref.decoder_logits(feats, inputs)
        bar = _rank_value(logits, rank)
        if judge_ctrl is None:
            chosen = target.clamp(min=0)
        else:
            ctrl, ctrl_feats = judge_ctrl
            c_logits = ctrl.decoder_logits(torch.stack([ctrl_feats[id(r)] for r in part]),
                                           inputs)
            # the served token's rank by the reference (1 = its best), at
            # most 2K: the control serves its own token of that rank
            served = torch.gather(logits, -1, target.clamp(min=0)[..., None])
            by_rank = (logits > served).sum(-1).clamp(max=rank - 1)
            chosen = torch.gather(torch.topk(c_logits, rank, dim=-1).indices, -1,
                                  by_rank[..., None])[..., 0]
        got = torch.gather(logits, -1, chosen[..., None])[..., 0]
        gap = torch.where(target >= 0, (bar - got).clamp(min=0.0), 0.0)
        worst = max(worst, float(gap.max()))
    return worst


def _regions(det: Dict, out: Dict, thr: float) -> Dict:
    """One image: the program's regions against the reference's."""
    r = det["detected"].shape[0]
    boxes = torch.as_tensor(out["boxes"], dtype=torch.float32, device=det["refined"].device)
    dist = (det["refined"] - boxes[None]).abs().amax(-1)               # [K', R]
    best = dist.min(0)
    k_p, d = best.indices, best.values
    detected = torch.as_tensor(out["detected"], device=k_p.device)
    selected = torch.as_tensor(out["selected"], device=k_p.device)
    sel_ref = detected & (det["selection"][k_p] > thr)
    mismatch = ((detected != det["detected"]) | (detected & (k_p != det["top_idx"]))
                | (selected != sel_ref))
    malformed = int((selected & ~detected).sum())
    return {"k_p": k_p.tolist(), "box_px": float(d.max()) if r else 0.0,
            "mismatch": int(mismatch.sum()), "malformed": malformed}


def judge(ref: Reference, images_u8: torch.Tensor, outputs: List[Dict], beams: int,
          control: Reference = None, block: int = 8) -> Dict[str, Dict[str, float]]:
    """images_u8 [N, H, W] on the reference's device; outputs[i] the
    program's reports of image i: {"detected" [R], "selected" [R],
    "boxes" [R, 4], "tokens": {region: [ids]}}. Returns {"program":
    numbers} and, with a control, {"control": numbers}."""
    thr = ref.cfg["logit_threshold"]
    vocab = ref.cfg["decoder"]["vocab_size"]
    result = {"program": {"box_px": 0.0, "region_mismatch_pct": 0.0, "malformed": 0}}
    if control is not None:
        result["control"] = dict(result["program"])
    rows, ctrl_feats, regions = [], {}, 0
    mism = {"program": 0, "control": 0}
    for at in range(0, len(outputs), block):
        imgs = images_u8[at:at + block]
        dets = ref.detect(imgs, extra=EXTRA)
        ctrl_dets = control.detect(imgs) if control is not None else None
        for i, det in enumerate(dets):
            out = outputs[at + i]
            got = _regions(det, out, thr)
            regions += len(got["k_p"])
            p = result["program"]
            p["box_px"] = max(p["box_px"], got["box_px"])
            mism["program"] += got["mismatch"]
            bad = got["malformed"]
            for j, k in enumerate(got["k_p"]):
                toks = out["tokens"].get(j)
                if bool(out["selected"][j]) != (toks is not None):
                    bad += 1
                    continue
                if toks is None:
                    continue
                if not toks or any(t < 0 or t >= vocab for t in toks):
                    bad += 1
                    continue
                row = {"features": det["features"][k], "tokens": toks}
                rows.append(row)
                if ctrl_dets is not None:
                    ctrl_feats[id(row)] = control.region_features(
                        ctrl_dets[i]["c5"], det["boxes"][k:k + 1])[0]
            p["malformed"] += bad
            if ctrl_dets is not None:
                c = ctrl_dets[i]
                ridx = torch.arange(c["detected"].shape[0], device=c["refined"].device)
                c_out = {"detected": c["detected"],
                         "selected": c["detected"] & (c["selection"][c["top_idx"]] > thr),
                         "boxes": c["refined"][c["top_idx"], ridx]}
                c_got = _regions(det, c_out, thr)
                cc = result["control"]
                cc["box_px"] = max(cc["box_px"], c_got["box_px"])
                mism["control"] += c_got["mismatch"]
    for side in result:
        result[side]["region_mismatch_pct"] = 100.0 * mism[side] / max(regions, 1)
    result["program"]["token_gap"] = _token_gaps(ref, rows, beams)
    if control is not None:
        result["control"]["token_gap"] = _token_gaps(ref, rows, beams, (control, ctrl_feats))
        result["control"]["malformed"] = 0
    result["program"]["rows"] = len(rows)
    return result
