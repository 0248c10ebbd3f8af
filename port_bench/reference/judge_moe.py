"""The comparison that decides `correct` for a served cell whose decoder
routes tokens over experts: `judge_serve.judge`'s numbers, and beside
`token_gap` (the worst served position) two more of the same gaps:

- `token_gap_mean`, the mean gap over every served position;
- `token_rows_far_pct`, the share of served rows (in %) that hold a
  position whose gap exceeds FAR of the distance from the reference's
  bar there (its 2K-th best logit) down to its mean logit: 0 for a token
  at the bar, about 1 for a token drawn from the whole vocabulary, at
  any width and vocabulary.

Why not the worst position. With random weights a sigmoid router over 64
experts puts the sixth and seventh expert of a token within ~0.02 of each
other, and bfloat16 activations move a score by ~1e-3: somewhere in 26
expert layers a token's choice flips, and the flipped expert's output
moves every later layer's input, whose choices then flip too. By the last
layers most rows of a bfloat16 program route otherwise than the float32
reference (16 rows of 16, measured on one H100), so the worst position
reads alike at bfloat16 and at the float8 control (logit errors up to
2.5-4.0 and 3.8-4.6), while the mean separates them (0.21-0.30 against
0.56-0.58 of logits of std 0.905).

Why the far rows too. The mean is spread over ~58 positions a row: a
wrong token in every row moves it well past its limit (the second token of
each row moved half the vocabulary on: 1.87-1.89 against 0.13 sound, on
one H100), but the same in a tenth of the rows would move it by ~0.17
only. Such a row holds a position that rounding gives almost no row
(past FAR: 0-0.76% of sound rows, every altered row, 42-51% of the
float8 control's rows), and the share of those rows sees it.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench.reference import judge_serve


# a served position's gap, as a share of the distance from the bar down to the
# mean logit there: sound bfloat16 rows reach up to 0.97 and a token moved
# half the vocabulary on at least 0.85 (12 and 3 seeds on one H100)
FAR = 0.8


def token_gaps(ref, rows: List[Dict], beams: int, judge_ctrl=None, block: int = 32):
    """`judge_serve._token_gaps`'s gap at every served position: returns
    (the largest, their sum, how many, and each row's largest as a share
    of the distance from the bar down to the mean logit at its position)."""
    d = ref.cfg["decoder"]
    rank = 1 if beams <= 1 else 2 * beams
    worst, total, count, row_worst = 0.0, 0.0, 0, []
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
        logits = ref.decoder_logits(torch.stack([r["features"] for r in part]), inputs)
        bar = torch.topk(logits, rank, dim=-1).values[..., -1]
        if judge_ctrl is None:
            chosen = target.clamp(min=0)
        else:
            ctrl, ctrl_feats = judge_ctrl
            c_logits = ctrl.decoder_logits(torch.stack([ctrl_feats[id(r)] for r in part]),
                                           inputs)
            served = torch.gather(logits, -1, target.clamp(min=0)[..., None])
            by_rank = (logits > served).sum(-1).clamp(max=rank - 1)
            chosen = torch.gather(torch.topk(c_logits, rank, dim=-1).indices, -1,
                                  by_rank[..., None])[..., 0]
        got = torch.gather(logits, -1, chosen[..., None])[..., 0]
        gap = torch.where(target >= 0, (bar - got).clamp(min=0.0), 0.0)
        worst = max(worst, float(gap.max()))
        total += float(gap.sum())
        count += int((target >= 0).sum())
        row_worst += (gap / (bar - logits.float().mean(-1))).amax(-1).tolist()
    return worst, total, count, row_worst


def judge(ref, images_u8: torch.Tensor, outputs: List[Dict], beams: int, control=None,
          block: int = 8) -> Dict[str, Dict[str, float]]:
    """`judge_serve.judge`, each side's numbers with `token_gap_mean` and
    `token_rows_far_pct`."""
    extra = {}

    def gaps(ref_, rows, beams_, judge_ctrl=None, block=32):
        worst, total, count, row_worst = token_gaps(ref_, rows, beams_, judge_ctrl, block)
        far = sum(g > FAR for g in row_worst)
        extra["program" if judge_ctrl is None else "control"] = {
            "token_gap_mean": total / max(count, 1),
            "token_rows_far_pct": 100.0 * far / max(len(row_worst), 1)}
        return worst

    orig = judge_serve._token_gaps
    judge_serve._token_gaps = gaps
    try:
        result = judge_serve.judge(ref, images_u8, outputs, beams, control, block)
    finally:
        judge_serve._token_gaps = orig
    for side, numbers in extra.items():
        result[side].update(numbers)
    return result
