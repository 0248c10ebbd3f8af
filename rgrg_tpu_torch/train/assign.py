"""Training-time target assignment and balanced sampling, static shapes,
batched over images.

  - `match_anchors`: each anchor's best gt by IoU; below `low` -> background
    (-1), between `low` and `high` -> discard (-2). With low-quality matches
    allowed, the anchors that tie a gt's best IoU get back their ORIGINAL
    best match (which may be another gt than the tying one), as
    torchvision's Matcher does.
  - `sample_pos_neg`: up to batch * fraction random positives, negatives
    fill the rest. A subset is chosen by ranking uniform keys (ineligible
    entries get +inf) and keeping the ranks below the budget.

Every uniform draw of the training path goes through `uniform`, from a
`torch.Generator` on the tensors' device, or from a sequence of given
arrays replayed in call order (how the tests feed the JAX package's draws,
which torch cannot reproduce, and how a card run is held to a CPU run).
Under a data-parallel mesh (core/mesh.current) each rank draws at the
global batch's shape, from a generator seeded alike on every rank (or the
global replay), and keeps its own rows: the draws do not depend on the
number of ranks.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Union

import numpy as np
import torch

from rgrg_tpu_torch.core import mesh as mesh_lib
from rgrg_tpu_torch.ops.boxes import box_iou

BELOW_LOW = -1
BETWEEN = -2

# a torch.Generator, or an iterator of arrays replayed in call order
Rng = Union[torch.Generator, Iterator]


def uniform(rng: Rng, shape, device: torch.device) -> torch.Tensor:
    """Uniform [0, 1) f32 draws of `shape` on `device`: from the generator,
    or the next array of a replay (which must have the global shape).
    `shape` is this rank's rows of the mesh's global batch
    (core/mesh.current): the draw is made at the global shape and cut to
    them."""
    shape = tuple(shape)
    mesh = mesh_lib.current()
    full = (shape[0] * mesh.size,) + shape[1:]
    if isinstance(rng, torch.Generator):
        keys = torch.rand(full, generator=rng, device=device)
    else:
        keys = torch.as_tensor(np.asarray(next(rng), np.float32))
        if tuple(keys.shape) != full:
            raise ValueError(f"replayed draw has shape {tuple(keys.shape)}, wanted {full}")
        keys = keys.to(device)
    return keys[mesh_lib.batch_sharded(full[0], mesh)]


class MatchResult(NamedTuple):
    matched_idx: torch.Tensor   # [B, N] int64: gt index (>= 0), or -1 / -2
    matched_vals: torch.Tensor  # [B, N] best IoU per anchor


def match_anchors(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  anchors: torch.Tensor, high: float, low: float,
                  allow_low_quality: bool) -> MatchResult:
    """gt_boxes [B, G, 4] (padded), gt_valid [B, G] bool, anchors [N, 4] or
    [B, N, 4]. Invalid gts never match; the first maximum wins a tie."""
    iou = box_iou(gt_boxes, anchors)                             # [B, G, N]
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_vals = iou.max(dim=1).values                         # [B, N]
    matches = torch.argmax(iou, dim=1)                           # first max
    all_matches = matches
    matches = torch.where(matched_vals < low, BELOW_LOW, matches)
    matches = torch.where((matched_vals >= low) & (matched_vals < high),
                          BETWEEN, matches)
    if allow_low_quality:
        highest_per_gt = iou.max(dim=2, keepdim=True).values     # [B, G, 1]
        is_best = ((iou == highest_per_gt) & gt_valid[..., None]).any(dim=1)
        matches = torch.where(is_best, all_matches, matches)
    return MatchResult(matches, matched_vals)


def _random_subset_mask(keys: torch.Tensor, eligible: torch.Tensor,
                        budget: torch.Tensor) -> torch.Tensor:
    """Select min(count(eligible), budget) eligible entries per row: keys
    [B, N] uniform, eligible [B, N] bool, budget [B] -> bool mask."""
    keys = torch.where(eligible, keys, torch.full_like(keys, float("inf")))
    order = torch.argsort(keys, dim=-1, stable=True)
    n = keys.shape[-1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=keys.device).expand_as(order))
    return eligible & (rank < budget[:, None])


def sample_pos_neg(rng: Rng, labels: torch.Tensor, batch_size: int,
                   positive_fraction: float):
    """labels [B, N] float (1 pos, 0 neg, -1 discard). Returns (pos, neg)
    bool masks with |pos| = min(#pos, batch * fraction) and |neg| =
    min(#neg, batch - |pos|) per row. Draws the positives' keys [B, N],
    then the negatives'."""
    positive = labels >= 1
    negative = labels == 0
    max_pos = int(batch_size * positive_fraction)
    num_pos = torch.clamp(positive.sum(-1), max=max_pos)
    pos = _random_subset_mask(uniform(rng, labels.shape, labels.device),
                              positive, num_pos)
    num_neg = torch.minimum(negative.sum(-1), batch_size - num_pos)
    neg = _random_subset_mask(uniform(rng, labels.shape, labels.device),
                              negative, num_neg)
    return pos, neg
