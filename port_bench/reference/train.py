"""Plain reference of RGRG's stage-3 training step (the reference's
`train_full_model.py` recipe as the port states it): losses, gradients,
gradient accumulation and AdamW, from the same weights, batches and
draws as the program.

Written from the model's description, on `reference/rgrg.py`'s layers:

- the detector in training mode: BatchNorm on the batch's statistics
  (mean and biased variance over N, H, W); the RPN keeps the training
  top 2000 by objectness, clipped, small boxes out, NMS at 0.7;
- RPN loss: anchors matched to ground truth at 0.7 / 0.3 with
  low-quality matches, 256 anchors an image sampled at half positives
  (a subset chosen by ranking uniform keys: two draws of [B, anchors]),
  BCE objectness and smooth-L1 (beta 1/9) deltas over the sampled count,
  the mean over images;
- RoI head: the proposals and the ground-truth boxes matched at 0.5,
  512 an image sampled at a quarter positives (two draws of
  [B, 2000 + 29]), the chosen first in pool order; CE and the matched
  class's smooth-L1 deltas (weights 10, 10, 5, 5) over the batch's
  samples; per region the best sampled proposal of its arg-max class, its
  bin-averaged C5 features through the linear map, both classifiers'
  BCE (pos_weight 2.2 and 6.0) over the detected regions;
- LM: the detected regions with a sentence, stably first, 128 rows,
  GPT-2 with pseudo self-attention and dropout 0.1 (embeddings,
  attention weights, both residual branches; masks drawn from the
  device's default generator in that order), CE over the valid targets;
- loss = detector + 5 selection + 5 abnormal + 2 LM; gradients averaged
  over the accumulation steps; AdamW (0.9, 0.999, 1e-8, decoupled weight
  decay) on every trainable tensor at the last of them.

The draws: `rng` is a torch.Generator that the program's step is handed
too, seeded alike; the dropout masks come from the device's default
generator, seeded alike before each step. Both sides make the same calls
in the same order, so both see the same keys and masks.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.rgrg import MASK, Reference, decode, nms

def seeded(device: torch.device, seed: int, step: int) -> torch.Generator:
    """Step `step`'s draws, alike on both sides: seeds the device's default
    generator (the dropout masks) and returns the generator of the
    sampling keys."""
    if device.type == "cuda":
        torch.cuda.manual_seed(seed * 7 + step)
    else:
        torch.manual_seed(seed * 7 + step)
    return torch.Generator(device=device).manual_seed(seed * 11 + step)


def trainable(name: str) -> bool:
    """Stage 3: every detector tensor but BatchNorm's statistics; of the
    decoder only the image projections and the feature transform."""
    if name.startswith("decoder."):
        return ".uk." in name or ".uv." in name or "feature_transform" in name
    return not name.endswith(("running_mean", "running_var"))


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, G, 4] x [B or 1, N, 4] -> [B, G, N]."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, :, None] + area_b[:, None, :] - inter)


def encode(gt: torch.Tensor, ref: torch.Tensor, weights) -> torch.Tensor:
    wx, wy, ww, wh = weights
    pw, ph = ref[..., 2] - ref[..., 0], ref[..., 3] - ref[..., 1]
    px, py = ref[..., 0] + 0.5 * pw, ref[..., 1] + 0.5 * ph
    gw, gh = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gx, gy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    t = torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                     ww * torch.log(gw / pw), wh * torch.log(gh / ph)], -1)
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


def match(gt: torch.Tensor, gt_valid: torch.Tensor, boxes: torch.Tensor, high: float,
          low: float, low_quality: bool) -> torch.Tensor:
    """Each box's gt index, -1 below `low`, -2 between; with low_quality,
    each gt's best boxes (ties included) keep their own best gt."""
    iou = torch.where(gt_valid[..., None], box_iou(gt, boxes), torch.tensor(-1.0, device=gt.device))
    vals, best = iou.max(dim=1).values, torch.argmax(iou, dim=1)
    m = torch.where(vals < low, -1, torch.where(vals < high, -2, best))
    if low_quality:
        top = iou.max(dim=2, keepdim=True).values
        m = torch.where(((iou == top) & gt_valid[..., None]).any(1), best, m)
    return m


def subset(keys: torch.Tensor, eligible: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    keys = torch.where(eligible, keys, torch.tensor(float("inf"), device=keys.device))
    order = torch.argsort(keys, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(keys.shape[-1], device=keys.device).expand_as(order))
    return eligible & (rank < budget[:, None])


def sample(rng: torch.Generator, labels: torch.Tensor, size: int, fraction: float):
    pos_e, neg_e = labels >= 1, labels == 0
    n_pos = torch.clamp(pos_e.sum(-1), max=int(size * fraction))
    pos = subset(torch.rand(labels.shape, generator=rng, device=labels.device), pos_e, n_pos)
    n_neg = torch.minimum(neg_e.sum(-1), size - n_pos)
    neg = subset(torch.rand(labels.shape, generator=rng, device=labels.device), neg_e, n_neg)
    return pos, neg


def smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def bce(logits: torch.Tensor, t: torch.Tensor, pos_weight: float = 1.0) -> torch.Tensor:
    return pos_weight * t * F.softplus(-logits) + (1 - t) * F.softplus(logits)


def masked_mean(x, m, dim=None):
    m = m.float()
    if dim is None:
        return (x * m).sum() / m.sum().clamp(min=1)
    return (x * m).sum(dim) / m.sum(dim).clamp(min=1)


class TrainReference(Reference):
    """The reference model in training: `weights` become leaf tensors
    (trainable ones with gradients) that `step` updates."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor]):
        super().__init__(cfg, {k: v.detach().float().clone().requires_grad_(trainable(k))
                               for k, v in weights.items()})
        self.names = [k for k in self.w if trainable(k)]
        self.acc = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.m = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.v = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.mini = 0
        self.updates = 0

    def bn(self, x, name, eps=1e-5):
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + eps) * self.w[name + ".weight"]
        return (x - mean[:, None, None]) * mul[:, None, None] + self.w[name + ".bias"][:, None, None]

    # ------------------------------------------------------------- losses

    def losses(self, batch: Dict[str, torch.Tensor], rng: torch.Generator) -> Dict:
        cfg, t = self.cfg, self.cfg["train"]
        images = batch["images"].permute(0, 3, 1, 2)
        b = images.shape[0]
        feats = self.backbone(images)
        h = F.relu(self.conv(feats, "rpn_head.conv", 1, 1, bias=True))
        obj = self.conv(h, "rpn_head.cls_logits", bias=True).permute(0, 2, 3, 1).reshape(b, -1)
        dlt = self.conv(h, "rpn_head.bbox_pred", bias=True).permute(0, 2, 3, 1).reshape(b, -1, 4)
        size = float(cfg["image_size"])
        top_n = t["rpn_pre_nms_top_n_train"]
        order = torch.sort(obj.detach(), dim=1, descending=True, stable=True).indices[:, :top_n]
        props = torch.stack([decode(dlt[i].detach()[order[i]], self.anchors[order[i]],
                                    (1.0, 1.0, 1.0, 1.0))[:, 0] for i in range(b)])
        props = props.clamp(0.0, size)
        valid = ((props[..., 2] - props[..., 0]) >= cfg["min_box_size"]) & \
                ((props[..., 3] - props[..., 1]) >= cfg["min_box_size"])
        keep = nms(props, valid, cfg["nms_thresh"])

        gt, gt_valid, gt_labels = batch["gt_boxes"], batch["gt_valid"], batch["gt_labels"]
        # RPN loss
        m = match(gt, gt_valid, self.anchors[None], t["rpn_fg_iou"], t["rpn_bg_iou"], True)
        labels = torch.where(m >= 0, 1.0, 0.0)
        labels = torch.where(m == -2, -1.0, labels)
        mgt = torch.gather(gt, 1, m.clamp(min=0)[..., None].expand(-1, -1, 4))
        targets = encode(mgt, self.anchors[None], (1.0, 1.0, 1.0, 1.0))
        pos, neg = sample(rng, labels, t["rpn_batch_per_image"], t["rpn_positive_fraction"])
        sampled = pos | neg
        box_l = (smooth_l1(dlt, targets) * pos[..., None]).sum((1, 2)) / sampled.sum(-1).clamp(min=1)
        obj_l = masked_mean(bce(obj, labels), sampled, dim=1)
        out = {"loss_objectness": obj_l.sum() / b, "loss_rpn_box_reg": box_l.sum() / b}

        # RoI samples and head
        s = t["roi_batch_per_image"]
        pool = torch.cat([props, gt], 1)
        pool_valid = torch.cat([keep, gt_valid], 1)
        m = match(gt, gt_valid, pool, t["roi_fg_iou"], t["roi_bg_iou"], False)
        lab = torch.gather(gt_labels, 1, m.clamp(min=0)).float()
        lab = torch.where(m == -1, 0.0, lab)
        lab = torch.where(m == -2, -1.0, lab)
        lab = torch.where(pool_valid, lab, -1.0)
        pos, neg = sample(rng, lab, s, t["roi_positive_fraction"])
        chosen = pos | neg
        idx = torch.sort((~chosen).int(), dim=1, stable=True).indices[:, :s]
        smp = torch.gather(chosen, 1, idx)
        sel_props = torch.gather(pool, 1, idx[..., None].expand(-1, -1, 4))
        sel_lab = torch.gather(lab, 1, idx).long()
        mgt = torch.gather(gt, 1, torch.gather(m.clamp(min=0), 1, idx)[..., None].expand(-1, -1, 4))
        reg_t = encode(mgt, sel_props, cfg["bbox_reg_weights"])
        spos = smp & (sel_lab > 0)
        cls, reg, mean, _ = zip(*(self.box_head(feats[i], sel_props[i]) for i in range(b)))
        cls, reg, mean = torch.stack(cls), torch.stack(reg), torch.stack(mean)
        lbl = sel_lab.clamp(min=0)
        nll = -torch.gather(torch.log_softmax(cls, -1), -1, lbl[..., None])[..., 0]
        out["loss_classifier"] = masked_mean(nll, smp)
        picked = torch.gather(reg.reshape(b, s, -1, 4), 2, lbl[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        out["loss_box_reg"] = (smooth_l1(picked, reg_t) * spos[..., None]).sum() / smp.sum().clamp(min=1)

        # regions and classifiers
        probs = torch.softmax(cls, -1)[..., 1:]
        onehot = F.one_hot(probs.argmax(-1), probs.shape[-1]).float() * smp[..., None].float()
        detected = onehot.sum(1) > 0
        top = torch.argmax(probs * onehot, dim=1)
        region = self.linear(mean[torch.arange(b, device=top.device)[:, None], top], "dim_reduction")
        total = t["loss_weight_detector"] * sum(out.values())
        for name, key, pw in (("selection", "region_has_sentence", t["selection_pos_weight"]),
                              ("abnormal", "region_is_abnormal", t["abnormal_pos_weight"])):
            logit = self.classifier(region, name + "_classifier")
            out["loss_" + name] = masked_mean(bce(logit, batch[key].float(), pw), detected)
            total = total + t["loss_weight_" + name] * out["loss_" + name]

        # LM over the detected regions with a sentence
        seq_valid = (detected & batch["region_has_sentence"].bool()).reshape(-1)
        ids = batch["input_ids"].reshape(b * 29, -1)
        att = batch["attention_mask"].reshape(b * 29, -1)
        rows = torch.sort((~seq_valid).int(), stable=True).indices[:t["lm_budget"]]
        mask = att[rows] * seq_valid[rows][:, None].float()
        logits = self.forward_lm(region.reshape(b * 29, -1)[rows], ids[rows], mask)
        sl, lab_ids, v = logits[:, :-1], ids[rows][:, 1:], mask[:, 1:].bool()
        nll = torch.logsumexp(sl, -1) - torch.gather(sl, -1, lab_ids[..., None])[..., 0]
        out["loss_lm"] = torch.where(v, nll, 0.0).sum() / v.sum().clamp(min=1)
        total = total + t["loss_weight_lm"] * out["loss_lm"]
        out["loss_total"] = total
        return out

    def forward_lm(self, features, ids, mask):
        d, rate = self.cfg["decoder"], self.cfg["train"]["dropout"]
        n, s = ids.shape
        heads, hid = d["num_heads"], d["hidden_dim"]
        hd = hid // heads

        def drop(x):
            keep = torch.rand(x.shape, device=x.device)
            return torch.where(keep >= rate, x / (1.0 - rate), torch.zeros_like(x))

        img = self.dense(F.relu(self.dense(features, "decoder.feature_transform.fc0")),
                         "decoder.feature_transform.fc1")[:, None]
        wte = self.w["decoder.wte.embedding"]
        x = drop(wte[ids] + wte[torch.arange(s, device=ids.device)])
        causal = torch.cat([torch.ones(s, 1, dtype=torch.bool, device=ids.device),
                            torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()], 1)
        pad = torch.cat([torch.ones(n, 1, device=ids.device), mask], 1)
        bias = torch.where(causal, 0.0, MASK)[None, None] + (1.0 - pad[:, None, None, :]) * MASK

        def split(t):
            return t.reshape(n, -1, heads, hd).transpose(1, 2)

        for i in range(d["num_layers"]):
            p = f"decoder.h_{i}."
            q, k, v = self.dense(self._ln(x, p + "ln_1"), p + "attn.c_attn").split(hid, -1)
            k = torch.cat([self.dense(img, p + "attn.uk"), k], 1)
            v = torch.cat([self.dense(img, p + "attn.uv"), v], 1)
            a = torch.matmul(split(q), split(k).transpose(-1, -2)) / math.sqrt(hd)
            a = drop(torch.softmax(a + bias, -1))
            a = torch.matmul(a, split(v)).transpose(1, 2).reshape(n, s, hid)
            x = x + drop(self.dense(a, p + "attn.c_proj"))
            mm = F.gelu(self.dense(self._ln(x, p + "ln_2"), p + "mlp.c_fc"), approximate="tanh")
            x = x + drop(self.dense(mm, p + "mlp.c_proj"))
        return torch.matmul(self._ln(x, "decoder.ln_f"), wte.T)

    # --------------------------------------------------------- the step

    def step(self, batch: Dict[str, torch.Tensor], rng: torch.Generator) -> Dict[str, float]:
        """One mini-step: losses, backward, the running mean of the
        gradients, AdamW on the last of the accumulation steps."""
        t = self.cfg["train"]
        out = self.losses(batch, rng)
        grads = torch.autograd.grad(out["loss_total"], [self.w[k] for k in self.names],
                                    allow_unused=True)
        n = self.mini
        with torch.no_grad():
            for k, g in zip(self.names, grads):
                g = torch.zeros_like(self.acc[k]) if g is None else g
                self.acc[k] += (g - self.acc[k]) / (n + 1)
            self.mini = (n + 1) % t["grad_accumulation_steps"]
            if self.mini == 0:
                self.updates += 1
                b1, b2, eps = t["adam_betas"][0], t["adam_betas"][1], t["adam_eps"]
                lr, wd = t["learning_rate"], t["weight_decay"]
                for k in self.names:
                    p, g = self.w[k], self.acc[k]
                    p.mul_(1 - lr * wd)
                    self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                    self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = self.m[k] / (1 - b1 ** self.updates)
                    vh = self.v[k] / (1 - b2 ** self.updates)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
                    g.zero_()
        return {k: float(v.detach()) for k, v in out.items()}

    def gradient_norms(self) -> Dict[str, float]:
        """Per trainable tensor, the norm of the running mean of gradients."""
        return {k: float(self.acc[k].norm()) for k in self.names}
