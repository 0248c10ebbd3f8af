"""Plain reference of RGRG's serving path: preprocessing, detector and
teacher-forced decoder, written from the published model's description.

It imports only torch and numpy, nothing of the program under test, and
takes only what the benchmark made itself: the raw uint8 X-rays, the
configuration file and the seeded weights, keyed by their checkpoint
names (`port_bench/weights.py`). Everything the program derives from them
(resize matrices, anchors, proposals, region features, KV caches) is
worked out again here.

`precision="float32"` computes every product in f32 (TF32 must be off:
`run.py` turns it off before any reference runs). `precision="fp8"` is
the control, the step below the configuration's bfloat16: every product's
operands rounded to float8 e4m3 (weights scaled per output channel,
activations per tensor, absmax to 448), the product computed in bfloat16.

Semantics followed (torchvision Faster R-CNN as the RGRG code uses it):
area resize of the longest side to 512, centre pad, (x/255 - mean) / std;
ResNet-50 to C5 with frozen BatchNorm statistics; an RPN over 160 anchors
a cell (10 sizes x 16 ratios), top-1000 by objectness, clip, small-box
removal, NMS at 0.7; RoIAlign 8x8 (aligned=False, 2 samples a bin edge,
scale 1/32); the TwoMLP head; per class the best-scoring kept proposal
whose arg-max class it is; region features = a linear map of the
proposal's bin-averaged C5 features; the two classifier MLPs; GPT-2 with
pseudo self-attention (one extra key/value slot per layer from the region
feature), positions read from the word table, tied LM head.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MASK = -1e4
XFORM_CLIP = math.log(1000.0 / 16.0)


class Reference:
    """The reference model over one configuration and one set of weights."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.w = weights
        self.lowp = precision == "fp8"
        self.device = weights["dim_reduction.weight"].device
        self._quant: Dict[str, torch.Tensor] = {}
        self.anchors = torch.from_numpy(grid_anchors(cfg)).to(self.device)

    # ------------------------------------------------------------ products

    def _weight(self, name: str, out_axis: int) -> torch.Tensor:
        w = self.w[name]
        if not self.lowp:
            return w.float()
        if name not in self._quant:
            dims = [d for d in range(w.ndim) if d != out_axis]
            self._quant[name] = fp8(w.float(), dims)
        return self._quant[name]

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x.float(), list(range(x.ndim))) if self.lowp else x.float()

    def _bias(self, name: str) -> torch.Tensor:
        b = self.w[name]
        return b.bfloat16() if self.lowp else b.float()

    def conv(self, x, name, stride=1, padding=0, bias=False):
        b = self._bias(name + ".bias") if bias else None
        y = F.conv2d(self._act(x), self._weight(name + ".weight", 0), b, stride, padding)
        return y.float()

    def linear(self, x, name):
        """torch layout: weight [out, in]."""
        return F.linear(self._act(x), self._weight(name + ".weight", 0),
                        self._bias(name + ".bias")).float()

    def dense(self, x, name):
        """GPT-2 / fc6 layout: kernel [in, out]."""
        y = torch.matmul(self._act(x), self._weight(name + ".kernel", 1))
        return (y + self._bias(name + ".bias")).float()

    def bn(self, x, name, eps=1e-5):
        w = self.w
        mul = torch.rsqrt(w[name + ".running_var"].float() + eps) * w[name + ".weight"].float()
        return ((x - w[name + ".running_mean"].float()[:, None, None]) * mul[:, None, None]
                + w[name + ".bias"].float()[:, None, None])

    # ------------------------------------------------------------ detector

    def preprocess(self, images_u8: torch.Tensor) -> torch.Tensor:
        """[N, H, W] uint8 -> [N, 1, S, S] f32: area resize of the longest
        side to S (exact in float64, rounded half to even to the uint8
        grid), centred zero pad, normalised."""
        cfg = self.cfg
        size = cfg["image_size"]
        n, h, w = images_u8.shape
        scale = size / max(h, w)
        dh, dw = max(1, round(h * scale)), max(1, round(w * scale))
        wy = torch.zeros(size, h, dtype=torch.float64)
        wx = torch.zeros(size, w, dtype=torch.float64)
        top, left = (size - dh) // 2, (size - dw) // 2
        wy[top:top + dh] = area_weights(h, dh)
        wx[left:left + dw] = area_weights(w, dw)
        wy, wx = wy.to(self.device), wx.to(self.device)
        out = []
        for img in images_u8:
            q = torch.round(wy @ img.to(torch.float64) @ wx.T).float()
            out.append((q - cfg["image_mean"] * 255.0) / (cfg["image_std"] * 255.0))
        return torch.stack(out)[:, None]

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn(self.conv(x, "backbone.conv1", 2, 3), "backbone.bn1"))
        y = F.max_pool2d(y, 3, 2, 1)
        for s, blocks in enumerate(self.cfg["backbone_stages"]):
            for b in range(blocks):
                p = f"backbone.layer{s + 1}_{b}."
                stride = 2 if (s > 0 and b == 0) else 1
                t = F.relu(self.bn(self.conv(y, p + "conv1"), p + "bn1"))
                t = F.relu(self.bn(self.conv(t, p + "conv2", stride, 1), p + "bn2"))
                t = self.bn(self.conv(t, p + "conv3"), p + "bn3")
                if b == 0:
                    y = self.bn(self.conv(y, p + "downsample_conv", stride), p + "downsample_bn")
                y = F.relu(t + y)
        return y                                                   # [N, C, g, g]

    def roi_pool(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """feats [C, g, g] of one image, boxes [K, 4] -> [K, P, P, C]
        RoIAlign (aligned=False)."""
        p, s = self.cfg["roi_output_size"], self.cfg["sampling_ratio"]
        scale = 1.0 / self.cfg["backbone_stride"]
        c, g, _ = feats.shape
        ay = bilinear_rows(boxes[:, 1] * scale, boxes[:, 3] * scale, g, p, s)   # [K, P, g]
        ax = bilinear_rows(boxes[:, 0] * scale, boxes[:, 2] * scale, g, p, s)
        return torch.einsum("kph,chw,kqw->kpqc", ay, feats, ax)

    def detect(self, images_u8: torch.Tensor, extra: int = 0) -> list:
        """Per image of [N, H, W] uint8: the proposal boxes [K', 4] (the
        top pre_nms_top_n by objectness plus `extra` beyond it, where a
        proposal that the program ranks above the cut may come from:
        bfloat16 objectness reorders the ranks near it), NMS keep over the
        top pre_nms_top_n, class probabilities [K', R], refined boxes
        [K', R, 4], region features [K', F], selection logits [K'], the
        detections (detected [R], top index [R]), the C5 map and the box
        head's fc7 output [K', rep]."""
        cfg = self.cfg
        x = self.preprocess(images_u8)
        feats = self.backbone(x)
        t = F.relu(self.conv(feats, "rpn_head.conv", 1, 1, bias=True))
        obj = self.conv(t, "rpn_head.cls_logits", bias=True)              # [N, A, g, g]
        dlt = self.conv(t, "rpn_head.bbox_pred", bias=True)
        n = feats.shape[0]
        obj = obj.permute(0, 2, 3, 1).reshape(n, -1)
        dlt = dlt.permute(0, 2, 3, 1).reshape(n, -1, 4)
        size = float(cfg["image_size"])
        top_n = cfg["rpn_pre_nms_top_n_test"]
        boxes, valids = [], []
        for i in range(n):
            order = torch.sort(obj[i], descending=True, stable=True).indices[:top_n + extra]
            b = decode(dlt[i, order], self.anchors[order], (1.0, 1.0, 1.0, 1.0))[:, 0]
            b = b.clamp(min=0.0, max=size)
            boxes.append(b)
            valids.append(((b[:, 2] - b[:, 0]) >= cfg["min_box_size"])
                          & ((b[:, 3] - b[:, 1]) >= cfg["min_box_size"]))
        boxes, valids = torch.stack(boxes), torch.stack(valids)
        keep = torch.zeros_like(valids)
        keep[:, :top_n] = nms(boxes[:, :top_n], valids[:, :top_n], cfg["nms_thresh"])
        out = []
        for i in range(n):
            cls, reg, box_feat, hidden = self.box_head(feats[i], boxes[i])
            probs = torch.softmax(cls, dim=-1)[:, 1:]
            refined = decode(reg, boxes[i], tuple(cfg["bbox_reg_weights"])).clamp(0.0, size)[:, 1:]
            pred = torch.argmax(probs, dim=-1)
            onehot = F.one_hot(pred, probs.shape[1]).float() * keep[i, :, None].float()
            top_idx = torch.argmax(probs * onehot, dim=0)
            region = self.linear(box_feat, "dim_reduction")
            out.append({"boxes": boxes[i], "keep": keep[i], "probs": probs, "refined": refined,
                        "features": region, "selection": self.classifier(region),
                        "detected": onehot.sum(0) > 0, "top_idx": top_idx, "c5": feats[i],
                        "hidden": hidden})
        return out

    def region_features(self, c5: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """C5 [C, g, g] of one image and proposal boxes [K, 4] -> region
        features [K, F]."""
        return self.linear(self.box_head(c5, boxes)[2], "dim_reduction")

    def box_head(self, feats: torch.Tensor, boxes: torch.Tensor, chunk: int = 128):
        """-> class logits, box deltas, bin-averaged C5 features and the
        box head's fc7 output of each box."""
        cls, reg, mean, hidden = [], [], [], []
        for k in range(0, boxes.shape[0], chunk):
            pooled = self.roi_pool(feats, boxes[k:k + chunk])              # [k, P, P, C]
            h = F.relu(self.dense(pooled.reshape(pooled.shape[0], -1), "box_head.fc6"))
            h = F.relu(self.linear(h, "box_head.fc7"))
            cls.append(self.linear(h, "box_predictor.cls_score"))
            reg.append(self.linear(h, "box_predictor.bbox_pred"))
            mean.append(pooled.mean(dim=(1, 2)))
            hidden.append(h)
        return torch.cat(cls), torch.cat(reg), torch.cat(mean), torch.cat(hidden)

    def classifier(self, x: torch.Tensor, name: str = "selection_classifier") -> torch.Tensor:
        x = F.relu(self.linear(x, name + ".fc0"))
        x = F.relu(self.linear(x, name + ".fc1"))
        return self.linear(x, name + ".fc2")[..., 0]

    # ------------------------------------------------------------- decoder

    def _ln(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + self.cfg["decoder"]["layer_norm_eps"])
                * self.w[name + ".scale"].float() + self.w[name + ".bias"].float())

    def decoder_logits(self, features: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced GPT-2 with pseudo self-attention: region features
        [N, F] and input ids [N, S] (BOS first) -> logits [N, S, V] f32, the
        logits at position s predicting token s + 1."""
        d = self.cfg["decoder"]
        n, s = tokens.shape
        heads, hid = d["num_heads"], d["hidden_dim"]
        hd = hid // heads
        img = self.dense(F.relu(self.dense(features, "decoder.feature_transform.fc0")),
                         "decoder.feature_transform.fc1")[:, None]        # [N, 1, D]
        wte = self.w["decoder.wte.embedding"]
        pos_table = wte if d["positions_from_wte"] else self.w["decoder.wpe.embedding"]
        x = wte[tokens].float() + pos_table[torch.arange(s, device=tokens.device)].float()
        causal = torch.ones(s, s + 1, dtype=torch.bool, device=tokens.device).tril(1)
        bias = torch.where(causal, 0.0, MASK)

        def split(t):
            return t.reshape(n, -1, heads, hd).transpose(1, 2)

        for i in range(d["num_layers"]):
            p = f"decoder.h_{i}."
            q, k, v = self.dense(self._ln(x, p + "ln_1"), p + "attn.c_attn").split(hid, -1)
            k = torch.cat([self.dense(img, p + "attn.uk"), k], 1)
            v = torch.cat([self.dense(img, p + "attn.uv"), v], 1)
            a = torch.matmul(self._act(split(q)), self._act(split(k)).transpose(-1, -2)).float()
            a = torch.softmax(a / math.sqrt(hd) + bias, -1)
            a = torch.matmul(self._act(a), self._act(split(v))).float()
            x = x + self.dense(a.transpose(1, 2).reshape(n, s, hid), p + "attn.c_proj")
            m = self._ln(x, p + "ln_2")
            m = F.gelu(self.dense(m, p + "mlp.c_fc"), approximate="tanh")
            x = x + self.dense(m, p + "mlp.c_proj")
        x = self._ln(x, "decoder.ln_f")
        return torch.matmul(self._act(x), self._act(wte).T).float()


# ---------------------------------------------------------------- helpers

def fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to float8 e4m3 with its absmax over `dims` scaled to 448,
    returned in bfloat16."""
    s = torch.clamp(x.abs().amax(dim=dims, keepdim=True) / 448.0, min=1e-30)
    return ((x / s).to(torch.float8_e4m3fn).float() * s).bfloat16()


def area_weights(src: int, dst: int) -> torch.Tensor:
    """[dst, src] area-average weights of a downscale (float64)."""
    if dst > src:
        raise ValueError("the reference resizes down only")
    scale = src / dst
    w = torch.zeros(dst, src, dtype=torch.float64)
    for o in range(dst):
        a0, a1 = o * scale, (o + 1) * scale
        for i in range(int(a0), min(int(math.ceil(a1)), src)):
            w[o, i] = min(i + 1, a1) - max(i, a0)
        w[o] /= w[o].sum()
    return w


def grid_anchors(cfg: Dict) -> np.ndarray:
    """[g*g*A, 4] anchors, cells row-major over (y, x), anchors of a cell
    ratio-major and size-minor, zero-centred corners rounded half to even."""
    sizes = np.asarray(cfg["anchor_sizes"], np.float32)
    ratios = np.asarray(cfg["anchor_aspect_ratios"], np.float32)
    hr = np.sqrt(ratios)
    ws = ((1.0 / hr)[:, None] * sizes[None, :]).reshape(-1)
    hs = (hr[:, None] * sizes[None, :]).reshape(-1)
    base = np.round(np.stack([-ws, -hs, ws, hs], 1) / 2.0).astype(np.float32)
    g = cfg["image_size"] // cfg["backbone_stride"]
    sy, sx = np.meshgrid(np.arange(g, dtype=np.float32) * cfg["backbone_stride"],
                         np.arange(g, dtype=np.float32) * cfg["backbone_stride"],
                         indexing="ij")
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (shifts[:, None] + base[None]).reshape(-1, 4).astype(np.float32)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """torchvision BoxCoder.decode: deltas [K, 4C], boxes [K, 4] -> [K, C, 4]."""
    d = deltas.reshape(deltas.shape[0], -1, 4)
    w = (boxes[:, 2] - boxes[:, 0])[:, None]
    h = (boxes[:, 3] - boxes[:, 1])[:, None]
    cx = boxes[:, 0:1] + 0.5 * w
    cy = boxes[:, 1:2] + 0.5 * h
    dx, dy = d[..., 0] / weights[0], d[..., 1] / weights[1]
    dw = torch.clamp(d[..., 2] / weights[2], max=XFORM_CLIP)
    dh = torch.clamp(d[..., 3] / weights[3], max=XFORM_CLIP)
    px, py = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def nms(boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes [N, K, 4] of N images: a kept box
    removes every later box whose IoU with it exceeds `thresh`; invalid
    boxes are never kept and remove nothing."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter)
    removes = (iou > thresh).triu(1)
    keep = valid.clone()
    for i in range(boxes.shape[1]):
        keep &= ~(removes[:, i] & keep[:, i:i + 1])
    return keep


def bilinear_rows(lo: torch.Tensor, hi: torch.Tensor, extent: int, pooled: int,
                  sampling: int) -> torch.Tensor:
    """Per box, the [pooled, extent] weights of RoIAlign's bilinear samples
    along one axis, averaged over the `sampling` samples of each bin:
    box edges lo/hi [K] in feature cells."""
    size = torch.clamp(hi - lo, min=1.0)
    b = size / pooled
    p = torch.arange(pooled, device=lo.device, dtype=torch.float32)
    i = torch.arange(sampling, device=lo.device, dtype=torch.float32)
    y = lo[:, None, None] + p[None, :, None] * b[:, None, None] \
        + (i[None, None, :] + 0.5) * b[:, None, None] / sampling          # [K, P, S]
    inside = ((y >= -1.0) & (y <= extent)).float()
    y = y.clamp(min=0.0)
    low = torch.floor(y)
    edge = low >= extent - 1
    low = torch.where(edge, torch.full_like(low, extent - 1), low)
    high = torch.where(edge, low, low + 1)
    frac = torch.where(edge, torch.zeros_like(y), y - low)
    cells = torch.arange(extent, device=lo.device, dtype=torch.float32)
    w = ((1 - frac)[..., None] * (cells == low[..., None]).float()
         + frac[..., None] * (cells == high[..., None]).float())
    return (w * inside[..., None]).sum(2) / sampling
