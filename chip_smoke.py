#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rgrg_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: compiles every kernel of csrc/ with nvcc for sm_90a, in
     parallel, and prints the build time and ptxas resource lines;
  3. K1 NMS: kernel vs plain PyTorch at B=8 x N=1000 score-sorted boxes with
     ties, duplicates, zero-area and padding boxes (masks bit-identical; the
     words step alone bit-identical to the plain suppression words), timed
     whole and its words step alone;
  4. K2 RoIAlign: kernel vs plain PyTorch at feats [8, 16, 16, 2048] in bf16
     and f32 with 256 boxes per image, edge boxes included (max abs error
     <= 1e-4, finite, bit-identical on a relaunch);
  5. K3 beam attention: kernel vs plain PyTorch at the beam path's shape
     (384 lanes = 96 items x 4 beams, 16 heads, 61 slots, 64 dims, a
     simulated ancestry) at slots 2, 31 and 59 with f32, bf16 and int8
     caches (max abs error <= 1e-5 f32, <= 1e-4 bf16/int8; bit-identical
     on a relaunch), timed cold (caches cycled past the L2 cache) and warm
     (one cache relaunched), each slot with its own bound;
  5a. K3 at the evaluation path's long caches: 256 lanes (64 items x 4
     beams) x 16 heads x 305 slots x 64 dims, slots 130 and 303 (K3's ten
     chunks of 32 slots), bf16 and f32, as phase 5 holds and times it;
  6. K4 dense_wint8: kernel vs plain PyTorch at the decoder's four
     products (K, N) in {(1024, 3072), (1024, 1024), (1024, 4096),
     (4096, 1024)} at M = 64 and 256 rows, and one ragged shape (5, 96,
     100), bf16 and f32 x with bias (f32: rtol 2e-5 / atol 2e-4; bf16: one
     bf16 ulp of the plain output plus the f32 reordering bound, and
     bit-identical on a second launch), timed with the weights cycled past
     the L2 cache beside the bf16 `torch.addmm` over dequantised weights (a
     yardstick only); per shape the planner's cluster split of K, at the
     decoder's shapes the time of every cluster size, and at M = 64
     the wrapper's host us per call beside `torch.addmm`'s;
  6a. soft dedup: a random distilbert of the default scorer's widths
     written to build/smoke_distilbert and named by $RGRG_DISTILBERT_DIR;
     the default scorer's F1 on the card equals the CPU's (1e-5) and drops
     the shorter near-duplicate; the variable is set for phases 7 and 12;
  7. reference: a small model (shallow backbone, tiny decoder) serves the
     same uint8 images on the card (kernels) and on the CPU (plain
     versions), greedy and at the beam-4 default through generate_reports
     (host preprocessing; generators built with their defaults, so soft
     dedup runs on each one's device); then through generate_reports_pipelined (4
     batches of 2: three of one shape on the device-resize route, one of
     mixed shapes on the host route; speculation on, the length cascade
     continued past its first rung) with weights_int8 off, "xla" and
     "pallas" on decoder weights snapped to their int8 grid; reports and
     detector decisions must be identical card vs CPU and across the
     three weights_int8 values;
  7a. evaluation reference: evaluate_model on the small model over 2
     batches of 2 images with decision margins, card vs CPU, greedy and
     beam 4 (length buckets (6, 12); the beam run's CascadeStats bails out
     after its first batch), with soft dedup ("auto" on each device) and a
     random small CheXbert for CE: scores equal within 1e-5, sentences,
     reports, CE labels and cascade counters identical;
  8. main path: a full-width ReportGenerator (ResNet-50, 1000 proposals,
     bf16 detector; GPT-2 Medium, 24 layers x 1024 wide x 16 heads, vocab
     50257, bf16) with seeded random weights answers 3 requests of 8 raw
     uint8 2048x2500 X-rays through generate_reports (max_length 60),
     greedy (num_beams=1) and then at its default (beam 4, early
     stopping); per request the NMS launch counter must rise by 1, the
     RoIAlign counter by 4, and on the beam path the beam-attention
     counter by 24 per decode step;
  9. int8 KV cache: the last request's selected regions decoded again,
     greedy and beam 4, with kv_cache_dtype=torch.int8;
 10. breakdown: host preprocessing + upload, detect and decode timed
     apart, and one detect, one greedy and one beam request under
     torch.profiler (device busy share, top kernels);
 11. serving: generate_reports_pipelined over 4 batches of 8 uint8
     2048x2500 X-rays (device resize) at the serving defaults (greedy,
     int8 KV cache, speculation) and max_length 60, once with bf16
     decoder weights and once with weights_int8="pallas"; at every
     yielded batch the K4 counter must equal 96 (24 layers x 4 products)
     x (decode steps + prefills) so far; reports/s over the 4 batches
     after a warm-up batch (start to last report), one batch's decode
     time, the CascadeStats snapshot and one profiled batch each;
     then one mixed-shape batch (2048x2500 and 2500x2048) through the
     host preprocessing route;
 12. soft dedup at full width: a default ReportGenerator over the main
     path's weights (so with the phase-6a scorer on the card) answers 2
     greedy requests of 8 alternately with the exact-dedup one (same
     region sentences; soft dedup only drops sentences), then serves 4
     batches through generate_reports_pipelined(weights_int8="pallas");
     ms per request and per batch beside exact dedup's, and the scorer's
     calls, pairs and host ms;
 13. evaluation at full width: evaluate_model over 3 batches of 8 uint8
     2048x2500 X-rays made from a seed, through the port's dataset (split
     rows, val_transform, BPE encode of the phrases, collate, prefetch;
     images held in memory), with the main path's weights, beam 4 with
     early stopping at max_length 300 through the length cascade (64, 128,
     304) and its bail-out, soft dedup on the card and CE through a
     BERT-base-wide CheXbert (random weights); the K1/K2/K3 counters must
     equal 1 and 4 per batch and 24 per beam step; ms per batch of detect,
     decode, host metrics and CE, reports/s of decode, the cascade
     snapshot, and one bailed-out batch profiled (device idle share).

 14. training (train.loop.train, `phase_train_*`): (a) K1 at B=16 x
     N=2000 (the training proposal count) and N=1000, masks bit-identical
     to plain; (b) K2 at B=16 x 256 RoIs x C=2048, bf16 and f32, forward
     within 1e-4 of plain and the feature gradient through its
     autograd.Function against autograd through the plain version (f32
     1e-4 relative, bf16 one bf16 ulp), bit-identical on a relaunch, with
     the backward product's time beside `torch.bmm` alone; (c) the small
     model's stage-3 step card vs CPU from the same weights, batch and
     sampling keys, then a 4-mini-step update; (d) full width at
     RGRGConfig() defaults (ResNet-50, 2000 proposals, 512 sampled RoIs,
     GPT-2 Medium, batch 16, accumulation 4, f32): 8 mini-steps with
     checkpoints, a resume for 4 more, 4 of stage 1 and 4 of the bf16 /
     remat recipe (budget 256), each with ms per mini-step and update,
     images/s, LM target tokens/s, peak memory, K1 / K2 launches (1 and 2
     a mini-step) and finite losses; one mini-step of each recipe
     profiled; the FLOP of a mini-step counted from the shapes and its
     share of the f32 peak.
 15. (a) K3 from slot 1 (t0 = 1, the no_image decode) against its plain
     version at the beam shape (slots 2, 31) and the evaluation shape (256
     lanes x 305 slots, slot 303), bf16 / f32 / int8, cold and warm;
 16. (b) no_image (vanilla GPT-2) beam 4: a small decoder card vs CPU
     token for token, then GPT-2 Medium at full width (32 rows, max_length
     60) with K3's counter at 24 per beam step;
 17. (c) sampling: decode_selected(do_sample=True, top_k=1) equals greedy
     on one request's region features (GPT-2 Medium in f32), then
     temperature 0.7 / top_p 0.9 timed on the bf16 serving weights;
 18. (d) the train CLI (`python -m rgrg_tpu_torch.train`'s main) in-process
     at RGRGConfig(): split CSVs of 2048x2500 X-rays held in memory,
     augmented by 4 host threads, 8 mini-steps, a validation, `best` and
     `last`; host ms per augmented batch, ms per mini-step and images/s,
     the idle share of one mini-step, K1 / K2 counters; then
     ReportGenerator.from_checkpoint(<run_dir>/last) evaluates one val
     batch at beam 4 through K1-K3;
 19. (e) CheXbert fine-tuning: a small labeler card vs CPU (losses 1e-4),
     then ms per step at BERT-base width (batch 16 x 128 tokens);
 20. offline pipeline and product CLI (`phase_offline`), full width from a
     checkpoint directory (save_checkpoint of the main path's seeded
     weights): (a) `python -m rgrg_tpu_torch.create_dataset` over a
     synthetic Chest ImaGenome / MIMIC-CXR / MIMIC-CXR-JPG tree of 40
     studies (tests/etl_corpus.py; header-only JPEGs, pixels held in memory);
     (b) split statistics, pixel mean/std, CIDEr-D frequencies of valid.csv,
     then `python -m rgrg_tpu_torch.evaluate --cider-df` on test.csv and
     test-2.csv (a batch of 8 each, beam 4, max_length 300); (c) `python -m
     rgrg_tpu_torch.generate_reports` on 16 X-rays at its defaults, its file
     equal to load_generator + generate_reports; (d) `python -m
     rgrg_tpu_torch.serve --weights-int8 pallas` on the directory (2 batches
     of 8, greedy), its file equal to from_checkpoint +
     generate_reports_pipelined; (e) one beam request under
     utils/logging.trace (the trace names K1-K3) and `summarize` of the
     parameters; K1-K4 counters checked at each entry point.

  21. the data-parallel mesh (`phase_mesh`, core/mesh.py): ranks started by
     core.mesh.launch (spawned processes, a FileStore rendezvous) after the
     kernels are built, each loading a checkpoint directory of the main
     path's full-width weights; per world 2 greedy batches of 8 uint8
     2048x2500 X-rays (max_length 60, weights_int8 "pallas", int8 KV cache)
     and 1 beam-4 batch through generate_reports_pipelined(mesh=), then 4
     mini-steps (one update) of train.loop.train at RGRGConfig() (global
     batch 16, f32), at world 1 (NCCL), world 2 (two gloo ranks sharing
     the card) and, with 2+ cards, world min(count, 4) (NCCL): every
     rank's reports equal to its own shards served without a mesh, each
     rank's K1-K4 counters as its shard needs them, parameters bitwise
     equal across ranks and within 2 x lr of world 1's, BN statistics
     1e-5; phase 14(c)'s margin-checked small training step against world
     1 (losses 1e-4, parameters 2 x lr, gradients 1e-1); the
     full-width reports' and first losses' agreement with world 1
     measured (another batch per card can flip near-ties); ms per batch
     and per mini-step, peak GB per rank.
     `python3 chip_smoke.py --mesh-only` builds the kernels and runs phase
     21 alone (details in chiprun_out/chip_smoke_mesh.json).
  22. the three-stage rehearsal (`phase_rehearsal`,
     tools/three_stage_rehearsal.py) at the reference rehearsal's widths
     (ResNet-50, a 4 x 256 GPT-2 over 257 byte tokens, batch 8, f32):
     K1 at B=8 x N=2000 and B=32 x N=1000 against its plain version;
     K1-K3's wrappers on CPU tensors count no launch; then 16 / 8 / 16
     mini-steps of stages 1 -> 2 -> 3 with warm-start handoffs (stage 2
     begins with stage 1's final detector, stage 3 with stage 2's params,
     bit for bit), evaluate_model at beam 4 on 1 batch, and the proposal-
     budget check on the stage-3 checkpoint (budgets 992 / 960 / 600,
     --ladder, detect timed at B=32); every loss finite, K1-K3 launched, a
     tested budget safe, the summary's keys those of
     docs/artifacts/three_stage_rehearsal.json; after the run K3 at the
     decode's shape (its row budget x 4 beams, 4 heads x 64 dims, 41
     slots, f32) against its plain version. `python3 chip_smoke.py
     --rehearsal-only` builds the kernels and runs it at 400 / 150 / 400
     mini-steps with 3 evaluation batches, writes
     chiprun_out/{three_stage_rehearsal,proposal_budget_trained}.json and
     fails unless the trend bands (REHEARSAL_BANDS) hold.

TF32 is off for the whole run (the f32 training numbers are without it). Output: progress lines, then a JSON
line of per-kernel numbers, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Full numbers also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet) for the bound columns
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50e6
SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's ~1.98 GHz boost clock

REQUESTS = 3
BATCH = 8
RAW_SHAPE = (2048, 2500)
MAX_LENGTH = 60
BEAMS = 4            # the product default (GenerationConfig.num_beams)
# beam attention at the beam path's shape: 96 items (the row budget of 65-96
# selected regions) x 4 beams, GPT-2 Medium heads, 1 + MAX_LENGTH slots
K3_SHAPE = dict(items=96, beams=BEAMS, heads=16, slots=1 + MAX_LENGTH, dim=64)
# the first, middle and last slot a max_length-60 beam decode attends to
K3_SLOTS = (2, 31, 59)
K3_TOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-4}
# the evaluation path's long caches: 64 items (the row budget of the ~60
# regions a batch of 8 selects) x 4 beams at the length cascade's last rung
# (304 slots + the image slot), K3's slots split over ten chunks of 32
K3_LONG_SHAPE = dict(items=64, beams=BEAMS, heads=16, slots=305, dim=64)
K3_LONG_SLOTS = (130, 303)
EVAL_MAX_LENGTH = 300  # the evaluate CLI's default (beam 4, early stopping)
EVAL_BATCHES = 3
# K4 at the decoder's four products per layer (c_attn, attn c_proj, c_fc,
# mlp c_proj of GPT-2 Medium) at the greedy row budget (64) and at 256 rows
# (beam lanes), and one ragged shape that tiles nowhere
K4_PRODUCTS = {"c_attn": (1024, 3072), "attn_c_proj": (1024, 1024),
               "c_fc": (1024, 4096), "mlp_c_proj": (4096, 1024)}
K4_ROWS = (64, 256)
K4_RAGGED = (5, 96, 100)
SERVE_BATCHES = 4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (events).
    A spin kernel (~50 ms) queued first keeps the card busy while the host
    enqueues the calls, so a kernel shorter than its host-side launch is
    timed back to back on the device, not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nms_inputs(np, torch, dev, b=BATCH, n=1000, seed=0):
    """Score-sorted clustered boxes per image, with duplicate boxes (exact
    ties), zero-area boxes, boxes whose IoU sits on the threshold, invalid
    padding, and one image with no valid box."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, n, 4), np.float32)
    valid = np.ones((b, n), bool)
    for i in range(b):
        base = rng.uniform(0, 400, (n // 10, 2))
        size = rng.uniform(10, 170, (n // 10, 2))
        pick = rng.integers(0, n // 10, n)
        xy = base[pick] + rng.normal(0, 8, (n, 2))
        wh = size[pick] + rng.normal(0, 8, (n, 2))
        bx = np.concatenate([xy, xy + np.maximum(wh, 1.0)], 1)
        bx = np.clip(bx, 0, 512).astype(np.float32)
        bx = bx[np.argsort(-rng.uniform(size=n), kind="stable")]
        bx[100:110] = bx[20]                          # duplicates
        bx[200:203] = [[0, 0, 10, 10], [0, 0, 10, 7], [0, 0, 10, 7.1]]
        bx[300:303] = [30, 30, 30, 30]                # zero area
        boxes[i] = bx
        valid[i, n - 24 * i:] = False                 # padding tail
    valid[BATCH - 1] = False
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))


def nms_pairs_needed(np, boxes, valid, keep, thr) -> int:
    """IoU tests the greedy scan needs on this data: each kept box against
    every later box still alive when it is reached."""
    total = 0
    for b in range(boxes.shape[0]):
        alive = valid[b].copy()
        bx = boxes[b].astype(np.float32)
        area = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
        for i in np.nonzero(keep[b])[0]:
            later = np.nonzero(alive[i + 1:])[0] + i + 1
            total += len(later)
            x1 = np.maximum(bx[i, 0], bx[later, 0])
            y1 = np.maximum(bx[i, 1], bx[later, 1])
            x2 = np.minimum(bx[i, 2], bx[later, 2])
            y2 = np.minimum(bx[i, 3], bx[later, 3])
            inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
            with np.errstate(invalid="ignore", divide="ignore"):
                iou = inter / (area[i] + area[later] - inter)
            alive[later[iou > thr]] = False
    return total


def roi_inputs(np, torch, dev, dtype, b=BATCH, n=256, c=2048, seed=1):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(0, 1, (b, 16, 16, c)).astype(np.float32))
    x1 = rng.uniform(-20, 500, (b, n))
    y1 = rng.uniform(-20, 500, (b, n))
    w = rng.uniform(0.2, 300, (b, n))
    h = rng.uniform(0.2, 300, (b, n))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    boxes[:, :6] = [[0, 0, 512, 512], [500, 500, 512, 512], [0, 0, 0.5, 0.5],
                    [-40, -20, 100, 60], [530, 530, 600, 640], [-90, -90, -10, -5]]
    return feats.to(dev, dtype), torch.from_numpy(boxes).to(dev)


def phase_nms(np, torch, dev, result):
    from rgrg_tpu_torch.ops.nms import (nms_keep_mask, nms_keep_mask_plain,
                                        nms_suppression_words, nms_words)
    boxes, valid = nms_inputs(np, torch, dev)
    thr = 0.7
    got = nms_keep_mask(boxes, valid, thr)
    want = nms_keep_mask_plain(boxes, valid, thr)
    words = nms_words(boxes, thr)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "NMS kernel mask != plain mask")
    check(not got[BATCH - 1].any(), "NMS kept a box of the all-invalid image")
    check(torch.equal(words, nms_suppression_words(boxes, thr)),
          "NMS words kernel != plain suppression words")
    ms = cuda_ms(torch, lambda: nms_keep_mask(boxes, valid, thr), 50)
    words_ms = cuda_ms(torch, lambda: nms_words(boxes, thr), 50)
    plain_ms = cuda_ms(torch, lambda: nms_keep_mask_plain(boxes, valid, thr), 3, warmup=1)
    b, n = valid.shape
    keep = got.cpu().numpy()
    pairs = nms_pairs_needed(np, boxes.cpu().numpy(), valid.cpu().numpy(), keep, thr)
    nbytes = b * n * (16 + 1 + 1)
    flops = 16 * pairs  # ~16 f32 operations per IoU test
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    log(f"K1 nms: B={b} N={n} kept={int(keep.sum())} mask and words identical "
        f"kernel {ms:.4f} ms (words step alone {words_ms:.4f} ms, with a zeroed "
        f"scratch), plain {plain_ms:.2f} ms, bound {bound_ms:.6f} ms "
        f"({nbytes} B, {pairs} IoU tests) [{result['card']}]")
    result["nms"] = dict(ms=ms, words_ms=words_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / F32_FLOP_PER_S else "operations",
                         max_abs_err=0.0, bytes=nbytes, flops=flops, pairs=pairs,
                         kept=int(keep.sum()))


def roi_taps_needed(torch, boxes, height=16, width=16) -> int:
    """Bilinear taps RoIAlign needs for these boxes, per channel: each bin
    (p, q) touches the nonzero cells of its row weights Ay[p] times those of
    its column weights Ax[q] (at most 4 x 4; fewer where samples fall off
    the map or share a cell)."""
    from rgrg_tpu_torch.ops.roi_align import roi_align_weights
    ay, ax = roi_align_weights(boxes, height, width, 8, 1.0 / 32.0, 2)
    rows = (ay != 0).sum(dim=(-2, -1))          # [B, N]: sum over p of row taps
    cols = (ax != 0).sum(dim=(-2, -1))
    return int((rows * cols).sum())


def phase_roi(np, torch, dev, result):
    from rgrg_tpu_torch.ops.roi_align import roi_align, roi_align_plain
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        feats, boxes = roi_inputs(np, torch, dev, dtype)
        got = roi_align(feats, boxes)
        want = roi_align_plain(feats, boxes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= 1e-4, f"RoIAlign kernel vs plain max abs err {err} ({dtype})")
        check(bool(torch.isfinite(got).all()), "RoIAlign produced non-finite values")
        del want
        check(torch.equal(roi_align(feats, boxes), got),
              f"RoIAlign relaunch not bit-identical ({dtype})")
        ms = cuda_ms(torch, lambda: roi_align(feats, boxes), 20)
        plain_ms = cuda_ms(torch, lambda: roi_align_plain(feats, boxes), 3, warmup=1)
        b, n = boxes.shape[:2]
        c = feats.shape[-1]
        nbytes = feats.numel() * feats.element_size() + boxes.numel() * 4 + got.numel() * 4
        taps = roi_taps_needed(torch, boxes)
        flops = 2 * c * taps  # one multiply and one add per tap and channel
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        rows[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                          bound_ms=max(t_bytes, t_ops) * 1e3,
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          bytes=nbytes, flops=flops, taps=taps)
        log(f"K2 roi_align {name}: feats {tuple(feats.shape)} boxes {tuple(boxes.shape)} "
            f"max_abs_err {err:.3e}, relaunch bit-identical, kernel {ms:.4f} ms, "
            f"{rows[name]['bound_ms'] / ms:.1%} of its bound, plain {plain_ms:.3f} ms, "
            f"bound {rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}: "
            f"{nbytes} B = {t_bytes * 1e3:.4f} ms, {flops} FLOP = {t_ops * 1e3:.4f} ms) "
            f"[{result['card']}]")
        del got, feats, boxes
        torch.cuda.empty_cache()
    result["roi_align"] = rows


def k3_inputs(np, torch, dev, kind, slot, seed=2, shape=K3_SHAPE):
    """Unit-scale q/k/v and an ancestry grown as beam search grows it up to
    `slot`: each step every beam picks a random parent beam of its item and
    owns the slot it writes (so beams share early history, as real ones
    do)."""
    from rgrg_tpu_torch.models.gpt2 import _quantize_kv
    sh = shape
    rng = np.random.default_rng(seed)
    b, k, h, t, d = sh["items"], sh["beams"], sh["heads"], sh["slots"], sh["dim"]
    anc = np.broadcast_to(np.arange(k, dtype=np.int32)[None, :, None], (b, k, t)).copy()
    for s in range(2, slot + 1):
        parent = rng.integers(0, k, (b, k))
        anc = np.take_along_axis(anc, parent[:, :, None], axis=1)
        anc[:, :, s] = np.arange(k)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.from_numpy(rng.normal(0, 1, (b * k, h, d)).astype(np.float32)).to(dev, dtype)
    kv = [torch.from_numpy(rng.normal(0, 1, (h, b * k, t, d)).astype(np.float32)).to(dev)
          for _ in range(2)]
    scales = {}
    if kind == "int8":
        (kq, ks), (vq, vs) = _quantize_kv(kv[0]), _quantize_kv(kv[1])
        kv, scales = [kq, vq], {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}
    else:
        kv = [x.to(dtype) for x in kv]
    return q, kv[0], kv[1], torch.from_numpy(anc).to(dev), scales


def phase_beam_attn(np, torch, dev, result, shape=K3_SHAPE, slots=K3_SLOTS,
                    kinds=("bf16", "f32", "int8"), key="beam_attention", t0=0):
    """K3 against its plain version at the beam path's shape, at the first,
    middle and last slot of a max_length-60 decode, with f32, bf16 and int8
    caches (or at `shape`, `slots` and `kinds`; attending from slot `t0`,
    1 for the no_image decode); bit-identical on a relaunch. Device time
    warm (one cache, relaunched: its named rows stay in the L2 cache) and
    cold (each launch reads another copy of the cache, cycling enough
    copies that the rows they name fill twice the L2 cache, as the decode
    step finds every layer's cache), beside the plain version and the gather + SDPA yardstick."""
    from rgrg_tpu_torch.ops.beam_attn import beam_attention, beam_attention_plain, plan
    from rgrg_tpu_torch.ops.kernels import sm_count
    rows = {}
    scale = shape["dim"] ** -0.5
    for slot in slots:
        for kind in kinds:
            q, k, v, anc, scales = k3_inputs(np, torch, dev, kind, slot, shape=shape)
            got = beam_attention(q, k, v, anc, slot, scale=scale, t0=t0, **scales)
            want = beam_attention_plain(q, k, v, anc, slot, scale=scale, t0=t0, **scales)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"beam attention non-finite ({kind})")
            check(err <= K3_TOL[kind], f"beam attention kernel vs plain max abs err {err} "
                  f"({kind}, slot {slot}, tolerance {K3_TOL[kind]})")
            check(torch.equal(beam_attention(q, k, v, anc, slot, scale=scale, t0=t0,
                                             **scales), got),
                  f"beam attention differs on a relaunch ({kind}, slot {slot}, t0 {t0})")
            # bound: each (cache lane, slot) row the ancestry names is read once
            n_slots = slot + 1 - t0
            a = anc.cpu().numpy()[:, :, t0:slot + 1]
            pairs = int(sum(len(np.unique(a[:, :, t][i])) for t in range(a.shape[2])
                            for i in range(a.shape[0])))
            bk, h, d = q.shape
            row_bytes = h * d * k.element_size() + (h * 4 if scales else 0)
            named = 2 * pairs * row_bytes
            nbytes = (named + q.numel() * q.element_size() + bk * n_slots * 4
                      + got.numel() * 4)
            flops = 4 * bk * n_slots * h * d
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
            copies = max(3, 1 + -(-int(2 * L2_BYTES) // named))
            caches = itertools.cycle(
                [(k, v, scales)] + [(k.clone(), v.clone(), {n: x.clone() for n, x in scales.items()})
                                    for _ in range(copies - 1)])

            def cold():
                kc, vc, sc = next(caches)
                beam_attention(q, kc, vc, anc, slot, scale=scale, t0=t0, **sc)
            ms = cuda_ms(torch, cold, 200)
            warm_ms = cuda_ms(torch, lambda: beam_attention(q, k, v, anc, slot, scale=scale,
                                                            t0=t0, **scales), 200)
            plain_ms = cuda_ms(torch, lambda: beam_attention_plain(q, k, v, anc, slot,
                                                                   scale=scale, t0=t0,
                                                                   **scales), 10)
            del caches
            # yardstick, used nowhere in the port: gather the named rows, then
            # PyTorch's fused attention (two calls; no single call does both)
            two_call_ms = None
            if kind != "int8":
                def gather_sdpa():
                    base = torch.arange(anc.shape[0], device=dev)[:, None, None] * anc.shape[1]
                    lanes = (base + anc.long()).reshape(bk, -1)[:, t0:slot + 1]
                    idx = lanes[None, :, :, None].expand(h, bk, n_slots, d)
                    kg = torch.gather(k[:, :, t0:slot + 1], 1, idx).transpose(0, 1)
                    vg = torch.gather(v[:, :, t0:slot + 1], 1, idx).transpose(0, 1)
                    return torch.nn.functional.scaled_dot_product_attention(
                        q[:, :, None], kg, vg, scale=scale)
                lib = gather_sdpa()[:, :, 0].float()
                check((lib - want).abs().max().item() <= 2e-2, "gather+SDPA yardstick disagrees")
                two_call_ms = cuda_ms(torch, gather_sdpa, 50)
            p = plan(bk, shape["beams"], h, d, k.shape[2], k.dtype,
                     sm_count(torch.cuda.current_device()))
            row = dict(slot=slot, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                       two_call_ms=two_call_ms, max_abs_err=err,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, flops=flops, lane_slot_pairs=pairs, cold_copies=copies,
                       plan=p._asdict())
            row["t0"] = t0
            rows[f"{kind} slot {slot}"] = row
            log(f"K3 beam_attention {kind} slot {slot} t0 {t0}: q {tuple(q.shape)} cache "
                f"{tuple(k.shape)} max_abs_err {err:.3e}, relaunch bit-identical; kernel cold "
                f"{ms:.4f} ms ({copies} caches cycled), warm {warm_ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, gather+SDPA "
                f"{two_call_ms if two_call_ms is None else round(two_call_ms, 4)} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes} B over {pairs} named "
                f"(lane, slot) rows = {t_bytes * 1e3:.4f} ms, {flops} FLOP = "
                f"{t_ops * 1e3:.4f} ms); plan {tuple(p)} [{result['card']}]")
            del q, k, v, anc, scales, got, want
            torch.cuda.empty_cache()
    result[key] = rows


def cycled(t):
    """An endless cycle over t and enough copies of it to fill twice the L2
    cache, so that each use finds its tensor cold."""
    n = max(1, -(-int(2 * L2_BYTES) // (t.numel() * t.element_size())))
    return itertools.cycle([t] + [t.clone() for _ in range(n - 1)])


def k4_inputs(np, torch, dev, m, k, n, dtype, seed):
    """x ~ N(0, 1) (a layer-normed activation), GPT-2-like weights
    ~ N(0, 0.02) quantized per column as gpt2.quantize_decoder_weights does
    (q int8, scale [1, N] f32), a bias ~ N(0, 0.1) in x's dtype."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    s = np.maximum(np.abs(w).max(axis=0, keepdims=True) / np.float32(127), np.float32(1e-12))
    q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    return (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(q).to(dev),
            torch.from_numpy(s.astype(np.float32)).to(dev), torch.from_numpy(b).to(dev, dtype))


def k4_excess(torch, x, q, scale, got, want):
    """Error of K4 against its plain version beyond the stated tolerance,
    elementwise (<= 0 everywhere passes), and the count of elements more
    than one bf16 ulp apart. f32 x: rtol 2e-5 / atol 2e-4. bf16 x: one bf16
    ulp of the plain output, plus the bound on how far two f32 summation
    orders of the same products can drift apart, 2 K 2^-24 sum_k |x q| s
    (it matters only where the sum nearly cancels)."""
    w = want.float()
    err = (got.float() - w).abs()
    if got.dtype == torch.float32:
        return err - (2e-4 + 2e-5 * w.abs()), 0
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    drift = ((x.float().abs() @ q.float().abs()) * scale.reshape(-1)
             * (2 * q.shape[0] * 2.0 ** -24))
    return err - ulp - drift, int((err > ulp).sum())


def host_us(torch, fn, iters=200) -> float:
    """Host time of one call of fn (us): the calls' own Python and launch
    cost, measured while a spin kernel keeps the card busy, so no call
    waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_dense_wint8(np, torch, dev, result):
    """K4 against its plain version at the decoder's shapes; device time
    with each launch reading another copy of the weights (over 100 MB of
    copies in turn, twice the L2), as the decode step finds every layer's
    weights cold. Per shape: the planner's launch (cluster split of K)
    and, at the decoder's shapes, the time of every other split count the
    kernel takes; at M = 64 bf16 the wrapper's host cost per call beside
    one `torch.addmm`'s."""
    from rgrg_tpu_torch.ops.dense_wint8 import (BLOCK_K, MAX_SPLITS, dense_wint8,
                                                dense_wint8_plain, launch, plan)
    from rgrg_tpu_torch.ops.kernels import sm_count
    sms = sm_count(torch.cuda.current_device())
    shapes = [(name, m, k, n) for m in K4_ROWS for name, (k, n) in K4_PRODUCTS.items()]
    shapes.append(("ragged",) + K4_RAGGED)
    rows = {}
    for name, m, k, n in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, q, s, b = k4_inputs(np, torch, dev, m, k, n, dtype, seed=m + k + n)
            got = dense_wint8(x, q, s, b)
            want = dense_wint8_plain(x, q, s, b)
            torch.cuda.synchronize()
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            check(got.dtype == dtype and tuple(got.shape) == (m, n)
                  and bool(torch.isfinite(got).all()), f"K4 output ({name} M={m} {dt})")
            excess, over_ulp = k4_excess(torch, x, q, s, got, want)
            err = (got.float() - want.float()).abs().max().item()
            check(excess.max().item() <= 0, f"K4 kernel vs plain beyond tolerance ({name} "
                  f"M={m} K={k} N={n} {dt}; max abs err {err})")
            check(torch.equal(dense_wint8(x, q, s, b), got), "K4 differs on a second launch")
            splits, per_split = plan(m, n, k, dtype, sms)
            # the yardstick multiplies by weights dequantised beforehand
            iq, iw = cycled(q), cycled((q.float() * s).to(dtype))
            ms = cuda_ms(torch, lambda: dense_wint8(x, next(iq), s, b), 200)
            plain_ms = cuda_ms(torch, lambda: dense_wint8_plain(x, next(iq), s, b), 20)
            library_ms = cuda_ms(torch, lambda: torch.addmm(b, x, next(iw)), 200)
            sweep = {}
            if name != "ragged":
                out = torch.empty_like(got)
                for z in (1, 2, 4, 8):
                    per = -(-k // z // BLOCK_K[dtype]) * BLOCK_K[dtype]
                    if z <= MAX_SPLITS and -(-k // per) == z:
                        sweep[z] = cuda_ms(torch, lambda: launch(x, next(iq), s, b, out, z,
                                                                 per), 200)
            host = {}
            if m == 64 and dtype == torch.bfloat16:
                w = next(iw)
                host = {"dense_wint8_us": host_us(torch, lambda: dense_wint8(x, q, s, b)),
                        "addmm_us": host_us(torch, lambda: torch.addmm(b, x, w))}
            nbytes = (x.numel() * x.element_size() + q.numel() + s.numel() * 4
                      + b.numel() * b.element_size() + m * n * x.element_size())
            flops = 2 * m * k * n
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / (BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S)
            row = dict(m=m, k=k, n=n, dtype=dt, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, max_abs_err=err, over_one_ulp=over_ulp,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, flops=flops, splits=splits, k_per_split=per_split,
                       blocks=-(-m // 64) * -(-n // 128) * splits,
                       ms_by_splits=sweep, **host)
            rows[f"{name} M={m} {dt}"] = row
            tol = (f"{over_ulp} elements > 1 bf16 ulp" if dtype == torch.bfloat16
                   else "within rtol 2e-5 / atol 2e-4")
            log(f"K4 dense_wint8 {name} M={m} K={k} N={n} {dt}: max_abs_err {err:.3e} "
                f"({tol}) kernel {ms:.4f} ms (plan: {splits} splits of K {per_split}, "
                f"{row['blocks']} blocks), plain "
                f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{nbytes} B = {t_bytes * 1e3:.4f} ms, {flops} FLOP = {t_ops * 1e3:.4f} ms); "
                f"yardstick addmm over dequantised {dt} weights {library_ms:.4f} ms "
                f"[{result['card']}]")
            if sweep:
                log(f"  ms by cluster size: "
                    + ", ".join(f"{z}: {t:.4f}" for z, t in sweep.items()))
            if host:
                log(f"  host us per call: dense_wint8 {host['dense_wint8_us']:.2f}, "
                    f"torch.addmm {host['addmm_us']:.2f} [{result['card']}]")
            del iq, iw
        torch.cuda.empty_cache()
    result["dense_wint8"] = rows


def k4_summary(rows):
    """K4's numbers for the kernels line: the mean launch over one layer's
    four products at the greedy row budget (M = 64) in bf16, the shapes the
    "pallas" serving run gives it."""
    picked = [rows[f"{p} M=64 bf16"] for p in K4_PRODUCTS]
    out = {key: sum(r[key] for r in picked) / len(picked)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms", "dense_wint8_us",
                       "addmm_us")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in picked)
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in picked)
                       else "operations")
    return out


def write_distilbert(np, torch, path, seed=12):
    """A local distilbert-base-uncased directory of the default scorer's
    widths (768 wide, 12 heads, 6 layers, FFN 3072, 512 positions; HF
    DistilBertModel's parameter names) with seeded random weights (N(0,
    0.02), LayerNorm 1 / 0 as HF initialises them) and a small WordPiece
    vocabulary: specials, a few report words, letters and digits with their
    "##" pieces, punctuation."""
    words = ["the", "lung", "lungs", "are", "is", "clear", "no", "pleural", "effusion",
             "seen", "heart", "size", "normal", "there", "acute", "process"]
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + list("0123456789")
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + chars
             + ["##" + c for c in chars] + list(".,;:!?'\"()-/"))
    rng = np.random.default_rng(seed)
    hidden, ffn = 768, 3072

    def rand(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))

    sd = {"embeddings.word_embeddings.weight": rand(len(vocab), hidden),
          "embeddings.position_embeddings.weight": rand(512, hidden),
          "embeddings.LayerNorm.weight": torch.ones(hidden),
          "embeddings.LayerNorm.bias": torch.zeros(hidden)}
    for i in range(6):
        p = f"transformer.layer.{i}"
        for lin, (o, n) in (("attention.q_lin", (hidden, hidden)),
                            ("attention.k_lin", (hidden, hidden)),
                            ("attention.v_lin", (hidden, hidden)),
                            ("attention.out_lin", (hidden, hidden)),
                            ("ffn.lin1", (ffn, hidden)), ("ffn.lin2", (hidden, ffn))):
            sd[f"{p}.{lin}.weight"], sd[f"{p}.{lin}.bias"] = rand(o, n), torch.zeros(o)
        for ln in ("sa_layer_norm", "output_layer_norm"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = torch.ones(hidden), torch.zeros(hidden)
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")


@contextlib.contextmanager
def distilbert_dir(path):
    """$RGRG_DISTILBERT_DIR names `path` inside the block: generators built
    with their defaults there assemble with soft dedup."""
    previous = os.environ.get("RGRG_DISTILBERT_DIR")
    os.environ["RGRG_DISTILBERT_DIR"] = path
    try:
        yield
    finally:
        if previous is None:
            del os.environ["RGRG_DISTILBERT_DIR"]
        else:
            os.environ["RGRG_DISTILBERT_DIR"] = previous


def phase_soft_dedup(np, torch, dev, result):
    """The soft-dedup default: with $RGRG_DISTILBERT_DIR naming a random
    distilbert of the default scorer's widths (write_distilbert),
    default_scorer on the card and on the CPU give the same BERTScore F1
    (within 1e-5: f32 both, TF32 off) and the shorter sentence of a
    near-duplicate pair is dropped. Returns the distilbert's directory."""
    from rgrg_tpu_torch.eval import bertscore as bs
    from rgrg_tpu_torch.text.report import assemble_report
    path = os.path.join(ROOT, "build", "smoke_distilbert")
    write_distilbert(np, torch, path)
    with distilbert_dir(path):
        card_scorer = bs.default_scorer(device=dev)
        cpu_scorer = bs.default_scorer(device="cpu")
    check(card_scorer is not None and card_scorer.device.type == dev.type, "card scorer")
    long, short = "The lungs are clear .", "the lungs are clear."
    sents = ["No pleural effusion seen.", "Heart size is normal.", "There is no acute process.",
             "The heart is 12 cm, size normal.", "Lungs: no effusion; clear."]
    pairs = [(a, b) for i, a in enumerate(sents) for b in sents[i + 1:]] + [(long, short)]
    got, want = card_scorer(pairs), cpu_scorer(pairs)
    err = max(abs(a - b) for a, b in zip(got, want))
    check(err <= 1e-5, f"BERTScore F1 card vs CPU max abs err {err}")
    check(got[-1] > 0.999, f"near-duplicate F1 {got[-1]}")
    report = assemble_report([long, sents[0], "The lungs are clear."], card_scorer)
    check(report == "The lungs are clear . No pleural effusion seen.", f"soft dedup: {report!r}")
    _, ms = timed(torch, lambda: card_scorer(pairs))
    log(f"soft dedup: default_scorer on the card == CPU (F1 max abs err {err:.2e} over "
        f"{len(pairs)} pairs; F1 range {min(got):.3f}-{max(got[:-1]):.3f}, near-duplicate "
        f"{got[-1]:.6f}); shorter near-duplicate dropped; one scorer call over "
        f"{len(pairs)} pairs {ms:.1f} ms [{result['card']}]")
    result["soft_dedup"] = dict(f1_max_abs_err=err, pairs=len(pairs), call_ms=ms)
    return path


def phase_reference(np, torch, dev):
    """Small model, same weights and uint8 inputs, on the card (kernels) and
    on the CPU (plain versions): identical reports and decisions, greedy
    and at the beam-4 default. The decoder weights are scaled up (x8) so
    the random decoder's choices are not near-uniform. Inputs are the first
    seeded batch whose decisions all have margins well above the two
    devices' f32 disagreement (tests/torch_parity.py). The generators are
    built with their defaults, so with $RGRG_DISTILBERT_DIR set they
    assemble with soft dedup on their own devices."""
    from rgrg_tpu_torch.eval.bertscore import BERTScorer
    from rgrg_tpu_torch.models.full_model import RGRG
    from tests.torch_parity import (beam_score_margin, greedy_logit_margin,
                                    has_parity_margins)

    cfg = small_config()
    g_cpu, g_gpu = small_generators(torch, dev, cfg)
    if os.environ.get("RGRG_DISTILBERT_DIR"):
        check(isinstance(g_gpu.similarity_fn, BERTScorer)
              and g_gpu.similarity_fn.device.type == "cuda"
              and isinstance(g_cpu.similarity_fn, BERTScorer)
              and g_cpu.similarity_fn.device.type == "cpu",
              "the default generators did not take the soft-dedup scorer on their devices")
    p_cpu = g_cpu.params
    shape = (1024, 768)  # exact 2x downscale: both resize routes agree
    max_length, min_gap = 12, 1e-4
    for seed in range(24):
        images = list(np.random.default_rng(seed).integers(0, 256, (2, *shape),
                                                           dtype=np.uint8))
        x = g_cpu.preprocess(images)
        if not has_parity_margins(p_cpu["detector"], x):
            continue
        det = RGRG(cfg).detect(p_cpu, x)
        feats = det["region_features"][det["selected_regions"]]
        if (feats.shape[0]
                and greedy_logit_margin(p_cpu["decoder"], feats, cfg.decoder,
                                        max_length) >= min_gap
                and beam_score_margin(p_cpu["decoder"], feats, cfg.decoder, max_length,
                                      cfg.generation.num_beams, True) >= min_gap):
            break
    else:
        raise RuntimeError("no seeded reference input with decision margins")
    for name, kw in (("greedy", {"num_beams": 1}), ("beam-4 default", {})):
        want = g_cpu.generate_reports(images, max_length=max_length, **kw)
        got = g_gpu.generate_reports(images, max_length=max_length, **kw)
        same_reports(np, got, want, f"card vs CPU, {name}")
        n_sel = int(sum(r.selected_regions.sum() for r in got))
        log(f"reference ({name}): input seed {seed}, 2 images, {n_sel} regions decoded: "
            f"card == CPU (reports, sentences, selection, detections; boxes within 1e-2 px; "
            f"soft dedup {'on' if g_gpu.similarity_fn else 'off'})")


def same_reports(np, got, want, what):
    check(len(got) == len(want), f"report count ({what})")
    for g, w in zip(got, want):
        check(g.report == w.report, f"reports differ ({what})")
        check(g.region_sentences == w.region_sentences, f"sentences differ ({what})")
        check(np.array_equal(g.selected_regions, w.selected_regions),
              f"selection differs ({what})")
        check(np.array_equal(g.class_detected, w.class_detected), f"detections differ ({what})")
        check(np.allclose(g.top_region_boxes, w.top_region_boxes, rtol=1e-4, atol=1e-2),
              f"boxes differ ({what})")


def small_config(**generation):
    """Shallow backbone, 32 proposals, a 2-layer 64-wide decoder."""
    from rgrg_tpu_torch.core import config as TC
    return TC.ModelConfig(
        detector=TC.DetectorConfig(backbone_stages=(1, 1, 1, 1),
                                   rpn=TC.RPNConfig(pre_nms_top_n_test=32)),
        decoder=TC.DecoderConfig(vocab_size=512, hidden_dim=64, num_heads=4,
                                 num_layers=2, max_positions=64, bos_token_id=0,
                                 eos_token_id=0, pad_token_id=0),
        generation=TC.GenerationConfig(**generation))


def small_generators(torch, dev, cfg, snap=False):
    """(CPU generator, card generator) over the same seeded weights; the
    decoder weights scaled x8 so a random decoder's choices are not
    near-uniform, and with snap=True projected onto their own int8 grid
    (q * s), which weights_int8 then quantizes without loss."""
    import copy
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.models import gpt2
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
    cpu = torch.device("cpu")
    p_cpu = RGRG(cfg).init(seed=3, device=cpu)
    p_cpu["decoder"] = _tree_map(p_cpu["decoder"], lambda t: t * 8.0)
    if snap:
        q = gpt2.quantize_decoder_weights(p_cpu["decoder"], layout="xla")
        for name, block in q.items():
            if name.startswith("h_"):
                for grp, kn in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                                ("mlp", "c_proj")):
                    qd = block[grp][kn]
                    p_cpu["decoder"][name][grp][kn]["kernel"] = qd["kernel"].float() * qd["scale"]
    p_gpu = {"detector": copy.deepcopy(p_cpu["detector"]).to(dev),
             "decoder": _tree_map(p_cpu["decoder"], lambda t: t.to(dev))}
    tok = GPT2Tokenizer.dummy()
    return ReportGenerator(p_cpu, tok, cfg=cfg), ReportGenerator(p_gpu, tok, cfg=cfg)


def phase_reference_serving(np, torch, dev):
    """generate_reports_pipelined on the small model, card vs CPU, with
    weights_int8 off, "xla" and "pallas" over decoder weights on their int8
    grid: 4 batches of 2 at the serving defaults (greedy, int8 KV cache,
    speculation), max_length 12 over length buckets (4, 12) so the cascade
    continues past its first rung. Batches 1-3 hold 1024x768 images (the
    device-resize route), batch 4 a 1024x768 and a 768x1024 image (mixed:
    the host route). Each image is the first seeded one whose detector and
    greedy decisions (int8 cache) clear 1e-3, well above the devices' f32
    disagreement and the int8 cache's rounding."""
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
    from rgrg_tpu_torch.serving import CascadeStats, generate_reports_pipelined
    from tests.torch_parity import greedy_logit_margin, has_parity_margins

    max_length, buckets, min_gap = 12, (4, 12), 1e-3
    cfg = small_config(length_buckets=buckets)
    g_cpu, g_gpu = small_generators(torch, dev, cfg, snap=True)
    p_cpu = g_cpu.params

    def margined(shape, count):
        found = []
        for seed in range(64):
            image = np.random.default_rng([shape[0], seed]).integers(0, 256, shape,
                                                                     dtype=np.uint8)
            x = g_cpu.preprocess([image])
            if not has_parity_margins(p_cpu["detector"], x):
                continue
            det = RGRG(cfg).detect(p_cpu, x)
            feats = det["region_features"][det["selected_regions"]]
            if feats.shape[0] and greedy_logit_margin(
                    p_cpu["decoder"], feats, cfg.decoder, max_length,
                    cache_dtype=torch.int8) >= min_gap:
                found.append(image)
                if len(found) == count:
                    return found
        raise RuntimeError(f"no seeded {shape} reference inputs with decision margins")

    same = margined((1024, 768), 6)
    images = same + [same[0]] + margined((768, 1024), 1)
    check(g_cpu.preprocess_raw(images[-2:])[0] is None, "the mixed batch takes the host route")
    runs = {}
    for w in (False, True, "pallas"):
        for where, gen in (("cpu", g_cpu), ("card", g_gpu)):
            stats = CascadeStats()
            before = dense_wint8.launches
            runs[w, where] = ([r for c in generate_reports_pipelined(
                gen, images, batch_size=2, max_length=max_length, weights_int8=w,
                cascade_stats=stats) for r in c], stats.snapshot())
            launched = dense_wint8.launches - before
            check(launched > 0 if (w, where) == ("pallas", "card") else launched == 0,
                  f"K4 launches {launched} (weights_int8={w!r}, {where})")
        same_reports(np, runs[w, "card"][0], runs[w, "cpu"][0],
                     f"pipelined card vs CPU, weights_int8={w!r}")
        check(runs[w, "card"][1] == runs[w, "cpu"][1], f"CascadeStats differ (weights_int8={w!r})")
        same_reports(np, runs[w, "card"][0], runs[False, "cpu"][0],
                     f"pipelined weights_int8={w!r} vs off")
    reports, snap = runs["pallas", "card"]
    check(snap["rows_entering_rung"].get(buckets[1], 0) > 0,
          "the cascade did not continue past its first rung")
    n_sel = int(sum(r.selected_regions.sum() for r in reports))
    log(f"reference serving: 8 images in 4 batches of 2 (the last mixed-shape), {n_sel} "
        f"regions; card == CPU and identical across weights_int8 off / xla / pallas "
        f"(reports, sentences, selection, detections; boxes within 1e-2 px); cascade {snap}")


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tensors(tree):
    """Every tensor of a nested dict (the decoder's parameter tree)."""
    out = []
    for v in tree.values():
        out += _tensors(v) if isinstance(v, dict) else [v]
    return out


def full_width_config():
    """ResNet-50, 1000 proposals, bf16 detector; GPT-2 Medium decoder."""
    from rgrg_tpu_torch.core.config import DetectorConfig, ModelConfig
    cfg = ModelConfig(detector=DetectorConfig(dtype="bfloat16"))
    dec = cfg.decoder
    check((dec.num_layers, dec.hidden_dim, dec.num_heads, dec.vocab_size)
          == (24, 1024, 16, 50257), "decoder is not GPT-2 Medium")
    check(cfg.detector.backbone_stages == (3, 4, 6, 3)
          and cfg.detector.rpn.pre_nms_top_n_test == 1000, "detector is not full width")
    return cfg


def serve(np, torch, gen, cfg, requests, **kw):
    """Answer the requests through generate_reports, each timed on the host
    clock around synchronized work; check the reports' shape."""
    times, n_regions = [], []
    for reqs in requests:
        t0 = time.perf_counter()
        reports = gen.generate_reports(reqs, max_length=MAX_LENGTH, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(len(reports) == BATCH, "wrong number of reports")
        for r in reports:
            check(isinstance(r.report, str), "report is not text")
            check(r.top_region_boxes.shape == (29, 4)
                  and np.isfinite(r.top_region_boxes).all(), "bad region boxes")
            check(len(r.region_sentences) == int(r.selected_regions.sum()),
                  "a selected region has no sentence")
        n_regions.append(int(sum(r.selected_regions.sum() for r in reports)))
    steady = sum(times[1:]) / len(times[1:])
    return times, steady, n_regions


def phase_main(np, torch, dev, result, cfg, raw_shape=RAW_SHAPE):
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

    t0 = time.perf_counter()
    params = RGRG(cfg).init(seed=0, device=dev, decoder_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = (list(params["detector"].parameters()) + list(params["detector"].buffers())
               + _tensors(params["decoder"]))
    check(all(t.device.type == dev.type for t in tensors), "a parameter is off the card")
    n_params = sum(t.numel() for t in tensors)
    gen = ReportGenerator(params, GPT2Tokenizer.dummy(), cfg=cfg)
    check(cfg.generation.num_beams == BEAMS, "the default decode is not beam 4")
    rng = np.random.default_rng(7)
    requests = [list(rng.integers(0, 256, (BATCH, *raw_shape), dtype=np.uint8))
                for _ in range(REQUESTS)]
    log(f"main path: random params {n_params / 1e6:.1f} M tensors on {dev} "
        f"(init {init_s:.1f} s); {REQUESTS} requests x {BATCH} uint8 {raw_shape}")
    chunks = -(-cfg.detector.rpn.pre_nms_top_n_test // cfg.detector.roi.proposal_chunk)
    layers = cfg.decoder.num_layers

    def reset_counts():
        nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
        beam_generate.steps = 0

    def read_counts():
        return {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches,
                "beam_attention": beam_attention.launches}

    paths = {}
    for name, kw in (("greedy", {"num_beams": 1}), ("beam4", {})):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, steady, n_regions = serve(np, torch, gen, cfg, requests, **kw)
        launches, steps = read_counts(), beam_generate.steps
        check(launches["nms"] == REQUESTS, f"{name}: NMS launches {launches['nms']} != "
              f"{REQUESTS}")
        check(launches["roi_align"] == REQUESTS * chunks,
              f"{name}: RoIAlign launches {launches['roi_align']} != {REQUESTS * chunks}")
        if name == "greedy":
            check(launches["beam_attention"] == 0 and steps == 0,
                  "the greedy path ran beam search")
        else:
            check(steps > 0 and launches["beam_attention"] == layers * steps,
                  f"beam attention launches {launches['beam_attention']} != {layers} x "
                  f"{steps} decode steps")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"main path {name}: ms per request {['%.1f' % t for t in times]} (first "
            f"includes warm-up), steady {steady:.1f} ms = {BATCH / steady * 1e3:.2f} "
            f"reports/s; regions decoded per request {n_regions}; launches {launches}, "
            f"beam decode steps {steps}; peak {peak_gb:.1f} GB [{result['card']}]")
        paths[name] = dict(ms_per_request=times, steady_ms=steady,
                           reports_per_s=BATCH / steady * 1e3, regions=n_regions,
                           launches=launches, beam_steps=steps, peak_gb=peak_gb)

    # int8 KV cache: re-decode the last request's selected regions, greedy
    # and beam 4 (the beam decode runs K3's int8 variant)
    model = gen.model
    det = model.detect(params, gen.preprocess(requests[-1]))
    check(all(v.device.type == dev.type for v in det.values()), "detector output off the card")
    sel = det["selected_regions"]

    def decode(kv, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, dec = model.decode_selected_cascade(params, det["region_features"], sel,
                                                 MAX_LENGTH, kv_cache_dtype=kv, **kw)
        torch.cuda.synchronize()
        return ids, dec, (time.perf_counter() - t) * 1e3

    decodes = {}
    for name, kw in (("greedy", {}), ("beam4", {"num_beams": BEAMS, "early_stopping": True})):
        launches0 = beam_attention.launches
        ids16, dec16, ms16 = decode(None, **kw)
        ids8, dec8, ms8 = decode(torch.int8, **kw)
        if name == "beam4":
            check(beam_attention.launches > launches0, "int8 beam decode skipped K3")
        check(ids8.device.type == dev.type and tuple(ids8.shape) == (BATCH, 29, MAX_LENGTH),
              "int8 decode output")
        check(torch.equal(dec8, sel), "int8 decode skipped a selected region")
        valid = ids8[sel]
        check(bool((valid[:, 0] == cfg.decoder.bos_token_id).all())
              and int(valid.min()) >= 0 and int(valid.max()) < cfg.decoder.vocab_size,
              "int8 decode ids out of range")
        agree = (ids8[sel] == ids16[sel]).float().mean().item()
        log(f"int8 KV decode {name}: {int(sel.sum())} regions, {ms8:.1f} ms (bf16 cache "
            f"{ms16:.1f} ms); token agreement with the bf16 cache {agree:.3f} "
            f"[{result['card']}]")
        decodes[name] = dict(int8_decode_ms=ms8, bf16_decode_ms=ms16,
                             int8_bf16_token_agreement=agree)
    result["main"] = dict(paths=paths, decodes=decodes, init_s=init_s,
                          params_m=n_params / 1e6)
    result["breakdown"] = {
        name: breakdown(torch, gen, params, requests[-1], decodes[name]["bf16_decode_ms"],
                        paths[name]["steady_ms"], name, **kw)
        for name, kw in (("greedy", {"num_beams": 1}), ("beam4", {}))}
    return paths["beam4"]["launches"], gen


def timed(torch, fn, reps=3):
    """(fn()'s last result, its mean ms over `reps` synchronized calls)."""
    out, ts = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return out, sum(ts) / len(ts)


def breakdown(torch, gen, params, images, decode_ms, steady_ms, name, **kw):
    """Where a request's time goes: the host preprocessing with its upload,
    the detector and the decode cascade timed apart (host clock around
    synchronized work), then (greedy only) one detect and one whole request
    (generate_reports with `kw`) under torch.profiler for device busy time
    by kernel. Runs after the launch counters were read."""
    x, preprocess_ms = timed(torch, lambda: gen.preprocess(images))
    _, detect_ms = timed(torch, lambda: gen.model.detect(params, x))
    log(f"breakdown {name}: host preprocess + upload {preprocess_ms:.1f} ms, detect "
        f"{detect_ms:.1f} ms, decode cascade {decode_ms:.1f} ms (bf16 cache)")
    out = {"preprocess_ms": preprocess_ms, "detect_ms": detect_ms, "decode_ms": decode_ms}
    if name == "greedy":  # the detector is the same on both paths: what follows K2
        out["detect_profile"] = profiled(torch, lambda: gen.model.detect(params, x),
                                         detect_ms, "breakdown detect", "detect")
    out["profile"] = profiled(
        torch, lambda: gen.generate_reports(images, max_length=MAX_LENGTH, **kw),
        steady_ms, f"breakdown {name}", "request")
    return out


def profiled(torch, fn, steady_ms, what, unit):
    """Run fn() once under torch.profiler: device busy time, the idle share
    against the unprofiled `steady_ms` of one `unit` (and against the
    profiled wall time), the top device kernels, and the hand-written
    kernels' device time per launch. None when the profiler saw no device
    time. Only device activity is traced: every number here reads device
    events, and the host's op events would multiply the post-processing,
    which takes its own seconds (logged)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        t_post = time.perf_counter()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # device-side events only (kernels, memcpy, memset): the aten ops that
    # launched them carry the same time again
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    post_s = time.perf_counter() - t_post
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        log(f"{what}: profiler saw no device time (device busy share not measured)")
        return None
    top = [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "calls": e.count}
           for e in events[:12] if dev_us(e) > 0]
    launches = sum(e.count for e in events)
    log(f"{what}: device busy {busy_ms:.1f} ms in one {unit} ({launches} device ops); "
        f"idle share {1 - busy_ms / steady_ms:.1%} of the unprofiled {steady_ms:.1f} ms "
        f"{unit} ({1 - busy_ms / wall_ms:.1%} of the profiled {wall_ms:.1f} ms); the "
        f"profiler's post-processing {post_s:.1f} s")
    for row in top:
        log(f"  {row['device_ms']:9.2f} ms {row['calls']:7d}x  {row['name']}")
    out = {"profiled_wall_ms": wall_ms, "post_processing_s": post_s, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / steady_ms,
           "idle_share_profiled": 1 - busy_ms / wall_ms,
           "device_ops": launches, "top": top}
    # the kernels' own device time on this path, at the shapes it gives them
    for kernel in ("nms_keep_mask_kernel", "roi_align_kernel", "beam_attn_kernel",
                   "dense_wint8_kernel"):
        hits = [e for e in events if kernel in e.key]
        calls = sum(e.count for e in hits)
        if calls:
            ms = sum(dev_us(e) for e in hits) / 1e3
            log(f"{what}: {kernel} {ms:.2f} ms of device time in {calls} "
                f"launches ({ms / calls * 1e3:.1f} us each)")
            out[kernel] = {"device_ms": ms, "calls": calls}
            if len(hits) > 1:  # K1's words and sweep launches, K2's routes
                out[kernel]["by_name"] = {e.key[:90]: dev_us(e) / 1e3 for e in hits}
                for e in hits:
                    log(f"  {dev_us(e) / 1e3:.3f} ms in {e.count} launches: {e.key[:90]}")
    return out


def phase_serving(np, torch, dev, result, gen, cfg):
    """The serving path: generate_reports_pipelined over SERVE_BATCHES
    batches of BATCH uint8 X-rays of one shape (the device-resize route) at
    the serving defaults (greedy, int8 KV cache, speculation; max_length
    MAX_LENGTH fits the first length bucket, so one rung), with bf16 decoder
    weights and with weights_int8="pallas" (K4). Returns the K4 launch
    count of the "pallas" run."""
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.decode.greedy import greedy_generate
    from rgrg_tpu_torch.models import gpt2
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.serving import CascadeStats, generate_reports_pipelined

    rng = np.random.default_rng(11)
    images = list(rng.integers(0, 256, (SERVE_BATCHES * BATCH, *RAW_SHAPE), dtype=np.uint8))
    per_step = 4 * cfg.decoder.num_layers  # K4 launches per decode step and per prefill
    chunks = -(-cfg.detector.rpn.pre_nms_top_n_test // cfg.detector.roi.proposal_chunk)
    runs = {}
    for name, w in (("bf16", False), ("pallas", "pallas")):
        # a warm-up batch; the yields of a pipelined run lag its dispatch by
        # a batch, so the timed run is measured from its start to its last
        # report
        _, warm_ms = timed(torch, lambda: [r for c in generate_reports_pipelined(
            gen, images[:BATCH], batch_size=BATCH, max_length=MAX_LENGTH, weights_int8=w)
            for r in c], reps=1)
        stats = CascadeStats()
        nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
        dense_wint8.launches = beam_generate.steps = 0
        greedy_generate.steps = greedy_generate.prefills = 0
        t0 = time.perf_counter()
        marks, n_regions = [], []
        for reports in generate_reports_pipelined(gen, images, batch_size=BATCH,
                                                  max_length=MAX_LENGTH, weights_int8=w,
                                                  cascade_stats=stats):
            marks.append(time.perf_counter())
            check(len(reports) == BATCH, f"serving {name}: wrong number of reports")
            for r in reports:
                check(isinstance(r.report, str) and r.top_region_boxes.shape == (29, 4)
                      and np.isfinite(r.top_region_boxes).all()
                      and len(r.region_sentences) == int(r.selected_regions.sum()),
                      f"serving {name}: malformed report")
            n_regions.append(int(sum(r.selected_regions.sum() for r in reports)))
            # the main thread launches every kernel, and it waits here
            units = greedy_generate.steps + greedy_generate.prefills
            want = per_step * units if w else 0
            check(dense_wint8.launches == want, f"serving {name}: K4 launches "
                  f"{dense_wint8.launches} != {want} after batch {len(marks)} ({units} "
                  f"decode steps + prefills)")
        counts = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches,
                  "beam_attention": beam_attention.launches,
                  "dense_wint8": dense_wint8.launches,
                  "decode_steps": greedy_generate.steps,
                  "prefills": greedy_generate.prefills}
        check(len(marks) == SERVE_BATCHES, f"serving {name}: {len(marks)} batches")
        check(counts["nms"] == SERVE_BATCHES and counts["roi_align"] == SERVE_BATCHES * chunks
              and counts["beam_attention"] == 0 and counts["decode_steps"] > 0,
              f"serving {name}: launches {counts}")
        steady = (marks[-1] - t0) * 1e3 / SERVE_BATCHES
        rate = SERVE_BATCHES * BATCH / (marks[-1] - t0)
        # one batch's decode alone: the last batch's selection, same weights
        params = dict(gen.params)
        if w:
            params["decoder"] = gpt2.quantize_decoder_weights(params["decoder"], layout=w)
        x = gen.preprocess(images[-BATCH:])
        det = gen.model.detect(params, x)
        sel = det["selected_regions"]
        _, decode_ms = timed(torch, lambda: gen.model.decode_selected_cascade(
            params, det["region_features"], sel, MAX_LENGTH, kv_cache_dtype=torch.int8,
            first_count=int(sel.sum())))
        log(f"serving {name}: warm-up batch {warm_ms:.1f} ms; then {SERVE_BATCHES} batches, "
            f"yields at {[round((m - t0) * 1e3, 1) for m in marks]} ms: {steady:.1f} ms per "
            f"batch of {BATCH} = {rate:.2f} reports/s; regions {n_regions}; decode of one "
            f"batch {decode_ms:.1f} ms (int8 KV); launches {counts}; cascade "
            f"{stats.snapshot()} [{result['card']}]")
        prof = profiled(torch, lambda: [r for c in generate_reports_pipelined(
            gen, images[:BATCH], batch_size=BATCH, max_length=MAX_LENGTH, weights_int8=w)
            for r in c], steady, f"serving {name}", "batch")
        runs[name] = dict(warmup_ms=warm_ms, batch_yield_ms=[(m - t0) * 1e3 for m in marks],
                          steady_ms=steady,
                          reports_per_s=rate, regions=n_regions, decode_ms=decode_ms,
                          launches=counts, cascade=stats.snapshot(), profile=prof)
        del params, det, x

    # a mixed-shape batch: the host preprocessing route
    mixed = [np.ascontiguousarray(im if i % 2 == 0 else im.T)
             for i, im in enumerate(images[:BATCH])]
    check(gen.preprocess_raw(mixed)[0] is None, "mixed shapes took the device route")
    _, host_ms = timed(torch, lambda: gen.preprocess(mixed))
    reports, mixed_ms = timed(torch, lambda: [r for c in generate_reports_pipelined(
        gen, mixed, batch_size=BATCH, max_length=MAX_LENGTH) for r in c], reps=1)
    check(len(reports) == BATCH and all(isinstance(r.report, str) for r in reports),
          "mixed-shape batch reports")
    log(f"serving mixed shapes {RAW_SHAPE} / {RAW_SHAPE[::-1]}: host preprocess + upload "
        f"{host_ms:.1f} ms per batch of {BATCH} = {host_ms / BATCH:.1f} ms per image "
        f"({os.cpu_count()} host cores); one pipelined batch {mixed_ms:.1f} ms "
        f"[{result['card']}]")
    runs["mixed"] = dict(host_preprocess_ms_per_image=host_ms / BATCH, batch_ms=mixed_ms)
    result["serving"] = runs
    return runs["pallas"]["launches"]["dense_wint8"]


class ReportSentences:
    """A tokenizer that names the i-th region it decodes SENTENCES[i % 10],
    a list that holds near-duplicate pairs. The random decoder's ids decode
    to byte soup that rarely splits into sentences, and often to the same
    text for every region, so the scorer would almost never run; with
    these, a report holds one sentence per selected region, as a trained
    decoder's does. Two instances called in the same order name the same
    regions alike."""

    SENTENCES = ["The lungs are clear.", "The lungs are clear .", "No pleural effusion seen.",
                 "No pleural effusion is seen.", "Heart size is normal.",
                 "The heart size is normal.", "There is no acute process.",
                 "No acute process.", "The heart is 12 cm, size normal.",
                 "Lungs: no effusion; clear."]

    def __init__(self):
        self.calls = 0

    def decode(self, ids, skip_special_tokens=True):
        self.calls += 1
        return self.SENTENCES[(self.calls - 1) % len(self.SENTENCES)]


def phase_soft_dedup_full_width(np, torch, dev, result, gen, cfg):
    """What the soft-dedup default costs at full width. With
    $RGRG_DISTILBERT_DIR naming the smoke's 768-wide distilbert, a
    ReportGenerator built with its defaults over the main path's weights
    takes the scorer on the card; an exact-dedup one shares the weights.
    Each names region sentences through its own ReportSentences. They answer greedy
    requests of 8 raw X-rays alternately (same images; the region
    sentences must agree, and soft dedup may only drop sentences), then
    the soft-dedup one serves SERVE_BATCHES batches through
    generate_reports_pipelined(weights_int8="pallas") after a warm-up
    batch, and the exact-dedup one the same batches after it, each timed
    as the serving phase times its runs (there the scorer runs on the post
    thread, and its copy of the F1s to the host waits for the decode queued
    before it). The scorer's calls, pairs and host ms are counted."""
    from rgrg_tpu_torch.eval.bertscore import BERTScorer
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.serving import generate_reports_pipelined
    from rgrg_tpu_torch.text.report import split_sentences

    exact = ReportGenerator(gen.params, ReportSentences(), cfg=cfg, similarity_fn=None)
    soft = ReportGenerator(gen.params, ReportSentences(), cfg=cfg)
    scorer = soft.similarity_fn
    check(isinstance(scorer, BERTScorer) and scorer.device.type == dev.type,
          "the default generator did not take the soft-dedup scorer on the card")
    tally = {"calls": 0, "pairs": 0, "ms": 0.0}

    def counted(pairs):
        t = time.perf_counter()
        out = scorer(pairs)
        tally["calls"] += 1
        tally["pairs"] += len(pairs)
        tally["ms"] += (time.perf_counter() - t) * 1e3
        return out

    soft.similarity_fn = counted
    images = list(np.random.default_rng(13).integers(0, 256, (BATCH, *RAW_SHAPE),
                                                     dtype=np.uint8))
    times = {"exact": [], "soft": []}
    dropped = 0
    for _ in range(2):
        out = {}
        for name, g in (("exact", exact), ("soft", soft)):
            out[name], ms = timed(torch, lambda: g.generate_reports(
                images, max_length=MAX_LENGTH, num_beams=1), reps=1)
            times[name].append(ms)
        for e, s in zip(out["exact"], out["soft"]):
            check(e.region_sentences == s.region_sentences, "soft vs exact dedup: the "
                  "region sentences differ")
            kept, full = split_sentences(s.report), split_sentences(e.report)
            check(set(kept) <= set(full), "soft dedup added a sentence")
            dropped += len(full) - len(kept)
    request = dict(tally)
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"soft dedup, full width, greedy requests of {BATCH}: exact dedup "
        f"{['%.1f' % t for t in times['exact']]} ms, soft dedup "
        f"{['%.1f' % t for t in times['soft']]} ms (means {mean['exact']:.1f} / "
        f"{mean['soft']:.1f}); scorer {request['calls']} calls, {request['pairs']} pairs, "
        f"{request['ms']:.1f} ms host time over 2 requests; {dropped} sentences dropped "
        f"[{result['card']}]")

    served = list(np.random.default_rng(11).integers(
        0, 256, (SERVE_BATCHES * BATCH, *RAW_SHAPE), dtype=np.uint8))

    def serve_batches(g):
        """(warm-up batch ms, ms per batch over SERVE_BATCHES, reports/s)"""
        _, warm_ms = timed(torch, lambda: [r for c in generate_reports_pipelined(
            g, served[:BATCH], batch_size=BATCH, max_length=MAX_LENGTH,
            weights_int8="pallas") for r in c], reps=1)
        tally.update(calls=0, pairs=0, ms=0.0)
        t0 = time.perf_counter()
        n_reports = 0
        for reports in generate_reports_pipelined(g, served, batch_size=BATCH,
                                                  max_length=MAX_LENGTH, weights_int8="pallas"):
            check(len(reports) == BATCH and all(isinstance(r.report, str) for r in reports),
                  "soft-dedup phase, serving: malformed reports")
            n_reports += len(reports)
        wall = time.perf_counter() - t0
        check(n_reports == SERVE_BATCHES * BATCH, f"soft-dedup phase: {n_reports} reports")
        return warm_ms, wall * 1e3 / SERVE_BATCHES, n_reports / wall

    serving = {}
    for name, g in (("soft", soft), ("exact", exact)):
        warm_ms, steady, rate = serve_batches(g)
        serving[name] = dict(warmup_ms=warm_ms, steady_ms=steady, reports_per_s=rate,
                             scorer=dict(tally))
    log(f"soft dedup, full width, pipelined weights_int8='pallas', {SERVE_BATCHES} batches "
        f"of {BATCH} after a warm-up batch: soft dedup {serving['soft']['steady_ms']:.1f} ms "
        f"per batch = {serving['soft']['reports_per_s']:.2f} reports/s (scorer "
        f"{serving['soft']['scorer']['calls']} calls, {serving['soft']['scorer']['pairs']} "
        f"pairs, {serving['soft']['scorer']['ms']:.1f} ms host time on the post thread); "
        f"exact dedup {serving['exact']['steady_ms']:.1f} ms = "
        f"{serving['exact']['reports_per_s']:.2f} reports/s [{result['card']}]")
    result["soft_dedup_full_width"] = dict(
        request_ms=times, request_mean_ms=mean, request_scorer=request,
        sentences_dropped=dropped, serving=serving)


# ---------------------------------------------------------------- evaluation

SYLLABLES = [c + v for c in "bcdfghklmnprstvz" for v in "aeiou"]


def report_tokenizer(vocab_size, eos_id, byte_level=False, break_every=0):
    """A GPT-2 tokenizer of `vocab_size` ids for random weights: EOS at
    `eos_id`, report words (" lungs", ".") first, then pseudo-words of two
    or three syllables, so any decode reads as words. byte_level adds the
    byte alphabet and merges that build each report word, so that phrases
    encode (the dataset's BPE encode) as GPT-2's vocabulary would.
    break_every > 0 makes every such id a sentence break (". There"), so
    that short decodes give reports of several sentences."""
    from rgrg_tpu_torch.text.tokenizer import ENDOFTEXT, GPT2Tokenizer, _bytes_to_unicode
    from tests.torch_parity import WORDS
    tokens, merges = [], []
    if byte_level:
        tokens += sorted(set(_bytes_to_unicode().values()))
        for w in WORDS:
            piece = "" if w == "." else "Ġ"
            for ch in w:
                if piece:
                    merges.append((piece, ch))
                piece += ch
                tokens.append(piece)
    tokens += ["." if w == "." else "Ġ" + w for w in WORDS]
    vocab = dict.fromkeys(tokens)
    for a, b, c in itertools.product(SYLLABLES, SYLLABLES, [""] + SYLLABLES):
        if len(vocab) >= vocab_size - 1:
            break
        vocab.setdefault("Ġ" + a + b + c)
    ordered = list(vocab)[:vocab_size - 1]
    if break_every:
        ordered = [f".ĠThere{'Ġ' * i}" if i and i % break_every == 0 else t
                   for i, t in enumerate(ordered)]
    ordered.insert(eos_id, ENDOFTEXT)
    return GPT2Tokenizer({t: i for i, t in enumerate(ordered)}, list(dict.fromkeys(merges)))


def write_chexbert_vocab(path):
    """A WordPiece vocabulary for the smoke's CheXbert: specials, the
    report words, the pseudo-words' syllables with their "##" pieces,
    letters, digits and punctuation."""
    from tests.torch_parity import WORDS
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + list("0123456789")
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + sorted({w.lower() for w in WORDS if w != "."}) + SYLLABLES
             + ["##" + s for s in SYLLABLES] + chars + ["##" + c for c in chars]
             + list(".,;:!?'\"()-/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(dict.fromkeys(vocab)) + "\n")
    return path


def chexbert_labeler(torch, cfg, vocab_path, device, seed):
    """The evaluate CLI's labeler (reports -> [14, N] labels) over a
    CheXbert of `cfg`'s widths with seeded random weights
    (chexbert_state_dict), converted by convert_chexbert; the labeler's
    .logits(reports) gives the 14 heads' logits."""
    from rgrg_tpu_torch.eval.chexbert import chexbert_logits, convert_chexbert
    from rgrg_tpu_torch.evaluate import chexbert_labeler as cli_labeler
    from rgrg_tpu_torch.text.wordpiece import WordPieceTokenizer
    sd = chexbert_state_dict(torch, cfg, seed)
    params = convert_chexbert(sd, device=device)
    label = cli_labeler(params, vocab_path, cfg)
    wp = WordPieceTokenizer.from_vocab_file(vocab_path)

    def logits(reports):
        ids, mask = wp.encode_batch(list(reports))
        with torch.inference_mode():
            return [x.cpu() for x in chexbert_logits(
                params, torch.tensor(ids, device=device),
                torch.tensor(mask, dtype=torch.float32, device=device), cfg)]
    label.logits = logits
    return label


def same_scores(got, want, what, tol=1e-5, path="scores"):
    """Scores dicts equal: strings, decisions and counts exactly, floats
    within `tol`."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(), f"{what}: keys of {path}")
        for k in want:
            same_scores(got[k], want[k], what, tol, f"{path}.{k}")
    elif isinstance(want, float):
        check(isinstance(got, float) and abs(got - want) <= tol,
              f"{what}: {path} {got} != {want}")
    else:
        check(got == want, f"{what}: {path} {got!r} != {want!r}")


def phase_eval_reference(np, torch, dev, result):
    """evaluate_model on the small model, card (K1-K3) vs CPU (plain
    versions), greedy and beam 4 with early stopping, at max_length 12 over
    length buckets (6, 12) (the beam run with a CascadeStats that bails out
    after its first batch), with soft dedup (the default scorer of phase
    6a, "auto" on each device) and a random small CheXbert on each device.
    The scores must be equal: sentences, reports and CE labels identical,
    floats within 1e-5; language_generation's cascade counters too. The
    comparison is meaningful only where every decision has a margin: the
    images are picked for it, and the CPU run's soft-dedup F1s and
    CheXbert logits are checked for one."""
    from rgrg_tpu_torch.eval import bertscore as bs
    from rgrg_tpu_torch.eval.chexbert import BertConfig
    from rgrg_tpu_torch.eval.evaluator import evaluate_model
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.serving import CascadeStats
    from tests.torch_parity import eval_batches, image_with_margins

    max_length, rungs, min_gap = 12, (6, 12), 1e-4
    cfg = small_config(length_buckets=rungs[:1])
    g_cpu, g_gpu = small_generators(torch, dev, cfg)
    with torch.no_grad():  # select most detected regions, so that reports are long
        for g in (g_cpu, g_gpu):
            g.params["detector"].selection_classifier.fc2.bias += 3.0
    tok = report_tokenizer(cfg.decoder.vocab_size, cfg.decoder.eos_token_id, break_every=6)
    images = [image_with_margins(g_cpu.params, cfg, slot, max_length, rungs, min_gap, BEAMS)
              for slot in range(4)]
    batches = eval_batches([np.concatenate(images[i:i + 2]) for i in (0, 2)], seed=5)
    bert_cfg = BertConfig(vocab_size=400, hidden=64, layers=2, heads=4, intermediate=128)
    vocab = write_chexbert_vocab(os.path.join(ROOT, "build", "smoke_chexbert", "vocab.txt"))
    labelers = {d: chexbert_labeler(torch, bert_cfg, vocab, d, seed=21) for d in ("cpu", dev)}
    cpu_scorer = bs.default_scorer(device="cpu")
    check(cpu_scorer is not None, "no soft-dedup scorer: $RGRG_DISTILBERT_DIR is unset")
    f1s = []

    def recorded(pairs):
        out = cpu_scorer(pairs)
        f1s.extend(out)
        return out

    runs = {}
    for name, beams in (("greedy", 1), ("beam4", BEAMS)):
        for where, g, sim in (("cpu", g_cpu, recorded), ("card", g_gpu, "auto")):
            stats = CascadeStats(threshold=1.1, min_rows=1) if beams > 1 else "auto"
            nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
            t0 = time.perf_counter()
            scores = evaluate_model(RGRG(cfg), g.params, batches, tok, num_beams=beams,
                                    max_length=max_length, similarity_fn=sim,
                                    chexbert=labelers["cpu" if where == "cpu" else dev],
                                    cascade_stats=stats)
            runs[name, where] = (scores, (time.perf_counter() - t0) * 1e3)
            counts = (nms_keep_mask.launches, roi_align.launches, beam_attention.launches)
            # the card's scores came through K1-K3 (K3: beam decodes only);
            # the CPU's through their plain versions
            want_launched = ((True, True, beams > 1) if where == "card"
                             else (False, False, False))
            check(tuple(n > 0 for n in counts) == want_launched,
                  f"eval reference {name} on {where}: launches (K1, K2, K3) {counts}")
        want, got = runs[name, "cpu"][0], runs[name, "card"][0]
        lg, jlg = got.pop("language_generation"), want.pop("language_generation")
        check(lg.keys() == jlg.keys() and lg["cascade"] == jlg["cascade"]
              and lg["language_images"] == jlg["language_images"],
              f"eval reference {name}: language_generation {lg} vs {jlg}")
        same_scores(got, want, f"eval reference {name}, card vs CPU")
        check(lg["cascade"]["rows_entering_rung"].get(max_length, 0) > 0,
              f"eval reference {name}: the cascade did not reach its second rung")
        check("CE" in want.get("report", {}) and want["sentence"]["meteor"] >= 0,
              f"eval reference {name}: no CE or sentence scores")
        log(f"eval reference {name}: 2 batches of 2 images, card == CPU (detector, selection, "
            f"abnormal, {len(want['sentence']['per_region_meteor'])} regions' sentence "
            f"METEOR, report NLG and CE within 1e-5); cascade {lg['cascade']}; "
            f"card {runs[name, 'card'][1]:.0f} ms, CPU {runs[name, 'cpu'][1]:.0f} ms "
            f"[{result['card']}]")
    f1_gap = min((abs(f - bs.BERTSCORE_SIMILARITY_THRESHOLD) for f in f1s), default=1.0)
    reports = [r for b in batches for r in b["reference_reports"]]
    logits = labelers["cpu"].logits(reports)
    head_gap = min(float((x.topk(2).values[:, 0] - x.topk(2).values[:, 1]).min())
                   for x in logits)
    check(f1_gap >= min_gap and head_gap >= min_gap,
          f"eval reference: a soft-dedup F1 ({f1_gap:.2e} from 0.9) or a CheXbert head "
          f"({head_gap:.2e}) sits on a near-tie")
    log(f"eval reference: {len(f1s)} soft-dedup F1s, least distance to 0.9 {f1_gap:.3e}; "
        f"CheXbert heads' least top-2 gap on the reference reports {head_gap:.3e}")
    result["eval_reference"] = {f"{n} {w}_ms": ms for (n, w), (_, ms) in runs.items()}


class TimedModel:
    """An RGRG whose detect and decode_selected_cascade are timed on the
    host clock around synchronized work (what evaluate_model calls); the
    rest is the model's."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.ms = {"detect": [], "decode": []}

    def _timed(self, key, fn, *args, **kw):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.ms[key].append((time.perf_counter() - t) * 1e3)
        return out

    def detect(self, *args, **kw):
        return self._timed("detect", self.model.detect, *args, **kw)

    def decode_selected_cascade(self, *args, **kw):
        return self._timed("decode", self.model.decode_selected_cascade, *args, **kw)

    def __getattr__(self, name):
        return getattr(self.model, name)


def timed_calls(fn, sink):
    """fn, with each call's host ms appended to `sink`."""
    def call(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        sink.append((time.perf_counter() - t) * 1e3)
        return out
    return call


@contextlib.contextmanager
def images_in_memory(arrays):
    """Inside the block data/transforms.load_image (and the inference
    module's reference to it) reads a path as arrays[path], a dict of uint8
    images (the card's machine has no cv2 to write or read image files), so
    the dataset's row_to_sample, ReportGenerator's preprocessing and the
    CLIs run as they do on files."""
    from rgrg_tpu_torch import inference
    from rgrg_tpu_torch.data import transforms
    original = transforms.load_image

    def load(path):
        return arrays[path]
    transforms.load_image = inference.load_image = load
    try:
        yield
    finally:
        transforms.load_image = inference.load_image = original


def eval_rows(np, n, raw_shape, seed):
    """`n` split rows in the ETL's schema (read_split_csv's dicts) over
    seeded uint8 X-rays kept in memory ({"mem://<i>": image}): 20-29 gt
    boxes of random sizes, phrases of report words for ~60% of them, the
    reference report."""
    rng = np.random.default_rng(seed)
    from tests.torch_parity import WORDS
    words = [w.lower() for w in WORDS if w != "."]
    arrays, rows = {}, []
    h, w = raw_shape
    for i in range(n):
        arrays[f"mem://{i}"] = rng.integers(0, 256, raw_shape, dtype=np.uint8)
        labels = sorted(rng.choice(np.arange(1, 30), int(rng.integers(20, 30)),
                                   replace=False).tolist())
        xy = rng.uniform(0, [w * 0.8, h * 0.8], (len(labels), 2))
        wh = rng.uniform(40, [w * 0.4, h * 0.4], (len(labels), 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).round(1)
        phrases = [" ".join(rng.choice(words, rng.integers(3, 9))).capitalize() + "."
                   if rng.uniform() < 0.6 else "" for _ in range(29)]
        rows.append({"mimic_image_file_path": f"mem://{i}",
                     "bbox_coordinates": boxes.tolist(), "bbox_labels": labels,
                     "bbox_phrases": phrases,
                     "bbox_phrase_exists": [bool(p) for p in phrases],
                     "bbox_is_abnormal": [bool(rng.uniform() < 0.3) for _ in phrases],
                     "reference_report": " ".join(p for p in phrases if p)})
    return arrays, rows


def phase_eval_full_width(np, torch, dev, result, gen, cfg):
    """evaluate_model at full width, as the evaluate CLI runs it: the main
    path's weights (ResNet-50 bf16 detector, GPT-2 Medium), beam 4 with
    early stopping at max_length 300 through the length cascade (64, 128,
    304 with CascadeStats' bail-out), soft dedup through the default scorer
    on the card, and CE through a CheXbert at BERT-base width (768 x 12
    layers, random weights). The batches come through the port's dataset:
    split rows over EVAL_BATCHES x BATCH uint8 2048x2500 X-rays, the eval
    transform, the phrases' BPE encode and the collate, prefetched on a
    thread. The K1/K2/K3 counters must move. Random weights never emit EOS,
    so every selected row decodes to the cap: the worst case."""
    from rgrg_tpu_torch.data.dataset import RGRGDataset
    from rgrg_tpu_torch.data.prefetch import prefetched
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.eval.bertscore import default_scorer
    from rgrg_tpu_torch.eval.chexbert import BertConfig
    from rgrg_tpu_torch.eval.evaluator import evaluate_model
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.serving import CascadeStats

    t_setup = time.perf_counter()
    tok = report_tokenizer(cfg.decoder.vocab_size, cfg.decoder.eos_token_id, byte_level=True)
    arrays, rows = eval_rows(np, EVAL_BATCHES * BATCH, RAW_SHAPE, seed=17)
    bert_cfg = BertConfig()
    vocab = write_chexbert_vocab(os.path.join(ROOT, "build", "smoke_chexbert", "vocab.txt"))
    labeler = chexbert_labeler(torch, bert_cfg, vocab, dev, seed=23)
    check(labeler.logits(["No pleural effusion."])[0].shape == (1, 4), "CheXbert heads")
    timing = {"ce": [], "soft_dedup": []}
    scorer = default_scorer(device=dev)
    check(scorer is not None and scorer.device.type == dev.type, "soft-dedup scorer off the card")
    model = TimedModel(torch, gen.model)
    ds = RGRGDataset(rows, tok)
    chunks = -(-cfg.detector.rpn.pre_nms_top_n_test // cfg.detector.roi.proposal_chunk)
    setup_s = time.perf_counter() - t_setup
    with images_in_memory(arrays):
        t_data = time.perf_counter()
        first = next(ds.batches(BATCH))
        data_ms = (time.perf_counter() - t_data) * 1e3
        check(first["images"].shape == (BATCH, 512, 512, 1)
              and first["input_ids"].shape == (BATCH, 29, 64)
              and (first["input_ids"][first["region_has_sentence"]][:, 0]
                   == cfg.decoder.bos_token_id).all(), "dataset batch")
        nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
        beam_generate.steps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = evaluate_model(model, gen.params, prefetched(ds.batches(BATCH, workers=2)),
                                tok, num_beams=BEAMS, max_length=EVAL_MAX_LENGTH,
                                early_stopping=True,
                                similarity_fn=timed_calls(scorer, timing["soft_dedup"]),
                                chexbert=timed_calls(labeler, timing["ce"]))
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    counts = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches,
              "beam_attention": beam_attention.launches, "beam_steps": beam_generate.steps}
    n_batches = len(model.ms["detect"])
    check(n_batches == EVAL_BATCHES, f"full-width eval: {n_batches} batches")
    check(counts["nms"] == n_batches and counts["roi_align"] == n_batches * chunks
          and counts["beam_steps"] > 0
          and counts["beam_attention"] == cfg.decoder.num_layers * counts["beam_steps"],
          f"full-width eval: launches {counts}")
    lg = scores["language_generation"]
    rep, sent = scores.get("report", {}), scores.get("sentence", {})
    check(lg["language_images"] == n_batches * BATCH and "CE" in rep and "meteor" in rep
          and "meteor" in sent and all(np.isfinite(v) for v in
                                       (rep["bleu_4"], rep["cider"], sent["meteor"])),
          "full-width eval: scores missing or not finite")
    check(all(isinstance(v, float) and 0 <= v <= 1 for v in
              scores["object_detector"]["per_region_iou"].values()), "full-width eval: IoU")
    decode_s = sum(model.ms["decode"]) / 1e3
    loop_ms = lg["loop_seconds"] * 1e3
    ce_ms = sum(timing["ce"])
    metrics_ms = total_ms - loop_ms - ce_ms  # sentence + report NLG after the loop
    per_batch = {"detect_ms": model.ms["detect"], "decode_ms": model.ms["decode"],
                 "soft_dedup_ms": sum(timing["soft_dedup"]) / n_batches,
                 "loop_ms_per_batch": loop_ms / n_batches,
                 "host_metrics_ms_per_batch": metrics_ms / n_batches,
                 "ce_ms_per_batch": ce_ms / n_batches}
    log(f"eval full width: {n_batches} batches of {BATCH} uint8 {RAW_SHAPE} through the "
        f"dataset (first batch built in {data_ms:.0f} ms), beam {BEAMS} max_length "
        f"{EVAL_MAX_LENGTH}; detect ms per batch {['%.1f' % t for t in model.ms['detect']]}, "
        f"decode ms per batch {['%.0f' % t for t in model.ms['decode']]} "
        f"({counts['beam_steps']} beam steps), {n_batches * BATCH / decode_s:.2f} reports/s "
        f"of decode; soft dedup {per_batch['soft_dedup_ms']:.0f} ms per batch "
        f"({len(timing['soft_dedup'])} scorer calls); host metrics (sentence METEOR with the "
        f"per-image mismatch pairs, report BLEU/METEOR/ROUGE/CIDEr) "
        f"{per_batch['host_metrics_ms_per_batch']:.0f} ms per batch; CE "
        f"{per_batch['ce_ms_per_batch']:.0f} ms per batch ({len(timing['ce'])} calls); "
        f"whole evaluate_model {total_ms:.0f} ms [{result['card']}]. Random weights never "
        f"emit EOS: every selected row decodes to the cap (the worst case)")
    log(f"eval full width: cascade {lg['cascade']}; bailed out {lg['cascade']['bailed_out']}; "
        f"reports/s of decode (evaluate_model's) {lg['reports_per_sec_decode']}; launches "
        f"{counts}; scores: IoU {scores['object_detector']['avg_iou']:.4f}, sentence METEOR "
        f"{sent['meteor']:.4f}, report BLEU-4 {rep['bleu_4']:.4f} CIDEr {rep['cider']:.4f}, "
        f"CE F1 micro-5 {rep['CE']['f1_micro_5']:.4f}")
    # the device's idle share over one batch, decoded at max_length as the
    # bailed-out cascade decodes it: timed alone, then profiled
    with images_in_memory(arrays):
        batch = next(ds.batches(BATCH))

    def one_batch():
        stats = CascadeStats()
        stats.bailed_out = True
        return evaluate_model(gen.model, gen.params, [batch], tok, num_beams=BEAMS,
                              max_length=EVAL_MAX_LENGTH, similarity_fn=scorer,
                              chexbert=labeler, cascade_stats=stats)
    _, one_ms = timed(torch, one_batch, reps=1)
    t_prof = time.perf_counter()
    prof = profiled(torch, one_batch, one_ms, "eval full width, one batch", "batch")
    prof_s = time.perf_counter() - t_prof
    log(f"eval full width, where the phase's time goes: setup (X-rays, CheXbert, scorer) "
        f"{setup_s:.1f} s, evaluate_model {total_ms / 1e3:.1f} s, the timed batch "
        f"{one_ms / 1e3:.1f} s, the profiled batch {prof_s:.1f} s")
    result["eval_full_width"] = dict(per_batch=per_batch, total_ms=total_ms, one_batch_ms=one_ms,
                                     setup_s=setup_s, profiled_s=prof_s,
                                     data_first_batch_ms=data_ms, launches=counts,
                                     language_generation=lg,
                                     reports_per_s_decode=n_batches * BATCH / decode_s,
                                     profile=prof)


# ------------------------------------------------------------------ training

TRAIN_BATCH = 16        # RGRGConfig().train.batch_size
TRAIN_SEQ = 64          # tokens per region sentence
TRAIN_LM_BUDGET = 128   # train.loop.train's default LM row budget
TRAIN_ROIS = 256        # RoI chunk (cfg.roi.proposal_chunk): one K2 launch


def nms_row(np, torch, dev, result, b, n, seed=3):
    """K1 at B=b x N=n (phase 3's inputs): mask bit-identical to the plain
    version, timed beside it and its bound (the IoU tests these boxes
    need)."""
    from rgrg_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
    boxes, valid = nms_inputs(np, torch, dev, b=b, n=n, seed=seed)
    got = nms_keep_mask(boxes, valid, 0.7)
    torch.cuda.synchronize()
    check(torch.equal(got, nms_keep_mask_plain(boxes, valid, 0.7)),
          f"NMS kernel mask != plain mask at B={b} N={n}")
    ms = cuda_ms(torch, lambda: nms_keep_mask(boxes, valid, 0.7), 50)
    plain_ms = cuda_ms(torch, lambda: nms_keep_mask_plain(boxes, valid, 0.7), 2, warmup=1)
    keep = got.cpu().numpy()
    pairs = nms_pairs_needed(np, boxes.cpu().numpy(), valid.cpu().numpy(), keep, 0.7)
    nbytes, flops = b * n * 18, 16 * pairs
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations", pairs=pairs,
               kept=int(keep.sum()), max_abs_err=0.0)
    log(f"K1 nms training shape: B={b} N={n} kept={row['kept']} mask identical, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}: {pairs} IoU tests) [{result['card']}]")
    return row


def phase_train_kernels(np, torch, dev, result):
    """(a) K1 at the training proposal count (B=16 x N=2000) and the
    validation count (N=1000), masks bit-identical to the plain version;
    (b) K2 at the training shape (B=16, 256 RoIs, C=2048) forward within
    1e-4 of plain, and its feature gradient (the autograd.Function's
    backward, one batched matmul) against autograd through the plain
    version: f32 within 1e-4 relative, bf16 within one bf16 ulp (8e-3
    relative), bit-identical on a relaunch. Times the forward, the backward
    product and `torch.bmm` alone on the same W2 and gradient (the library
    call the backward is)."""
    from rgrg_tpu_torch.ops.roi_align import (roi_align, roi_align_feature_grad,
                                              roi_align_plain, roi_align_weights)
    result["nms_train"] = {f"N={n}": nms_row(np, torch, dev, result, TRAIN_BATCH, n)
                           for n in (2000, 1000)}

    k2 = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        feats, boxes = roi_inputs(np, torch, dev, dtype, b=TRAIN_BATCH, n=TRAIN_ROIS, seed=4)
        out = roi_align(feats, boxes)
        want = roi_align_plain(feats, boxes)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        check(err <= 1e-4, f"K2 training shape {name}: forward max abs err {err}")
        del out, want
        g = torch.randn((TRAIN_BATCH, TRAIN_ROIS, 8, 8, feats.shape[-1]), generator=gen,
                        device=dev)
        f = feats.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(roi_align(f, boxes), f, g)
        (again,) = torch.autograd.grad(roi_align(f, boxes), f, g)
        fp = feats.clone().requires_grad_(True)
        (plain,) = torch.autograd.grad(roi_align_plain(fp, boxes), fp, g)
        torch.cuda.synchronize()
        rel = ((grad.float() - plain.float()).abs().max() / plain.float().abs().max()).item()
        tol = 1e-4 if dtype == torch.float32 else 8e-3
        check(grad.dtype == dtype and rel <= tol,
              f"K2 feature gradient {name}: rel err {rel} > {tol}")
        check(torch.equal(grad, again), f"K2 feature gradient {name} not bit-identical")
        del grad, again, plain, fp
        fwd_ms = cuda_ms(torch, lambda: roi_align(feats, boxes), 20)
        bwd_ms = cuda_ms(torch, lambda: roi_align_feature_grad(g, boxes, 16, 16), 10)
        ay, ax = roi_align_weights(boxes, 16, 16, 8, 1.0 / 32.0, 2)
        w2t = (ay[:, :, :, None, :, None] * ax[:, :, None, :, None, :]).reshape(
            TRAIN_BATCH, TRAIN_ROIS * 64, 256).transpose(1, 2)
        g2 = g.reshape(TRAIN_BATCH, TRAIN_ROIS * 64, -1)
        bmm_ms = cuda_ms(torch, lambda: torch.bmm(w2t, g2), 10)
        plain_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            roi_align_plain(f, boxes), f, g), 2, warmup=1)
        c = feats.shape[-1]
        taps = roi_taps_needed(torch, boxes)
        # the backward reads G once, writes dF once; the sparse taps need
        # 2 FLOP per tap and channel (the dense product does 2*N*64*256*C)
        nbytes = g.numel() * 4 + boxes.numel() * 4 + feats.numel() * feats.element_size()
        flops = 2 * c * taps
        dense = 2 * TRAIN_BATCH * TRAIN_ROIS * 64 * 256 * c
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        k2[name] = dict(ms=fwd_ms, max_abs_err=err, grad_rel_err=rel, backward_ms=bwd_ms,
                        bmm_ms=bmm_ms, plain_backward_ms=plain_bwd_ms,
                        backward_bound_ms=max(t_b, t_o) * 1e3,
                        backward_bound_by="bytes" if t_b >= t_o else "operations",
                        backward_dense_flop=dense,
                        backward_dense_ms_at_peak=dense / F32_FLOP_PER_S * 1e3)
        log(f"K2 roi_align training shape {name}: feats {tuple(feats.shape)} boxes "
            f"{tuple(boxes.shape)} fwd err {err:.2e}, feature grad rel err {rel:.2e} "
            f"(relaunch bit-identical); forward {fwd_ms:.4f} ms; backward product "
            f"{bwd_ms:.3f} ms (torch.bmm alone {bmm_ms:.3f} ms; {dense / 1e9:.0f} GFLOP "
            f"dense = {k2[name]['backward_dense_ms_at_peak']:.2f} ms at the f32 peak, no "
            f"TF32); plain backward {plain_bwd_ms:.2f} ms; backward bound "
            f"{k2[name]['backward_bound_ms']:.4f} ms ({k2[name]['backward_bound_by']}) "
            f"[{result['card']}]")
        del feats, boxes, g, f, w2t, g2
        torch.cuda.empty_cache()
    result["roi_align_train"] = k2


def train_small_config():
    """Shallow backbone, 64 training / 32 test proposals, 32 sampled RoIs,
    a 2-layer 64-wide decoder, dropout off."""
    from rgrg_tpu_torch.core import config as TC
    return TC.ModelConfig(
        detector=TC.DetectorConfig(backbone_stages=(1, 1, 1, 1),
                                   rpn=TC.RPNConfig(pre_nms_top_n_train=64,
                                                    post_nms_top_n_train=64,
                                                    pre_nms_top_n_test=32),
                                   roi=TC.RoIConfig(batch_size_per_image=32)),
        decoder=TC.DecoderConfig(vocab_size=512, hidden_dim=64, num_heads=4, num_layers=2,
                                 max_positions=64, bos_token_id=0, eos_token_id=0,
                                 pad_token_id=0, embd_dropout=0.0, attn_dropout=0.0,
                                 resid_dropout=0.0))


def train_batch(np, seed, b, seq, vocab, size=512):
    """A synthetic stage-3 batch in the task's geometry (as
    scripts/bench_train_fullscale.py builds it): 29 region boxes on a grid
    drawn brighter into the image, ~half the regions with a sentence of
    8..seq-1 tokens over the whole vocabulary, ~20% abnormal."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 0.15, (b, size, size, 1)).astype(np.float32)
    boxes = np.zeros((b, 29, 4), np.float32)
    has_sentence = rng.uniform(size=(b, 29)) < 0.5
    is_abnormal = rng.uniform(size=(b, 29)) < 0.2
    input_ids = np.zeros((b, 29, seq), np.int32)
    attention_mask = np.zeros((b, 29, seq), np.float32)
    for i in range(b):
        for r in range(29):
            gy, gx = divmod(r, 6)
            cx = 45 + gx * 80 + rng.uniform(-12, 12)
            cy = 55 + gy * 95 + rng.uniform(-12, 12)
            w, h = rng.uniform(40, 90), rng.uniform(40, 90)
            x0 = float(np.clip(cx - w / 2, 0, size - 2))
            y0 = float(np.clip(cy - h / 2, 0, size - 2))
            x1 = float(np.clip(cx + w / 2, x0 + 4, size - 1))
            y1 = float(np.clip(cy + h / 2, y0 + 4, size - 1))
            boxes[i, r] = (x0, y0, x1, y1)
            level = 0.6 + 0.4 * (r / 28.0) + (0.35 if is_abnormal[i, r] else 0.0)
            images[i, int(y0):int(y1), int(x0):int(x1), 0] += level
            if has_sentence[i, r]:
                n = int(rng.integers(8, seq))
                input_ids[i, r, :n] = rng.integers(0, vocab, n)
                attention_mask[i, r, :n] = 1.0
    return {"images": images, "gt_boxes": boxes,
            "gt_labels": np.tile(np.arange(1, 30, dtype=np.int32), (b, 1)),
            "gt_valid": np.ones((b, 29), bool), "region_has_sentence": has_sentence,
            "region_is_abnormal": is_abnormal, "input_ids": input_ids,
            "attention_mask": attention_mask}


def sampling_draws(np, seed, b, n_anchors, n_pool):
    """Uniform keys for one training forward, in the port's call order (RPN
    positives and negatives [B, N], RoI positives and negatives [B, K+G]),
    fed to the card and the CPU alike."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(b, n)).astype(np.float32)
            for n in (n_anchors, n_anchors, n_pool, n_pool)]


def _rel_l2(torch, a, b):
    nb = b.float().norm().item()
    d = (a.float().cpu() - b.float().cpu()).norm().item()
    return d / nb if nb > 0 else d


def phase_train_reference(np, torch, dev, result):
    """(c) One stage-3 training step of the small model on the card and on
    the CPU from the same weights, batch and sampling keys (f32, dropout
    off): grad_accumulation_steps 1, then a 4-mini-step update. Losses
    within 1e-4 relative, every trainable gradient outside the backbone
    within 1e-3 relative L2 and the backbone's within 1e-2 (f32's own error
    there: `backbone_gradient_vs_f64` holds both devices within 1e-2 of an
    f64 reference),
    parameters after each update within 2 x lr (a gradient of noise size
    can flip the sign of Adam's first step; the card restarts from the
    CPU's state before the accumulated update), BatchNorm running
    statistics within 1e-5, the frozen GPT-2 base bit-unchanged, and the
    K1 and K2 counters advanced on the card. The batch is the first seeded
    one whose training decisions clear tests/torch_parity.TRAINING_MARGINS."""
    import copy
    from rgrg_tpu_torch.core import config as TC
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.train import trainer
    from tests.torch_parity import TRAINING_MARGINS, training_margins

    cfg = train_small_config()
    model = RGRG(cfg)
    cpu = torch.device("cpu")
    p_cpu = RGRG(cfg).init(seed=5, device=cpu)
    p_gpu = {"detector": copy.deepcopy(p_cpu["detector"]).to(dev),
             "decoder": _tree_map(p_cpu["decoder"], lambda t: t.to(dev, copy=True))}
    n_anchors = cfg.detector.anchors.num_anchors_per_location * 256
    n_pool = cfg.detector.rpn.pre_nms_top_n(True) + 29
    for seed in range(40):
        batch = train_batch(np, seed, 2, 16, cfg.decoder.vocab_size)
        draws = sampling_draws(np, seed, 2, n_anchors, n_pool)
        t = trainer.batch_to_device(batch, cpu)
        m = training_margins(p_cpu["detector"], t["images"], t["gt_boxes"], t["gt_labels"],
                             t["gt_valid"], draws[2:])
        if all(m[k] >= v for k, v in TRAINING_MARGINS.items()):
            break
    else:
        raise RuntimeError("check failed: no seeded training batch with decision margins")
    tc1 = TC.TrainConfig(grad_accumulation_steps=1)
    lr = tc1.learning_rate
    frozen0 = p_cpu["decoder"]["h_0"]["attn"]["c_attn"]["kernel"].clone()
    states, grads, losses = {}, {}, {}
    nms_keep_mask.launches = roi_align.launches = 0
    for name, params in (("cpu", p_cpu), ("gpu", p_gpu)):
        opt = trainer.make_optimizer(params, tc1, stage=3)
        d = cpu if name == "cpu" else dev
        total, ls = trainer.compute_losses(model, params, trainer.batch_to_device(batch, d),
                                           iter(draws), 3, tc1, 16)
        total.backward()
        grads[name] = [t.grad.detach().clone().cpu() for t in opt.tensors]
        losses[name] = {k: float(v.detach()) for k, v in ls.items()}
        opt.step()
        states[name] = (params, opt)
    launches = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches}
    check(launches["nms"] >= 1 and launches["roi_align"] >= 1,
          f"the card's training step did not launch K1 and K2: {launches}")
    loss_err = max(abs(losses["gpu"][k] - losses["cpu"][k]) / max(abs(losses["cpu"][k]), 1e-6)
                   for k in losses["cpu"])
    check(loss_err <= 1e-4, f"training losses card vs CPU rel err {loss_err}")
    names = [n for n, _ in p_cpu["detector"].named_parameters()]
    names += [f"decoder trainable {i}" for i in range(len(grads["cpu"]) - len(names))]
    errs = sorted(((_rel_l2(torch, g, c), n) for g, c, n in
                   zip(grads["gpu"], grads["cpu"], names)), reverse=True)
    grad_err = errs[0][0]
    log(f"training reference: worst gradients card vs CPU (rel L2) "
        f"{[(n, float('%.2e' % e)) for e, n in errs[:6]]}; losses "
        f"{ {k: (losses['cpu'][k], losses['gpu'][k]) for k in losses['cpu']} }")
    head_err = max(e for e, n in errs if not n.startswith("backbone."))
    check(head_err <= 1e-3, f"training gradients card vs CPU rel L2 {head_err} outside "
          f"the backbone")
    check(grad_err <= 1e-2, f"training gradients card vs CPU rel L2 {grad_err}")
    f64_errs = backbone_gradient_vs_f64(np, torch, dev, p_cpu["detector"].backbone)
    check(f64_errs["card"] <= 1e-2 and f64_errs["cpu"] <= 1e-2,
          f"backbone f32 gradients vs f64: {f64_errs}")

    def compare(what, updates):
        dc, dg = p_cpu["detector"], p_gpu["detector"]
        perr = max((a.detach().cpu() - b.detach()).abs().max().item()
                   for a, b in zip(states["gpu"][1].tensors, states["cpu"][1].tensors))
        # a flipped sign moves a weight by 2 x lr, plus the f32 rounding of
        # weights of magnitude up to ~8
        check(perr <= 2 * lr * updates + 1e-6,
              f"{what}: params card vs CPU differ by {perr} > 2 x lr x {updates} updates")
        serr = max((a.cpu() - b).abs().max().item() / max(1.0, b.abs().max().item())
                   for (n, a), (_, b) in zip(dg.named_buffers(), dc.named_buffers())
                   if "running" in n)
        check(serr <= 1e-5, f"{what}: BN running statistics card vs CPU differ by {serr}")
        for p in (p_cpu, p_gpu):
            check(torch.equal(p["decoder"]["h_0"]["attn"]["c_attn"]["kernel"].cpu(), frozen0),
                  f"{what}: the frozen GPT-2 base moved")
        return perr, serr

    perr1, serr1 = compare("one step", 1)
    # one update of 4 mini-steps (the same batch and keys each time), both
    # devices starting from the CPU's state, so the batch statistics come
    # from the same weights
    with torch.no_grad():
        p_gpu["detector"].load_state_dict(p_cpu["detector"].state_dict())
        for a, c in zip(trainer.leaves(p_gpu["decoder"]), trainer.leaves(p_cpu["decoder"])):
            a.copy_(c)
    tc4 = TC.TrainConfig(grad_accumulation_steps=4)
    for name, params in (("cpu", p_cpu), ("gpu", p_gpu)):
        state = trainer.TrainState(params, trainer.make_optimizer(params, tc4, stage=3), 0)
        states[name] = (params, state.opt_state)
        step = trainer.make_train_step(model, tc4, stage=3, lm_budget=16)
        for i in range(4):
            state, _ = step(state, batch, iter(draws))
            check(state.opt_state.mini_step == (i + 1) % 4, "accumulation count")
    perr4, serr4 = compare("4-mini-step update", 1)
    # the RoI-head losses alone reach the backbone through K2's backward
    det = p_gpu["detector"]
    for p in det.parameters():
        p.grad = None
    ls, _ = det.train_forward(*(trainer.batch_to_device(batch, dev)[k] for k in
                                ("images", "gt_boxes", "gt_labels", "gt_valid")), iter(draws))
    (ls["loss_classifier"] + ls["loss_box_reg"]).backward()
    check(det.backbone.conv1.weight.grad is not None
          and det.backbone.conv1.weight.grad.abs().sum().item() > 0,
          "the RoI-head loss gave the backbone no gradient on the card")
    log(f"training reference (small model, batch seed {seed}, margins "
        f"{ {k: float('%.1e' % v) for k, v in m.items()} }): card == CPU, losses rel err "
        f"{loss_err:.1e}, gradients rel L2 {head_err:.1e} outside the backbone, {grad_err:.1e} "
        f"in all {len(grads['cpu'])} tensors (backbone f32 vs f64: card {f64_errs['card']:.1e}, "
        f"CPU {f64_errs['cpu']:.1e}), "
        f"params after one step {perr1:.1e} / after the 4-mini-step update {perr4:.1e} "
        f"(2 x lr = {2 * lr:.0e} per update), BN statistics {max(serr1, serr4):.1e}, frozen base "
        f"unchanged; card launches {launches} [{result['card']}]")
    result["train_reference"] = dict(seed=seed, losses=losses, loss_rel_err=loss_err,
                                     grad_rel_l2=grad_err, grad_rel_l2_heads=head_err,
                                     worst_grads=errs[:8], backbone_vs_f64=f64_errs, param_err=[perr1, perr4],
                                     bn_err=[serr1, serr4], launches=launches)


def backbone_gradient_vs_f64(np, torch, dev, backbone):
    """The train-mode backbone's parameter gradients of a fixed loss
    (sum(w * max(C5, 0.1)) over a seeded 2 x 512 x 512 batch) in f32 on the
    card and on the CPU against the CPU in f64: the worst relative L2 of
    each. On a random network the early BatchNorm gradients sum ~131k
    nearly cancelling terms, so f32 carries ~1e-3 of error on any device;
    this measures how far each device is from the exact gradient."""
    import copy
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 512, 512, 1)))
    w = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, 2048)))

    def grads(device, dtype):
        m = copy.deepcopy(backbone).to(device, dtype)
        m.dtype = dtype
        m.train()
        y = m(x.to(device, dtype))
        (torch.clamp(y, min=0.1) * w.to(device, dtype)).sum().backward()
        return {n: p.grad.double().cpu() for n, p in m.named_parameters()}
    ref = grads(torch.device("cpu"), torch.float64)
    out = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        g = grads(device, torch.float32)
        out[name] = max(float((g[n] - ref[n]).norm() / ref[n].norm()) for n in ref)
    return out


def train_flops(cfg, b, lm_rows, seq):
    """FLOP of one full-width training mini-step, counted from the shapes:
    the backbone's convs forward (hooks on a meta-device copy) x3 for the
    backward (input and weight gradients); the RPN head's convs x3; fc6 and
    the rest of the box head x3; K2's backward product (dense, as run); the
    decoder over lm_rows x seq tokens forward plus its activation gradient
    (its weights are frozen but uk / uv), x2; the LM head x2."""
    import torch
    from rgrg_tpu_torch.core import constants as C
    from rgrg_tpu_torch.models.layers import Conv2d
    from rgrg_tpu_torch.models.resnet import ResNetBackbone
    det = cfg.detector
    with torch.device("meta"):
        bb = ResNetBackbone(det.backbone_stages)
    conv = [0]

    def hook(m, inp, out):
        conv[0] += 2 * out.numel() * m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
    for m in bb.modules():
        if isinstance(m, Conv2d):
            m.register_forward_hook(hook)
    bb(torch.empty((b, det.image_size, det.image_size, 1), device="meta"))
    hw = 16 * 16
    a = det.anchors.num_anchors_per_location
    ch = C.BACKBONE_CHANNELS
    rpn = 2 * b * hw * ch * (ch * 9 + a * 5)
    s = det.roi.batch_size_per_image
    rep = det.roi.representation_size
    fc6 = 2 * b * s * 64 * ch * rep
    head = 2 * b * s * rep * (rep + det.num_classes * 5) + 2 * b * 29 * ch * C.REGION_FEATURE_DIM
    k2_bwd = 2 * b * s * 64 * hw * ch
    dec = cfg.decoder
    d = dec.hidden_dim
    tokens = lm_rows * seq
    per_token = dec.num_layers * 2 * (d * 3 * d + d * d + 2 * d * 4 * d + 2 * seq * d)
    lm_head = 2 * tokens * d * dec.vocab_size
    parts = {"backbone": 3 * conv[0], "rpn_head": 3 * rpn, "fc6": 3 * fc6,
             "box_head_rest": 3 * head, "k2_backward": k2_bwd,
             "decoder": 2 * tokens * per_token, "lm_head": 2 * lm_head}
    parts["total"] = sum(parts.values())
    return parts


def phase_train_full_width(np, torch, dev, result):
    """(d) The training path at the reference's full width through
    train.loop.train: RGRGConfig() defaults (ResNet-50 at 512x512, 2000
    training proposals, 512 sampled RoIs; GPT-2 Medium; batch 16,
    accumulation 4, LM budget 128, sequences of 64; f32 detector and
    decoder, TF32 off), seeded random weights, synthetic stage-3 batches.
    8 mini-steps (2 updates) with a checkpoint every 4, then resumed from
    `last` for 4 more; 4 mini-steps of stage 1; 4 mini-steps of the bf16
    recipe (bf16 detector, mixed_precision, remat_decoder, LM budget 256)
    through make_train_step. Returns the K1 / K2 launches of these runs."""
    import shutil
    from rgrg_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from rgrg_tpu_torch.core.config import DetectorConfig, ModelConfig, RGRGConfig
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.train import loop, losses as L, trainer

    cfg = RGRGConfig()
    tcfg, mcfg = cfg.train, cfg.model
    dec = mcfg.decoder
    check((mcfg.detector.backbone_stages, mcfg.detector.rpn.pre_nms_top_n_train,
           mcfg.detector.roi.batch_size_per_image, dec.num_layers, dec.hidden_dim,
           dec.num_heads, dec.vocab_size, tcfg.batch_size, tcfg.grad_accumulation_steps)
          == ((3, 4, 6, 3), 2000, 512, 24, 1024, 16, 50257, 16, 4),
          "the training config is not the reference's full width")
    b = tcfg.batch_size
    roi = mcfg.detector.roi
    chunks = -(-roi.batch_size_per_image // roi.proposal_chunk)
    run_dir = os.path.join(ROOT, "build", "smoke_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    batches = [train_batch(np, 100 + i, b, TRAIN_SEQ, dec.vocab_size) for i in range(12)]
    out, counted = {}, {"nms": 0, "roi_align": 0}

    # per mini-step: losses (from the step function) and the LM's target tokens
    step_losses, lm_tokens = [], []
    make_step, lm_loss = trainer.make_train_step, L.lm_loss_selected

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng):
            state, losses = step(state, batch, rng)
            step_losses.append(losses)
            return state, losses
        return run

    def counting_lm_loss(params, input_ids, attention_mask, feats, seq_valid, c, budget,
                         **kw):
        flat = seq_valid.reshape(-1)
        idx = torch.sort((~flat).to(torch.int32), stable=True).indices[:budget]
        mask = attention_mask.reshape(flat.shape[0], -1)[idx] * flat[idx, None]
        lm_tokens.append(mask[:, 1:].sum())
        return lm_loss(params, input_ids, attention_mask, feats, seq_valid, c, budget, **kw)

    def drive(name, fn, ms_per_update_k):
        """Run fn() with the counters at 0 and a synchronized clock at
        every batch handed out; returns per-mini-step ms."""
        marks = []

        def feed(items):
            def gen():
                for item in items:
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                    yield item
            return gen
        step_losses.clear()
        lm_tokens.clear()
        nms_keep_mask.launches = roi_align.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ret = fn(feed)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        marks.append(time.perf_counter())
        steps = len(step_losses)
        launches = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches}
        check(launches == {"nms": steps, "roi_align": chunks * steps},
              f"{name}: launches {launches} != 1 NMS and {chunks} RoIAlign per mini-step "
              f"x {steps}")
        for k in counted:
            counted[k] += launches[k]
        ms = [(marks[i + 1] - marks[i]) * 1e3 for i in range(len(marks) - 1)][:steps]
        finite = all(bool(torch.isfinite(v).all()) for ls in step_losses for v in ls.values())
        check(finite, f"{name}: a loss is not finite")
        steady = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
        tokens = [int(t) for t in lm_tokens]
        row = dict(ms_per_mini_step=ms, steady_ms=steady, steps=steps, total_s=total_s,
                   ms_per_update=steady * ms_per_update_k,
                   images_per_s=b / steady * 1e3,
                   lm_tokens_per_step=tokens,
                   lm_tokens_per_s=(sum(tokens) / len(tokens) / steady * 1e3) if tokens else 0,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
                   losses={k: float(v) for k, v in step_losses[-1].items()})
        log(f"train {name}: {steps} mini-steps, ms each {['%.0f' % t for t in ms]}, median "
            f"after the first {steady:.1f} ms = {row['images_per_s']:.1f} images/s, "
            f"{row['ms_per_update']:.0f} ms per update, LM target tokens/s "
            f"{row['lm_tokens_per_s']:.0f} ({tokens[:4]} a mini-step), peak "
            f"{row['peak_gb']:.1f} GB, launches {launches}, last losses "
            f"{ {k: round(v, 4) for k, v in row['losses'].items()} } [{result['card']}]")
        out[name] = row
        return ret

    trainer.make_train_step, L.lm_loss_selected = recording_step, counting_lm_loss
    try:
        model = RGRG(mcfg)
        state = drive("stage 3 f32 (loop, 8 mini-steps)", lambda feed: loop.train(
            model, cfg, feed(batches[:8]), run_dir, stage=3, lm_budget=TRAIN_LM_BUDGET,
            checkpoint_every=4, max_steps=8, device=dev), tcfg.grad_accumulation_steps)
        check(state.step == 8 and state.opt_state.mini_step == 0, "8 mini-steps, 2 updates")
        for name in ("step_4", "step_8", "last"):
            check(os.path.isfile(os.path.join(run_dir, name, "train_state.pt")),
                  f"no {name} checkpoint")
        check(os.path.getsize(os.path.join(run_dir, "metrics.jsonl")) > 0, "no metrics.jsonl")
        for name in ("step_4", "step_8"):   # the disk holds a few 4 GB states at most
            shutil.rmtree(os.path.join(run_dir, name))
        ref = RGRG(mcfg).init(tcfg.seed, device=dev)
        moved = lambda a, b: not torch.equal(a, b)  # noqa: E731
        dflat = trainer.leaves(state.params["decoder"])
        rflat = trainer.leaves(ref["decoder"])
        tmask = trainer.leaves(trainer.decoder_trainable_mask(state.params["decoder"]))
        check(all(moved(a, r) == m for a, r, m in zip(dflat, rflat, tmask)),
              "stage 3 must move uk / uv / feature_transform and leave the GPT-2 base "
              "bit-unchanged")
        det_moved = [moved(a, r) for a, r in zip(state.params["detector"].parameters(),
                                                 ref["detector"].parameters())]
        check(all(det_moved), f"{det_moved.count(False)} detector tensors did not move")
        stats = dict(state.params["detector"].named_buffers())
        rstats = dict(ref["detector"].named_buffers())
        check(all(moved(stats[k], rstats[k]) for k in stats if "running" in k),
              "BatchNorm running statistics did not move")
        del ref
        t = time.perf_counter()
        save_checkpoint(os.path.join(run_dir, "probe"), state)
        out["checkpoint_save_s"] = time.perf_counter() - t
        out["checkpoint_gb"] = os.path.getsize(
            os.path.join(run_dir, "probe", "train_state.pt")) / 1e9
        fresh = trainer.init_train_state(model, 0, tcfg, stage=3, device=dev)
        t = time.perf_counter()
        load_checkpoint(os.path.join(run_dir, "last"), fresh)
        out["checkpoint_load_s"] = time.perf_counter() - t
        same = (fresh.step == 8
                and all(torch.equal(a, c) for a, c in zip(
                    state.params["detector"].state_dict().values(),
                    fresh.params["detector"].state_dict().values()))
                and all(torch.equal(a, c) for a, c in zip(dflat, trainer.leaves(
                    fresh.params["decoder"]))))
        check(same, "the checkpoint does not restore the trained state bit for bit")
        # one mini-step profiled (device busy and idle share); then drop the
        # states before the resumed run builds its own
        step_fn = make_step(model, tcfg, stage=3, lm_budget=TRAIN_LM_BUDGET)
        gen = torch.Generator(device=dev).manual_seed(0)
        out["profile"] = profiled(torch, lambda: step_fn(state, batches[8], gen),
                                  out["stage 3 f32 (loop, 8 mini-steps)"]["steady_ms"],
                                  "train profile f32 mini-step", "mini-step")
        del state, fresh, dflat, step_fn
        shutil.rmtree(os.path.join(run_dir, "probe"))
        torch.cuda.empty_cache()

        resumed = drive("stage 3 f32 resumed (loop, 4 mini-steps)", lambda feed: loop.train(
            model, cfg, feed(batches[8:12]), run_dir, stage=3, lm_budget=TRAIN_LM_BUDGET,
            resume_from=os.path.join(run_dir, "last"), max_steps=12, device=dev),
            tcfg.grad_accumulation_steps)
        check(resumed.step == 12 and len(step_losses) == 4,
              "the resumed run did not start at step 8")
        del resumed
        shutil.rmtree(run_dir)
        torch.cuda.empty_cache()

        s1 = drive("stage 1 (loop, 4 mini-steps, lr 1e-3)", lambda feed: loop.train(
            model, cfg, feed(batches[:4]), run_dir, stage=1, max_steps=4, device=dev),
            tcfg.grad_accumulation_steps)
        check(set(step_losses[-1]) == {"loss_objectness", "loss_rpn_box_reg",
                                       "loss_classifier", "loss_box_reg", "loss_total"}
              and s1.opt_state.base_lr == tcfg.detector_learning_rate, "stage 1 losses / lr")
        del s1
        shutil.rmtree(run_dir)
        torch.cuda.empty_cache()

        cfg16 = ModelConfig(detector=DetectorConfig(dtype="bfloat16"))
        model16 = RGRG(cfg16)
        st16 = trainer.init_train_state(model16, tcfg.seed, tcfg, stage=3, device=dev)
        step16 = recording_step(model16, tcfg, stage=3, lm_budget=2 * TRAIN_LM_BUDGET,
                                mixed_precision=True, remat_decoder=True)
        gen16 = torch.Generator(device=dev).manual_seed(tcfg.seed + 1)

        def bf16_run(feed):
            for batch in feed(batches[:4])():
                step16(st16, batch, gen16)
        drive("stage 3 bf16 recipe (make_train_step, 4 mini-steps, budget 256, remat)",
              bf16_run, tcfg.grad_accumulation_steps)
        check(st16.step == 4 and st16.opt_state.mini_step == 0, "bf16 recipe update")
        out["profile_bf16"] = profiled(
            torch, lambda: step16(st16, batches[4], gen16),
            out["stage 3 bf16 recipe (make_train_step, 4 mini-steps, budget 256, remat)"]
            ["steady_ms"], "train profile bf16 mini-step", "mini-step")
        del st16
        torch.cuda.empty_cache()
    finally:
        trainer.make_train_step, L.lm_loss_selected = make_step, lm_loss
    flops = train_flops(mcfg, b, TRAIN_LM_BUDGET, TRAIN_SEQ)
    f32 = out["stage 3 f32 (loop, 8 mini-steps)"]
    out["flops"] = flops
    out["share_of_f32_peak"] = flops["total"] / (f32["steady_ms"] / 1e3) / F32_FLOP_PER_S
    log(f"train FLOP per mini-step (from the shapes): "
        + ", ".join(f"{k} {v / 1e12:.2f} T" for k, v in flops.items())
        + f"; f32 recipe at {f32['steady_ms']:.0f} ms = "
        f"{flops['total'] / (f32['steady_ms'] / 1e3) / 1e12:.1f} TFLOP/s, "
        f"{out['share_of_f32_peak']:.1%} of the 67 TFLOP/s f32 peak (TF32 off); "
        f"checkpoint {out['checkpoint_gb']:.2f} GB, save {out['checkpoint_save_s']:.1f} s, "
        f"load {out['checkpoint_load_s']:.1f} s [{result['card']}]")
    result["train"] = out
    return counted


# ------------------------------------------------------------------ slice 10

K3_T0_SLOTS = (2, 31)       # the no_image beam attends from slot 1 (t0 = 1)
K3_T0_LONG_SLOTS = (303,)
NO_IMAGE_ITEMS = 32         # vanilla GPT-2 beam 4: 128 lanes
SAMPLE_TEMPERATURE, SAMPLE_TOP_P = 0.7, 0.9
CLI_STEPS = 8               # 2 updates at accumulation 4
CLI_IMAGES = 32             # distinct in-memory X-rays the split rows cycle over
CLI_WORKERS = 4
CHEXBERT_BATCH, CHEXBERT_TOKENS = 16, 128


def phase_no_image(np, torch, dev, result, gen, cfg):
    """(b) vanilla GPT-2 beam 4 (no image features; every layer's K3 launch
    at t0 = 1): a small decoder card vs CPU, token for token, on weights
    whose beam decisions clear both devices' f32 disagreement; then GPT-2
    Medium at full width (the main path's bf16 weights), 32 rows, max_length
    60, with K3's launch counter at 24 per beam step. Returns K3's
    launches."""
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.models import gpt2
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from tests.torch_parity import beam_score_margin
    dcfg = small_config().decoder
    for seed in range(16):
        p_cpu = _tree_map(gpt2.init_decoder_params(torch.Generator().manual_seed(seed), dcfg),
                          lambda t: t * 8.0)
        margin = beam_score_margin(p_cpu, None, dcfg, 16, BEAMS, False, batch=1)
        if margin >= 1e-4:
            break
    check(margin >= 1e-4, "no small decoder with beam decision margins")
    p_gpu = _tree_map(p_cpu, lambda t: t.to(dev))
    kw = dict(max_length=16, num_beams=BEAMS, no_image=True, batch=3)
    want = beam_generate(p_cpu, None, dcfg, **kw)
    launches0 = beam_attention.launches
    got = beam_generate(p_gpu, None, dcfg, **kw)
    check(beam_attention.launches > launches0, "the small no_image beam skipped K3")
    check(torch.equal(got.cpu(), want), "no_image beam: card and CPU ids differ")
    check(len({tuple(r) for r in want.tolist()}) == 1, "no_image rows differ")

    dec = gen.params["decoder"]
    beam_attention.launches, beam_generate.steps = 0, 0
    ids, ms = timed(torch, lambda: beam_generate(
        dec, None, cfg.decoder, max_length=MAX_LENGTH, num_beams=BEAMS, no_image=True,
        batch=NO_IMAGE_ITEMS), reps=2)
    launches, steps = beam_attention.launches, beam_generate.steps
    check(tuple(ids.shape) == (NO_IMAGE_ITEMS, MAX_LENGTH)
          and int(ids.min()) >= 0 and int(ids.max()) < cfg.decoder.vocab_size,
          "no_image full width: ids")
    check(steps > 0 and launches == cfg.decoder.num_layers * steps,
          f"no_image full width: K3 launches {launches} != 24 x {steps} beam steps")
    log(f"no_image beam {BEAMS} (vanilla GPT-2): small decoder card == CPU (margin "
        f"{margin:.2e}, seed {seed}); GPT-2 Medium bf16, {NO_IMAGE_ITEMS} rows, max_length "
        f"{MAX_LENGTH}: {ms:.1f} ms (2 runs, {steps} beam steps, "
        f"{ms / (steps / 2):.2f} ms a step), K3 launches {launches} [{result['card']}]")
    result["no_image"] = dict(ms=ms, beam_steps=steps, k3_launches=launches,
                              small_margin=margin, small_seed=seed)
    return launches


def phase_sampling(np, torch, dev, result, gen, cfg):
    """(c) sampling at full width on one request of 8 X-rays:
    decode_selected(do_sample=True, top_k=1) equals greedy on the same
    region features (GPT-2 Medium in f32, whose greedy path has no exact
    top-2 tie: checked); then temperature 0.7, top_p 0.9 on the serving
    weights (bf16), detect + decode timed beside greedy's."""
    from tests.torch_parity import greedy_logit_margin
    from rgrg_tpu_torch.decode.sample import sample_generate
    model = gen.model
    images = list(np.random.default_rng(31).integers(0, 256, (BATCH, *RAW_SHAPE),
                                                     dtype=np.uint8))
    x = gen.preprocess(images)
    det = model.detect(gen.params, x)
    sel = det["selected_regions"]
    n = int(sel.sum())
    check(n > 0, "sampling: no region selected")
    budget = model.budget_for(n, BATCH)
    dec32 = _tree_map(gen.params["decoder"], lambda t: t.float())
    p32 = {"detector": gen.params["detector"], "decoder": dec32}
    feats32 = det["region_features"].float()
    margin = greedy_logit_margin(dec32, feats32[sel], cfg.decoder, MAX_LENGTH)
    check(margin > 0, f"sampling: an exact greedy tie (margin {margin})")
    g = torch.Generator(device=dev).manual_seed(1)
    sampled, _ = model.decode_selected(p32, feats32, sel, budget, MAX_LENGTH, do_sample=True,
                                       top_k=1, sample_generator=g)
    greedy, _ = model.decode_selected(p32, feats32, sel, budget, MAX_LENGTH)
    check(torch.equal(sampled, greedy), "sampling with top_k=1 differs from greedy")
    del dec32, p32, feats32
    torch.cuda.empty_cache()

    def request(**kw):
        d = model.detect(gen.params, x)
        return model.decode_selected(gen.params, d["region_features"], d["selected_regions"],
                                     budget, MAX_LENGTH, **kw)[0]
    steps0 = sample_generate.steps
    out, sample_ms = timed(torch, lambda: request(
        do_sample=True, temperature=SAMPLE_TEMPERATURE, top_p=SAMPLE_TOP_P,
        sample_generator=torch.Generator(device=dev).manual_seed(2)))
    steps = (sample_generate.steps - steps0) // 3
    _, greedy_ms = timed(torch, request)
    valid = out[sel]
    check(bool((valid[:, 0] == cfg.decoder.bos_token_id).all())
          and int(valid.min()) >= 0 and int(valid.max()) < cfg.decoder.vocab_size,
          "sampled ids out of range")
    log(f"sampling: {n} regions of {BATCH} X-rays, top_k=1 == greedy (f32 GPT-2 Medium, "
        f"greedy margin {margin:.2e}); temperature {SAMPLE_TEMPERATURE} top_p {SAMPLE_TOP_P} "
        f"(bf16): detect + decode {sample_ms:.1f} ms a request = "
        f"{BATCH / sample_ms * 1e3:.2f} reports/s ({steps} decode steps), greedy "
        f"{greedy_ms:.1f} ms [{result['card']}]")
    result["sampling"] = dict(regions=n, greedy_margin=margin, ms=sample_ms,
                              reports_per_s=BATCH / sample_ms * 1e3, decode_steps=steps,
                              greedy_ms=greedy_ms)


def cli_xrays(np, raw_shape=RAW_SHAPE):
    """The train CLI phases' CLI_IMAGES uint8 X-rays held in memory
    ({"mem://<i>": image}, seed 41): phase 18 installs them in this
    process, phase 21 in each rank's own (a spawned rank does not inherit
    images_in_memory)."""
    rng = np.random.default_rng(41)
    return {f"mem://{i}": rng.integers(0, 256, raw_shape, dtype=np.uint8)
            for i in range(CLI_IMAGES)}


def write_tokenizer_dir(tok, path):
    """vocab.json and merges.txt of a GPT2Tokenizer, for --tokenizer-dir."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(tok.encoder, f)
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


def write_split_csv(np, path, n, n_images, raw_shape, seed):
    """A split csv of `n` rows in the ETL's schema over "mem://<i>" images
    (i cycling over n_images): all 29 regions with a box, phrases of report
    words for ~60% of them."""
    import csv
    from tests.torch_parity import WORDS
    rng = np.random.default_rng(seed)
    words = [w.lower() for w in WORDS if w != "."]
    h, w = raw_shape
    rows = []
    for i in range(n):
        xy = rng.uniform(0, [w * 0.8, h * 0.8], (29, 2))
        wh = rng.uniform(40, [w * 0.4, h * 0.4], (29, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).round(1)
        phrases = [" ".join(rng.choice(words, rng.integers(3, 9))).capitalize() + "."
                   if rng.uniform() < 0.6 else "" for _ in range(29)]
        rows.append({"mimic_image_file_path": f"mem://{i % n_images}",
                     "bbox_coordinates": str(boxes.tolist()),
                     "bbox_labels": str(list(range(1, 30))), "bbox_phrases": str(phrases),
                     "bbox_phrase_exists": str([bool(p) for p in phrases]),
                     "bbox_is_abnormal": str([bool(rng.uniform() < 0.3) for _ in phrases]),
                     "reference_report": " ".join(p for p in phrases if p)})
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return path


def phase_train_cli(np, torch, dev, result):
    """(d) `python -m rgrg_tpu_torch.train`'s main in-process at RGRGConfig()
    (validation every 8 mini-steps instead of 2400): stage 3 from split
    CSVs of synthetic 2048x2500 uint8 X-rays held in memory (the card's
    machine has no cv2), augmented on the host by CLI_WORKERS threads, 8
    mini-steps (2 updates), a validation, `best` and `last`. Host ms per
    augmented batch of 16, ms per mini-step (the step, and wall including
    the wait for data), images/s, one mini-step profiled (idle share against
    the CLI's wall per mini-step), K1 / K2 launches. Then
    ReportGenerator.from_checkpoint(<run_dir>/last) and evaluate_model on
    one val batch at beam 4, max_length 60, through K1-K3. Returns the
    launches of these runs."""
    import dataclasses
    import shutil
    import rgrg_tpu_torch.train.__main__ as cli
    from rgrg_tpu_torch.core.config import RGRGConfig
    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.eval.evaluator import evaluate_model
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.train import trainer

    base = RGRGConfig()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, evaluate_every_k_batches=CLI_STEPS))
    mcfg, tcfg = cfg.model, cfg.train
    b = tcfg.batch_size
    work = os.path.join(ROOT, "build", "smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tok = report_tokenizer(mcfg.decoder.vocab_size, mcfg.decoder.eos_token_id, byte_level=True)
    tok_dir = write_tokenizer_dir(tok, os.path.join(work, "tokenizer"))
    arrays = cli_xrays(np)
    train_csv = write_split_csv(np, os.path.join(work, "train.csv"), CLI_STEPS * b,
                                CLI_IMAGES, RAW_SHAPE, seed=42)
    val_csv = write_split_csv(np, os.path.join(work, "val.csv"), max(b, BATCH), CLI_IMAGES,
                              RAW_SHAPE, seed=43)
    run_dir = os.path.join(work, "run")
    out = {}
    with images_in_memory(arrays):
        # the host data path alone: batches of 16 augmented samples
        ds = RGRGDataset(read_split_csv(train_csv), tok, train=True)
        for workers in (0, CLI_WORKERS):
            it = ds.batches(b, shuffle=True, workers=workers)
            t = time.perf_counter()
            first = next(it)
            out[f"host_ms_per_batch_workers_{workers}"] = (time.perf_counter() - t) * 1e3
            it.close()
        check(first["images"].shape == (b, 512, 512, 1)
              and first["input_ids"].shape == (b, 29, TRAIN_SEQ), "augmented batch")

        marks = []
        make_step = trainer.make_train_step

        def timed_step(*a, **kw):
            step = make_step(*a, **kw)

            def run(state, batch, rng):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, losses = step(state, batch, rng)
                torch.cuda.synchronize()
                marks.append((t, time.perf_counter(), losses))
                return state, losses
            return run

        trainer.make_train_step = timed_step
        nms_keep_mask.launches = roi_align.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            state = cli.main(["--stage", "3", "--train-csv", train_csv, "--val-csv", val_csv,
                              "--tokenizer-dir", tok_dir, "--run-dir", run_dir,
                              "--max-steps", str(CLI_STEPS), "--workers", str(CLI_WORKERS),
                              "--device", dev.type],
                             cfg=cfg)
        finally:
            trainer.make_train_step = make_step
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches}
        steps = len(marks)
        chunks = -(-mcfg.detector.roi.batch_size_per_image // mcfg.detector.roi.proposal_chunk)
        check(state.step == CLI_STEPS == steps and state.opt_state.mini_step == 0,
              f"train CLI: {steps} mini-steps")
        check(counts["nms"] > steps and counts["roi_align"] > chunks * steps,
              f"train CLI: launches {counts} (with a validation)")
        check(all(bool(torch.isfinite(v).all()) for *_, ls in marks for v in ls.values()),
              "train CLI: a loss is not finite")
        for name in ("last", "best"):
            check(os.path.isfile(os.path.join(run_dir, name, "train_state.pt")),
                  f"train CLI: no {name} checkpoint")
        recs = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
        val = [r["val/loss"] for r in recs if "val/loss" in r]
        check(len(val) == 1 and np.isfinite(val[0]), f"train CLI: validation {val}")
        step_ms = [(e - s) * 1e3 for s, e, _ in marks]
        wall_ms = [(marks[i + 1][0] - marks[i][0]) * 1e3 for i in range(steps - 1)]
        wait_ms = [(marks[i + 1][0] - marks[i][1]) * 1e3 for i in range(steps - 1)]
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        steady_step, steady_wall = med(step_ms[1:]), med(wall_ms[1:])
        out.update(step_ms=step_ms, wall_ms_per_mini_step=wall_ms, data_wait_ms=wait_ms,
                   steady_step_ms=steady_step, steady_wall_ms=steady_wall,
                   images_per_s=b / steady_wall * 1e3, total_s=total_s, launches=counts,
                   val_loss=val[0], peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   losses={k: float(v) for k, v in marks[-1][2].items()})
        log(f"train CLI (python -m rgrg_tpu_torch.train, stage 3, RGRGConfig(), {CLI_WORKERS} "
            f"workers): host ms per augmented batch of {b} "
            f"{out['host_ms_per_batch_workers_0']:.0f} (0 workers) / "
            f"{out[f'host_ms_per_batch_workers_{CLI_WORKERS}']:.0f} ({CLI_WORKERS}); "
            f"mini-step ms {['%.0f' % t for t in step_ms]}, wall per mini-step "
            f"{['%.0f' % t for t in wall_ms]} (waiting for data "
            f"{['%.0f' % t for t in wait_ms]}); median step {steady_step:.1f} ms, wall "
            f"{steady_wall:.1f} ms = {out['images_per_s']:.1f} images/s; val loss "
            f"{val[0]:.4f}; launches {counts}; peak {out['peak_gb']:.1f} GB; whole CLI "
            f"{total_s:.1f} s [{result['card']}]")
        # one mini-step profiled on a batch the dataset built: the idle share
        # against the CLI's wall time per mini-step
        step_fn = make_step(RGRG(mcfg), tcfg, stage=3, lm_budget=TRAIN_LM_BUDGET)
        g = torch.Generator(device=dev).manual_seed(0)
        out["profile"] = profiled(torch, lambda: step_fn(state, first, g), steady_wall,
                                  "train CLI profile, one mini-step", "mini-step")
        del state, step_fn
        torch.cuda.empty_cache()

        val_batch = next(RGRGDataset(read_split_csv(val_csv), tok).batches(BATCH))
        gen = ReportGenerator.from_checkpoint(os.path.join(run_dir, "last"), tok_dir, cfg=mcfg,
                                              device=dev, similarity_fn=None)
        shutil.rmtree(work)       # two 4.5 GB training states
        nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
        beam_generate.steps = 0
        scores, eval_ms = timed(torch, lambda: evaluate_model(
            gen.model, gen.params, [val_batch], gen.tokenizer, num_beams=BEAMS,
            max_length=MAX_LENGTH, similarity_fn=None), reps=1)
        eval_counts = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches,
                       "beam_attention": beam_attention.launches,
                       "beam_steps": beam_generate.steps}
    test_chunks = -(-mcfg.detector.rpn.pre_nms_top_n_test // mcfg.detector.roi.proposal_chunk)
    check(eval_counts["nms"] == 1 and eval_counts["roi_align"] == test_chunks
          and eval_counts["beam_steps"] > 0
          and eval_counts["beam_attention"] == mcfg.decoder.num_layers * eval_counts["beam_steps"],
          f"evaluation of the trained checkpoint: launches {eval_counts}")
    lg = scores["language_generation"]
    check(lg["language_images"] == BATCH and "meteor" in scores.get("sentence", {}),
          "evaluation of the trained checkpoint: scores")
    log(f"train CLI checkpoint: from_checkpoint(<run_dir>/last) + evaluate_model on one val "
        f"batch of {BATCH}, beam {BEAMS} max_length {MAX_LENGTH}: {eval_ms:.0f} ms, "
        f"launches {eval_counts}, IoU {scores['object_detector']['avg_iou']:.4f}, "
        f"sentence METEOR {scores['sentence']['meteor']:.4f} [{result['card']}]")
    out.update(eval_ms=eval_ms, eval_launches=eval_counts)
    result["train_cli"] = out
    del gen
    torch.cuda.empty_cache()
    return {"nms": counts["nms"] + eval_counts["nms"],
            "roi_align": counts["roi_align"] + eval_counts["roi_align"],
            "beam_attention": eval_counts["beam_attention"]}


def chexbert_state_dict(torch, cfg, seed):
    """A CheXbert state dict of `cfg`'s widths with seeded random weights
    (N(0, 0.02) as BERT initialises, heads N(0, 1) so that their argmax is
    decisive)."""
    g = torch.Generator().manual_seed(seed)
    h, inter = cfg.hidden, cfg.intermediate

    def rand(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    e = "bert.embeddings"
    sd = {f"{e}.word_embeddings.weight": rand(cfg.vocab_size, h),
          f"{e}.position_embeddings.weight": rand(cfg.max_positions, h),
          f"{e}.token_type_embeddings.weight": rand(cfg.type_vocab, h),
          f"{e}.LayerNorm.weight": torch.ones(h), f"{e}.LayerNorm.bias": torch.zeros(h)}
    for i in range(cfg.layers):
        p = f"bert.encoder.layer.{i}"
        for name, (o, n) in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                             ("attention.self.value", (h, h)),
                             ("attention.output.dense", (h, h)),
                             ("intermediate.dense", (inter, h)), ("output.dense", (h, inter))):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = rand(o, n), torch.zeros(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = torch.ones(h), torch.zeros(h)
    for j in range(14):
        n = 2 if j == 13 else 4
        sd[f"linear_heads.{j}.weight"] = rand(n, h, std=1.0)
        sd[f"linear_heads.{j}.bias"] = rand(n, std=0.5)
    return sd


def chexbert_batches(np, cfg, n, b, s, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, (b, s))
        mask = (np.arange(s)[None] < rng.integers(s // 2, s + 1, (b, 1))).astype(np.float32)
        labels = np.concatenate([rng.integers(0, 4, (13, b)), rng.integers(0, 2, (1, b))])
        out.append((ids, mask, labels))
    return out


def phase_chexbert_train(np, torch, dev, result):
    """(e) CheXbert fine-tuning (eval/chexbert_train.py, Adam lr 2e-5): a
    2-layer 64-wide labeler card vs CPU over 3 steps (losses within 1e-4),
    then ms per step at BERT-base width (768 x 12 layers) on batches of 16
    reports of 128 tokens (f32, TF32 off)."""
    from rgrg_tpu_torch.eval.chexbert import BertConfig, convert_chexbert
    from rgrg_tpu_torch.eval.chexbert_train import (make_train_step, parameters,
                                                    train_chexbert)
    small = BertConfig(vocab_size=64, hidden=64, layers=2, heads=4, intermediate=128,
                       max_positions=64)
    sd = chexbert_state_dict(torch, small, seed=5)
    batches = chexbert_batches(np, small, 3, 8, 24, seed=6)
    _, cpu_losses = train_chexbert(convert_chexbert(sd, device="cpu"), batches, cfg=small)
    _, gpu_losses = train_chexbert(convert_chexbert(sd, device=dev), batches, cfg=small)
    err = max(abs(a - c) for a, c in zip(cpu_losses, gpu_losses))
    check(err <= 1e-4 and all(np.isfinite(cpu_losses)), f"CheXbert train card vs CPU {err}")

    cfg = BertConfig()
    params = convert_chexbert(chexbert_state_dict(torch, cfg, seed=7), device=dev)
    leaves = parameters(params)
    for t in leaves:
        t.requires_grad_(True)
    step = make_train_step(params, torch.optim.Adam(leaves, lr=2e-5), cfg)
    data = chexbert_batches(np, cfg, 6, CHEXBERT_BATCH, CHEXBERT_TOKENS, seed=8)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(*batch)) for batch in data[:2]]      # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses += [float(step(*batch)) for batch in data[2:]]
    ms = (time.perf_counter() - t) * 1e3 / (len(data) - 2)
    check(all(np.isfinite(losses)), "CheXbert BERT-base: a loss is not finite")
    n_params = sum(t.numel() for t in leaves)
    flops = 6 * n_params * CHEXBERT_BATCH * CHEXBERT_TOKENS
    log(f"CheXbert fine-tuning: small labeler card == CPU (max loss diff {err:.2e} over 3 "
        f"steps); BERT-base ({n_params / 1e6:.1f} M params) batch {CHEXBERT_BATCH} x "
        f"{CHEXBERT_TOKENS} tokens: {ms:.1f} ms a step (~{flops / 1e12:.2f} TFLOP from "
        f"6 x params x tokens = {flops / (ms / 1e3) / 1e12:.1f} TFLOP/s), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, losses "
        f"{[round(x, 3) for x in losses]} [{result['card']}]")
    result["chexbert_train"] = dict(card_vs_cpu_loss_diff=err, ms_per_step=ms,
                                    params_m=n_params / 1e6, flops_per_step=flops,
                                    losses=losses)
    del params, leaves, step
    torch.cuda.empty_cache()


# ------------------------------------------------------------ offline pipeline

OFFLINE_DIR = os.path.join(ROOT, "build", "smoke_offline")
OFFLINE_IMAGES = 16      # X-rays through the product CLI and the serve CLI
TRACE_MAX_LENGTH = 8     # the traced beam request: 6 beam steps keep the trace small
KERNEL_NAMES = ("nms_keep_mask_kernel", "roi_align_kernel", "beam_attn_kernel")


def quiet(fn, *args, **kw):
    """fn(*args, **kw) with its printout captured; (result, printout)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def phase_offline(np, torch, dev, result):
    """20. The offline data pipeline and the product CLI at full width:
    (a) `python -m rgrg_tpu_torch.create_dataset`'s main over a synthetic
    Chest ImaGenome / MIMIC-CXR / MIMIC-CXR-JPG tree of 40 studies
    (tests/etl_corpus.py: header-only JPEGs of 2048x2500 or 2500x2048, whose
    seeded uint8 pixels are held in memory); (b) dataset statistics and the
    pixel mean/std of the train csv, the CIDEr-D frequencies of valid.csv
    (`compute_cider_df`), then `python -m rgrg_tpu_torch.evaluate` on
    test.csv and test-2.csv from a checkpoint directory of the main path's
    weights (save_checkpoint of RGRG(full width).init(seed=0)) with
    `--cider-df`, beam 4 at max_length 300, one batch of 8 each; (c)
    `python -m rgrg_tpu_torch.generate_reports` on 16 of those X-rays at its
    defaults (beam 4, max_length 300, batches of 8), its file equal to
    load_generator + generate_reports; (d) `python -m rgrg_tpu_torch.serve`
    on the directory, 2 batches of 8, greedy, max_length 60, with
    `--weights-int8 pallas`, its file equal to from_checkpoint +
    generate_reports_pipelined; (e) one beam-4 request of 8 (max_length 8)
    under utils/logging.trace, whose trace must name K1-K3, and `summarize`
    of the full-width parameters. K1-K4 counters are checked at each entry
    point. Returns the entry points' launches."""
    import glob
    import math
    import shutil
    from rgrg_tpu_torch import compute_cider_df, create_dataset, dataset_stats, evaluate
    from rgrg_tpu_torch import generate_reports as generate_cli
    from rgrg_tpu_torch import serve as serve_cli
    from rgrg_tpu_torch import serving
    from rgrg_tpu_torch.core.checkpoint import save_checkpoint
    from rgrg_tpu_torch.data.dataset import read_split_csv
    from rgrg_tpu_torch.data.stats import compute_mean_std, load_cider_doc_frequencies
    from rgrg_tpu_torch.data.stats import dataset_stats as split_stats
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.decode.greedy import greedy_generate
    from rgrg_tpu_torch.eval import evaluator, nlg
    from rgrg_tpu_torch.inference import ReportGenerator, write_generated_reports_to_txt
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.utils.logging import trace
    from rgrg_tpu_torch.utils.summary import param_counts, summarize
    from tests.etl_corpus import header_only_jpeg, write_corpus

    cfg = full_width_config()
    layers = cfg.decoder.num_layers
    chunks = -(-cfg.detector.rpn.pre_nms_top_n_test // cfg.detector.roi.proposal_chunk)

    def reset_counts():
        nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
        dense_wint8.launches = beam_generate.steps = 0
        greedy_generate.steps = greedy_generate.prefills = 0

    def read_counts():
        return {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches,
                "beam_attention": beam_attention.launches, "dense_wint8": dense_wint8.launches,
                "beam_steps": beam_generate.steps, "greedy_steps": greedy_generate.steps,
                "prefills": greedy_generate.prefills}

    def check_beam(counts, batches, what):
        check(counts["nms"] == batches and counts["roi_align"] == batches * chunks
              and counts["beam_steps"] > 0
              and counts["beam_attention"] == layers * counts["beam_steps"]
              and counts["dense_wint8"] == 0, f"{what}: launches {counts}")

    t_phase = time.perf_counter()
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    out = {}
    launches = dict.fromkeys(("nms", "roi_align", "beam_attention", "dense_wint8"), 0)
    try:
        # (a) the ETL on the host
        corpus = write_corpus(os.path.join(OFFLINE_DIR, "corpus"), seed=0)
        rng = np.random.default_rng(31)
        arrays = {p: rng.integers(0, 256, hw, dtype=np.uint8)
                  for p, hw in sorted(corpus["images"].items())}
        splits = corpus["output_dir"]
        t = time.perf_counter()
        quiet(create_dataset.main, ["--chest-imagenome", corpus["chest_imagenome"],
                                    "--mimic-cxr", corpus["mimic_cxr"],
                                    "--mimic-cxr-jpg", corpus["mimic_cxr_jpg"],
                                    "--output-dir", splits])
        etl_ms = (time.perf_counter() - t) * 1e3
        csvs = {n: os.path.join(splits, f"{n}.csv") for n in ("train", "valid", "test", "test-2")}
        rows = {n: read_split_csv(p) for n, p in csvs.items()}
        counts = {n: len(r) for n, r in rows.items()}
        check(counts["train"] > 0 and counts["valid"] > 0 and counts["test"] >= BATCH
              and counts["test-2"] >= BATCH, f"ETL rows {counts}")
        for n, rs in rows.items():
            for r in rs:
                h, w = corpus["images"][r["mimic_image_file_path"]]
                regions = len(r["bbox_labels"])
                check(len(r["bbox_phrases"]) == 29
                      and all(0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                              for x1, y1, x2, y2 in r["bbox_coordinates"])
                      and (regions == 29 if n in ("valid", "test") else
                           regions < 29 if n == "test-2" else regions <= 29)
                      and (n == "train" or isinstance(r["reference_report"], str)),
                      f"ETL row of {n}: {r['image_id']}")
        log(f"offline (a) ETL: create_dataset over {len(corpus['images'])} header-only JPEGs "
            f"of 40 studies: rows {counts} in {etl_ms:.1f} ms on the host")
        out["etl"] = dict(rows=counts, host_ms=etl_ms, images=len(corpus["images"]))

        # (b) statistics, CIDEr-D frequencies, the evaluate CLI with them
        t = time.perf_counter()
        stats = split_stats(rows["train"])
        stats_ms = (time.perf_counter() - t) * 1e3
        _, printed = quiet(dataset_stats.main, ["--csv", csvs["train"]])
        check(json.loads(printed[printed.index("{"):]) == stats, "dataset_stats CLI printout")
        with images_in_memory(arrays):
            t = time.perf_counter()
            mean, std = compute_mean_std([r["mimic_image_file_path"] for r in rows["train"]])
            mean_std_ms = (time.perf_counter() - t) * 1e3
        check(abs(mean - 0.5) < 0.01 and abs(std - 0.2887) < 0.01,
              f"pixel mean/std {mean}, {std} of uniform uint8 X-rays")
        df_path = os.path.join(OFFLINE_DIR, "cider_df.bin.gz")
        t = time.perf_counter()
        quiet(compute_cider_df.main, ["--valid-csv", csvs["valid"], "--output", df_path])
        cider_df_ms = (time.perf_counter() - t) * 1e3
        df, log_n = load_cider_doc_frequencies(df_path)
        check(log_n == math.log(counts["valid"]) and df, "CIDEr-D frequencies")
        log(f"offline (b) statistics of train.csv {stats} in {stats_ms:.2f} ms; pixel mean "
            f"{mean:.5f} std {std:.5f} over {counts['train']} X-rays in {mean_std_ms:.0f} ms; "
            f"CIDEr-D frequencies of {counts['valid']} valid reports ({len(df)} n-grams) in "
            f"{cider_df_ms:.1f} ms")

        params = RGRG(cfg).init(seed=0, device=dev, decoder_dtype=torch.bfloat16)
        ckpt = os.path.join(OFFLINE_DIR, "params")
        t = time.perf_counter()
        save_checkpoint(ckpt, params)
        save_s = time.perf_counter() - t
        ckpt_gb = os.path.getsize(glob.glob(os.path.join(ckpt, "*"))[0]) / 1e9
        del params
        torch.cuda.empty_cache()
        tok = report_tokenizer(cfg.decoder.vocab_size, cfg.decoder.eos_token_id,
                               byte_level=True)
        tok_dir = write_tokenizer_dir(tok, os.path.join(OFFLINE_DIR, "tokenizer"))

        recorded, eval_ms = [], []
        original_nlg, original_eval = nlg.compute_nlg_scores, evaluator.evaluate_model

        def recording(metrics, generated, reference, **kw):
            recorded.append((list(generated), list(reference), kw))
            return original_nlg(metrics, generated, reference, **kw)
        scores_path = os.path.join(OFFLINE_DIR, "eval", "scores.json")
        os.makedirs(os.path.dirname(scores_path))
        reset_counts()
        nlg.compute_nlg_scores = recording
        evaluator.evaluate_model = timed_calls(original_eval, eval_ms)
        try:
            with images_in_memory(arrays):
                t = time.perf_counter()
                quiet(evaluate.main, [
                    "--checkpoint", ckpt, "--tokenizer-dir", tok_dir,
                    "--test-csv", csvs["test"], csvs["test-2"], "--output", scores_path,
                    "--batch-size", str(BATCH), "--num-beams", str(BEAMS),
                    "--max-length", str(EVAL_MAX_LENGTH), "--num-figure-images", "0",
                    "--cider-df", df_path, "--device", dev.type], cfg=cfg)
                cli_eval_ms = (time.perf_counter() - t) * 1e3
        finally:
            nlg.compute_nlg_scores, evaluator.evaluate_model = original_nlg, original_eval
        eval_counts = read_counts()
        check_beam(eval_counts, 2, "evaluate CLI")
        with open(scores_path) as f:
            scores = json.load(f)
        check(len(recorded) == 2 and len(scores) == 2, "evaluate CLI: two splits scored")
        ciders = []
        for (gens, refs, kw), name in zip(recorded, ("test", "test-2")):
            check(kw.get("cider_df") == df and kw.get("cider_log_n") == log_n,
                  f"evaluate CLI: {name} not scored with the --cider-df file")
            with_file = original_nlg(("cider",), gens, refs, cider_df=df, cider_log_n=log_n)
            without = original_nlg(("cider",), gens, refs)
            # each reference report scored against the next one: words in
            # common, weighted by the file's frequencies or the split's own
            swapped = refs[1:] + refs[:1]
            cross_file = original_nlg(("cider",), swapped, refs, cider_df=df, cider_log_n=log_n)
            cross_none = original_nlg(("cider",), swapped, refs)
            got = scores[csvs[name]]["report"]["cider"]
            check(got == with_file["cider"] and math.isfinite(got),
                  f"evaluate CLI: {name} CIDEr-D {got} != {with_file['cider']}")
            ciders.append(dict(split=name, cider_d=got, cider_d_without_file=without["cider"],
                               references_vs_next=cross_file["cider"],
                               references_vs_next_without_file=cross_none["cider"]))
        log(f"offline (b) evaluate CLI: checkpoint directory ({ckpt_gb:.2f} GB, saved in "
            f"{save_s:.1f} s), test.csv + test-2.csv, one batch of {BATCH} each, beam {BEAMS} "
            f"max_length {EVAL_MAX_LENGTH}: ms per batch {['%.0f' % m for m in eval_ms]} "
            f"(whole CLI {cli_eval_ms:.0f} ms with loading), launches {eval_counts}; CIDEr-D "
            f"with the --cider-df file / without: "
            + "; ".join(f"{c['split']} {c['cider_d']:.6f} / {c['cider_d_without_file']:.6f} "
                        f"(each reference against the next {c['references_vs_next']:.4f}"
                        f" / {c['references_vs_next_without_file']:.4f})"
                        for c in ciders) + f" [{result['card']}]")
        out["stats"] = dict(train=stats, stats_ms=stats_ms, pixel_mean=mean, pixel_std=std,
                            mean_std_ms=mean_std_ms, cider_df_ms=cider_df_ms, ngrams=len(df))
        out["evaluate_cli"] = dict(ms_per_batch=eval_ms, cli_ms=cli_eval_ms, launches=eval_counts,
                                   cider=ciders, checkpoint_gb=ckpt_gb, save_s=save_s)
        for k in launches:
            launches[k] += eval_counts[k]

        # (c) the product CLI at its defaults
        images = [r["mimic_image_file_path"] for r in rows["test"] + rows["test-2"]]
        images = images[:OFFLINE_IMAGES]
        check(len(images) == OFFLINE_IMAGES, "not enough test X-rays for the CLI")
        chunk_ms = []
        original_gr = ReportGenerator.generate_reports

        def timed_gr(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            reps = original_gr(self, *a, **kw)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t) * 1e3)
            return reps
        cli_out = os.path.join(OFFLINE_DIR, "generated_reports.txt")
        reset_counts()
        ReportGenerator.generate_reports = timed_gr
        try:
            with images_in_memory(arrays):
                t = time.perf_counter()
                _, printed = quiet(generate_cli.main, [
                    "--checkpoint", ckpt, "--tokenizer-dir", tok_dir, "--images", *images,
                    "--output", cli_out, "--device", dev.type], cfg=cfg)
                cli_gen_ms = (time.perf_counter() - t) * 1e3
        finally:
            ReportGenerator.generate_reports = original_gr
        gen_counts = read_counts()
        check_beam(gen_counts, OFFLINE_IMAGES // BATCH, "generate_reports CLI")
        gen = evaluate.load_generator(ckpt, tok_dir, cfg, dev)
        with images_in_memory(arrays):
            want = [r for i in range(0, OFFLINE_IMAGES, BATCH)
                    for r in gen.generate_reports(images[i:i + BATCH])]
        want_out = os.path.join(OFFLINE_DIR, "want_reports.txt")
        write_generated_reports_to_txt(images, want, want_out)
        with open(cli_out) as f, open(want_out) as g:
            got_lines, want_lines = f.read().splitlines(), g.read().splitlines()
        check(got_lines == want_lines and len(got_lines) == 5 * OFFLINE_IMAGES,
              "generate_reports CLI: its file differs from load_generator + generate_reports")
        check(printed.count(":\n  ") == OFFLINE_IMAGES, "generate_reports CLI printout")
        words = sum(len(r.report.split()) for r in want)
        log(f"offline (c) generate_reports CLI: {OFFLINE_IMAGES} X-rays from the checkpoint "
            f"directory at its defaults (beam {BEAMS}, max_length 300, batches of {BATCH}): ms "
            f"per chunk {['%.0f' % m for m in chunk_ms]}, whole CLI {cli_gen_ms:.0f} ms with "
            f"loading; launches {gen_counts}; file equal line for line to load_generator + "
            f"generate_reports ({words} words in all) [{result['card']}]")
        out["generate_reports_cli"] = dict(ms_per_chunk=chunk_ms, cli_ms=cli_gen_ms,
                                           launches=gen_counts, words=words)
        for k in launches:
            launches[k] += gen_counts[k]

        # (d) serving the checkpoint directory through K4
        serve_dir = os.path.join(OFFLINE_DIR, "serve_images")
        os.makedirs(serve_dir)
        for i, p in enumerate(images):
            q = os.path.join(serve_dir, f"{i:02d}.jpg")
            header_only_jpeg(q, *corpus["images"][p])
            arrays[q] = arrays[p]
        marks = []
        original_pipe = serving.generate_reports_pipelined

        def marked(*a, **kw):
            t0 = time.perf_counter()
            for chunk in original_pipe(*a, **kw):
                marks.append((time.perf_counter() - t0) * 1e3)
                yield chunk
        serve_out = os.path.join(OFFLINE_DIR, "served_reports.txt")
        reset_counts()
        serving.generate_reports_pipelined = marked
        try:
            with images_in_memory(arrays):
                t = time.perf_counter()
                quiet(serve_cli.main, [
                    "--checkpoint", ckpt, "--tokenizer-dir", tok_dir, "--image-dir", serve_dir,
                    "--pattern", "*.jpg", "--batch-size", str(BATCH),
                    "--max-length", str(MAX_LENGTH), "--weights-int8", "pallas",
                    "--output", serve_out, "--device", dev.type], cfg=cfg)
                cli_serve_ms = (time.perf_counter() - t) * 1e3
        finally:
            serving.generate_reports_pipelined = original_pipe
        serve_counts = read_counts()
        units = serve_counts["greedy_steps"] + serve_counts["prefills"]
        check(serve_counts["nms"] == OFFLINE_IMAGES // BATCH
              and serve_counts["roi_align"] == OFFLINE_IMAGES // BATCH * chunks
              and serve_counts["beam_attention"] == 0 and serve_counts["greedy_steps"] > 0
              and serve_counts["dense_wint8"] == 4 * layers * units,
              f"serve CLI: launches {serve_counts}")
        served = sorted(glob.glob(os.path.join(serve_dir, "*.jpg")))
        gen2 = ReportGenerator.from_checkpoint(ckpt, tok_dir, cfg=cfg, device=dev)
        with images_in_memory(arrays):
            want = [r for c in original_pipe(gen2, served, batch_size=BATCH,
                                             max_length=MAX_LENGTH, weights_int8="pallas")
                    for r in c]
        write_generated_reports_to_txt(served, want, want_out)
        with open(serve_out) as f, open(want_out) as g:
            check(f.read() == g.read(), "serve CLI: its file differs from from_checkpoint + "
                  "generate_reports_pipelined")
        del gen2
        log(f"offline (d) serve CLI on the checkpoint directory: {OFFLINE_IMAGES} X-rays, "
            f"{len(marks)} batches of {BATCH}, greedy max_length {MAX_LENGTH}, weights_int8 "
            f"pallas: yields at {['%.0f' % m for m in marks]} ms, whole CLI "
            f"{cli_serve_ms:.0f} ms with loading; launches {serve_counts} (K4 = {4 * layers} x "
            f"{units} decode steps + prefills); file equal to from_checkpoint + "
            f"generate_reports_pipelined [{result['card']}]")
        out["serve_cli"] = dict(yield_ms=marks, cli_ms=cli_serve_ms, launches=serve_counts)
        for k in launches:
            launches[k] += serve_counts[k]

        # (e) one request under utils/logging.trace; the parameter summary
        trace_dir = os.path.join(OFFLINE_DIR, "trace")
        reset_counts()
        with images_in_memory(arrays):
            t = time.perf_counter()
            with trace(trace_dir):
                traced = gen.generate_reports(images[:BATCH], max_length=TRACE_MAX_LENGTH)
            traced_ms = (time.perf_counter() - t) * 1e3
        trace_counts = read_counts()
        check_beam(trace_counts, 1, "traced request")
        check(len(traced) == BATCH, "traced request: reports")
        files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        check(len(files) == 1, f"trace: files {files}")
        trace_mb = os.path.getsize(files[0]) / 1e6
        with open(files[0]) as f:
            text = f.read()
        named = {k: text.count(k) for k in KERNEL_NAMES}
        check(all(named.values()), f"trace: kernel names {named}")
        for k in launches:
            launches[k] += trace_counts[k]
        summary = summarize(gen.params)
        groups = param_counts(gen.params)
        total = int(summary.splitlines()[-1].split()[-1].replace(",", ""))
        numel = (sum(p.numel() for p in gen.params["detector"].parameters())
                 + sum(t.numel() for t in _tensors(gen.params["decoder"])))
        check(total == numel == sum(groups.values()), f"summarize total {total} != {numel}")
        log(f"offline (e) trace of one beam-{BEAMS} request of {BATCH} (max_length "
            f"{TRACE_MAX_LENGTH}): {traced_ms:.0f} ms traced, {trace_mb:.1f} MB, kernel name "
            f"mentions {named}, launches {trace_counts}; summarize: {total:,d} parameters "
            f"(= the sum of numel), {len(groups)} groups at depth 2 [{result['card']}]")
        for line in summary.splitlines():
            log(f"  {line}")
        out["trace"] = dict(ms=traced_ms, mb=trace_mb, kernel_mentions=named,
                            launches=trace_counts)
        out["parameters"] = total
        del gen
    finally:
        shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    out.update(launches=launches, seconds=time.perf_counter() - t_phase)
    log(f"offline: phase 20 took {out['seconds']:.1f} s; launches {launches}")
    result["offline"] = out
    return launches


# ------------------------------------------------------------------ slice 12

MESH_DIR = os.path.join(ROOT, "build", "smoke_mesh")
MESH_BATCHES = 2         # greedy batches of 8 served by each world
MESH_TRAIN_STEPS = 4     # mini-steps of train.loop.train by each world: one update
MESH_TIMEOUT_S = 300     # the process group's collective timeout
MESH_REF_SEED = 52       # the small step's 4 images: margins and traps asserted
MESH_REF_BUDGET = 16     # its LM budget, below the batch's LM-valid rows
MESH_CLI_DIGESTS = 2     # the train CLI's first batches each rank's rows are checked on
MESH_LOADER_BATCHES = 6  # batches each loader builds alone on every rank, timed


def reference_training_batch(np, torch, seed=None, b=2):
    """Phase 14(c)'s small training batch (`b` images) and its sampling
    draws: `seed`, or the first seed whose decisions clear TRAINING_MARGINS
    for train_small_config's params seeded 5 on the CPU."""
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import trainer
    from tests.torch_parity import TRAINING_MARGINS, training_margins
    cfg = train_small_config()
    n_anchors = cfg.detector.anchors.num_anchors_per_location * 256
    n_pool = cfg.detector.rpn.pre_nms_top_n(True) + 29
    det = RGRG(cfg).init(seed=5, device=torch.device("cpu"))["detector"]
    for s in ([seed] if seed is not None else range(40)):
        batch = train_batch(np, s, b, 16, cfg.decoder.vocab_size)
        draws = sampling_draws(np, s, b, n_anchors, n_pool)
        t = trainer.batch_to_device(batch, torch.device("cpu"))
        m = training_margins(det, t["images"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
                             draws[2:])
        if all(m[k] >= v for k, v in TRAINING_MARGINS.items()):
            return batch, draws, s
    raise RuntimeError("check failed: no seeded training batch with decision margins")


def mesh_counts():
    """K1-K4 launch counters and the decode step counters, in this process."""
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.decode.greedy import greedy_generate
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    return {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches,
            "beam_attention": beam_attention.launches, "dense_wint8": dense_wint8.launches,
            "beam_steps": beam_generate.steps, "greedy_steps": greedy_generate.steps,
            "prefills": greedy_generate.prefills}


def reset_mesh_counts():
    from rgrg_tpu_torch.decode.beam import beam_generate
    from rgrg_tpu_torch.decode.greedy import greedy_generate
    from rgrg_tpu_torch.ops.beam_attn import beam_attention
    from rgrg_tpu_torch.ops.dense_wint8 import dense_wint8
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    nms_keep_mask.launches = roi_align.launches = beam_attention.launches = 0
    dense_wint8.launches = beam_generate.steps = 0
    greedy_generate.steps = greedy_generate.prefills = 0


def params_digest(torch, tensors):
    """One hash of the tensors' bytes (any dtype): ranks compare
    parameters bit for bit."""
    import hashlib
    h = hashlib.blake2b()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_serve(np, torch, dev, mesh, job):
    """A rank's data-parallel serving: the params replicated from rank 0
    once after loading, as serve.py does (timed; their digest must stay as
    loaded), a warm-up batch through the mesh, then per call the same requests without a mesh over this rank's own
    shards (batch_size 8 / world, in order: the shapes and row budgets its
    mesh call meets; at world 1 simply the calls without a mesh), then the
    mesh call with the counters from 0."""
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.serving import generate_reports_pipelined

    gen = ReportGenerator.from_checkpoint(job["ckpt"], job["tok_dir"], cfg=job["cfg"],
                                          device=dev)

    def digest():
        return params_digest(torch, list(gen.params["detector"].state_dict().values())
                             + _tensors(gen.params["decoder"]))
    images = list(np.random.default_rng(41).integers(
        0, 256, (MESH_BATCHES * BATCH, *job["raw_shape"]), dtype=np.uint8))
    per = BATCH // mesh.size
    common = dict(max_length=job["max_length"], weights_int8="pallas")
    calls = {"greedy": (images, 1), "beam": (images[:BATCH], BEAMS)}
    out = {"digest_loaded": digest()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mesh_lib.replicate_pytree(gen.params, mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["replicate_ms"] = (time.perf_counter() - t0) * 1e3
    out["digest_replicated"] = digest()
    list(generate_reports_pipelined(gen, images[:BATCH], batch_size=BATCH, mesh=mesh,
                                    **common))  # warm-up
    for name, (imgs, beams) in calls.items():
        own = [im for i in range(0, len(imgs), BATCH)
               for im in imgs[i + mesh.rank * per:i + (mesh.rank + 1) * per]]
        row = {"own": [r.report for c in generate_reports_pipelined(
            gen, own, batch_size=per, num_beams=beams, **common) for r in c]}
        reset_mesh_counts()
        reports, marks = [], []
        t0 = time.perf_counter()
        for chunk in generate_reports_pipelined(gen, imgs, batch_size=BATCH, mesh=mesh,
                                                num_beams=beams, **common):
            reports += chunk
            marks.append((time.perf_counter() - t0) * 1e3)
        row.update(reports=[r.report for r in reports],
                   selected=[r.selected_regions.tolist() for r in reports],
                   sentences=[list(r.region_sentences.values()) for r in reports],
                   yield_ms=marks, counts=mesh_counts())
        out[name] = row
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
                      else None)
    del gen
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def interleaved(rank_lists, per):
    """The ranks' own-shard reports in image order: per global batch, each
    rank's `per` in rank order."""
    out = []
    for i in range(0, len(rank_lists[0]), per):
        for lst in rank_lists:
            out += lst[i:i + per]
    return out


def world_agreement(rows, ref):
    """How far a world's reports are from world 1's: identical reports and
    selections, and for the others the first region sentence that differs."""
    diff = []
    for i, (a, b) in enumerate(zip(rows["reports"], ref["reports"])):
        if a != b:
            sa, sb = rows["sentences"][i], ref["sentences"][i]
            first = next((k for k, (x, y) in enumerate(zip(sa, sb)) if x != y),
                         min(len(sa), len(sb)))
            diff.append(dict(image=i, same_selection=rows["selected"][i] == ref["selected"][i],
                             sentences=(len(sa), len(sb)), first_differing_sentence=first))
    return dict(identical=len(rows["reports"]) - len(diff), of=len(rows["reports"]),
                same_selections=sum(a == b for a, b in zip(rows["selected"], ref["selected"])),
                differing=diff)


def first_losses_witness(torch, dev, cfg, batch, lm_budget):
    """World 1's first mini-step losses as train.loop.train computes them
    (its initial params, draws and dropout seeds), forward only, once with
    cuDNN's convolutions and once with PyTorch's own (cuDNN off): the same
    math rounded another way. Returns both and their relative gap."""
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import trainer
    model = RGRG(cfg.model)
    state = trainer.init_train_state(model, cfg.train.seed, cfg.train, stage=3, device=dev)
    runs = []
    for cudnn in (True, False):
        rng = torch.Generator(device=dev).manual_seed(cfg.train.seed + 1)
        with torch.cuda.device(dev):
            torch.cuda.manual_seed(cfg.train.seed + 2)
        torch.backends.cudnn.enabled = cudnn
        try:
            with torch.no_grad():
                _, losses = trainer.compute_losses(model, state.params,
                                                   trainer.batch_to_device(batch, dev), rng, 3,
                                                   cfg.train, lm_budget)
        finally:
            torch.backends.cudnn.enabled = True
        runs.append({k: float(v) for k, v in losses.items()})
    del state
    torch.cuda.empty_cache()
    return {"cudnn": runs[0], "native": runs[1],
            "gap": {k: abs(runs[1][k] - v) / max(abs(v), 1e-6) for k, v in runs[0].items()}}


def mesh_train(np, torch, dev, mesh, job):
    """A rank's part of train.loop.train over the same global batches: the
    first mini-step's losses, ms per mini-step, launches, peak memory, the
    trained tensors' digest, and (world 1) a file of its trained tensors
    and BatchNorm statistics, or (a larger world, rank 0) their largest
    differences to that file."""
    import shutil
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import loop, trainer

    cfg = job["train_cfg"]
    b = cfg.train.batch_size
    batches = [train_batch(np, 300 + i, b, job["train_seq"], cfg.model.decoder.vocab_size,
                           size=cfg.model.detector.image_size)
               for i in range(MESH_TRAIN_STEPS)]
    first, marks = [], []
    make_step = trainer.make_train_step

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng):
            state, losses = step(state, batch, rng)
            if not first:
                first.append({k: float(v) for k, v in losses.items()})
            return state, losses
        return run

    def feed():
        for batch in batches:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())
            yield batch

    witness = (first_losses_witness(torch, dev, cfg, batches[0], job["lm_budget"])
               if mesh.size == 1 and dev.type == "cuda" else None)
    run_dir = os.path.join(job["dir"], f"train_world{mesh.size}")
    reset_mesh_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer.make_train_step = recording_step
    try:
        state = loop.train(RGRG(cfg.model), cfg, feed, run_dir, stage=3,
                           lm_budget=job["lm_budget"], max_steps=MESH_TRAIN_STEPS, device=dev)
    finally:
        trainer.make_train_step = make_step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(time.perf_counter())
    out = {"first_losses": first[0], "counts": mesh_counts(),
           "ms": [(marks[i + 1] - marks[i]) * 1e3 for i in range(len(marks) - 1)],
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
                       else None),
           "update": state.opt_state.mini_step == 0 and state.step == MESH_TRAIN_STEPS,
           "witness": witness,
           "digest": params_digest(torch, state.opt_state.tensors)}
    stats = {k: v for k, v in state.params["detector"].named_buffers() if "running" in k}
    ref_path = os.path.join(job["dir"], "train_world1.pt")
    if mesh.size == 1:
        torch.save({"params": [t.detach().cpu() for t in state.opt_state.tensors],
                    "stats": {k: v.cpu() for k, v in stats.items()}}, ref_path)
    elif mesh.rank == 0:
        ref = torch.load(ref_path)
        out["param_diff"] = max((a.detach().cpu() - r).abs().max().item()
                                for a, r in zip(state.opt_state.tensors, ref["params"]))
        out["bn_err"] = max((stats[k].cpu() - r).abs().max().item()
                            / max(1.0, r.abs().max().item()) for k, r in ref["stats"].items())
    del state
    mesh_lib.barrier(mesh)   # world 1's file and every rank's run are done
    if mesh.rank == 0:
        shutil.rmtree(run_dir, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_train_cli(np, torch, dev, mesh, job):
    """A rank's part of `python -m rgrg_tpu_torch.train` over the ranks
    (`_train_rank`, --workers CLI_WORKERS: each rank loads only its rows)
    at job["cli"]["cfg"], from split CSVs over the in-memory X-rays,
    installed here from their seed. First both loaders alone on the host,
    every rank at once, MESH_LOADER_BATCHES batches each: the replicated
    one's global batches (what every rank built before) and the rank-local
    one's rows. Then the CLI: CLI_STEPS mini-steps and one validation
    (rank 0), the launch counters from 0. Returns the loaders' host ms a
    batch, the digests of the CLI's first MESH_CLI_DIGESTS batches,
    its loader's RankLoadStats, ms per mini-step, the wait for data and
    the wall time per mini-step, whether every loss was finite, the
    checkpoints this rank saved and (rank 0) which exist and the
    validation losses, the launches."""
    import dataclasses
    import shutil
    import rgrg_tpu_torch.train.__main__ as cli
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.data.dataset import RankLoadStats, RGRGDataset, read_split_csv
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
    from rgrg_tpu_torch.train import loop, trainer
    from tests.torch_mesh_ranks import batch_digest

    c = job["cli"]
    b = c["cfg"].train.batch_size
    cuda = dev.type == "cuda"
    out = {}
    host = mesh_lib.host_mesh(mesh)
    with images_in_memory(cli_xrays(np, job["raw_shape"])):
        tok = GPT2Tokenizer.from_dir(c["tok_dir"])
        rows = read_split_csv(c["train_csv"])
        loaders = {"replicated": lambda: RGRGDataset(rows, tok, train=True).batches(
                       b, shuffle=True, workers=CLI_WORKERS),
                   "rank_local": lambda: RGRGDataset(rows, tok, train=True).rank_batches(
                       b, mesh.rank, mesh.size, lambda f: mesh_lib.gather_objects(f, host),
                       shuffle=True, workers=CLI_WORKERS)}
        for name, make in loaders.items():
            mesh_lib.barrier(host)   # the ranks build at once, as in a run
            it, ms = make(), []
            for _ in range(MESH_LOADER_BATCHES):
                t = time.perf_counter()
                next(it)
                ms.append((time.perf_counter() - t) * 1e3)
            it.close()
            out[f"{name}_host_ms"] = ms

        stats, digests, marks, saved = RankLoadStats(), [], [], []
        rank_batches, make_step, save = (RGRGDataset.rank_batches, trainer.make_train_step,
                                         loop.save_checkpoint)

        def recorded_batches(self, *a, **kw):
            for batch in rank_batches(self, *a, **dict(kw, stats=stats)):
                if len(digests) < MESH_CLI_DIGESTS:
                    digests.append(batch_digest(batch))
                yield batch

        def timed_step(*a, **kw):
            step = make_step(*a, **kw)

            def run(state, batch, rng):
                if cuda:
                    torch.cuda.synchronize(dev)
                t = time.perf_counter()
                state, losses = step(state, batch, rng)
                if cuda:
                    torch.cuda.synchronize(dev)
                marks.append((t, time.perf_counter(),
                              all(bool(torch.isfinite(v).all()) for v in losses.values())))
                return state, losses
            return run

        def recorded_save(path, *a, **kw):
            saved.append(os.path.basename(path))
            return save(path, *a, **kw)

        run_dir = os.path.join(job["dir"], f"cli_world{mesh.size}")
        argv = ["--stage", "3", "--train-csv", c["train_csv"], "--val-csv", c["val_csv"],
                "--tokenizer-dir", c["tok_dir"], "--run-dir", run_dir,
                "--max-steps", str(CLI_STEPS), "--workers", str(CLI_WORKERS),
                "--device", dev.type]
        RGRGDataset.rank_batches, trainer.make_train_step = recorded_batches, timed_step
        loop.save_checkpoint = recorded_save
        reset_mesh_counts()
        t0 = time.perf_counter()
        try:
            cli._train_rank(mesh.rank, cli.build_parser().parse_args(argv), c["cfg"])
        finally:
            RGRGDataset.rank_batches, trainer.make_train_step = rank_batches, make_step
            loop.save_checkpoint = save
        if cuda:
            torch.cuda.synchronize(dev)
        out["total_s"] = time.perf_counter() - t0
        out["counts"] = mesh_counts()
    n = len(marks)
    out.update(digests=digests, stats=dataclasses.asdict(stats), saved=saved,
               finite=all(f for *_, f in marks), steps=n,
               step_ms=[(e - s) * 1e3 for s, e, _ in marks],
               wall_ms=[(marks[i + 1][0] - marks[i][0]) * 1e3 for i in range(n - 1)],
               wait_ms=[(marks[i + 1][0] - marks[i][1]) * 1e3 for i in range(n - 1)])
    if mesh.rank == 0:
        out["files"] = {name: os.path.isfile(os.path.join(run_dir, name, "train_state.pt"))
                        for name in ("best", "last")}
        out["val"] = [r["val/loss"] for r in map(json.loads, open(
            os.path.join(run_dir, "metrics.jsonl"))) if "val/loss" in r]
    mesh_lib.barrier(mesh)
    if mesh.rank == 0:
        shutil.rmtree(run_dir, ignore_errors=True)   # two 4.5 GB training states
    if cuda:
        torch.cuda.empty_cache()
    return out


def cli_expected_digests(np, job, worlds):
    """Per world and rank, the digests of its rows of the replicated
    loader's first MESH_CLI_DIGESTS global batches (--workers CLI_WORKERS),
    built in this process on the CLI's split."""
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.data.dataset import RGRGDataset, read_split_csv
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
    from tests.torch_mesh_ranks import batch_digest
    c = job["cli"]
    with images_in_memory(cli_xrays(np, job["raw_shape"])):
        ds = RGRGDataset(read_split_csv(c["train_csv"]), GPT2Tokenizer.from_dir(c["tok_dir"]),
                         train=True)
        it = ds.batches(c["cfg"].train.batch_size, shuffle=True, workers=CLI_WORKERS)
        batches = [next(it) for _ in range(MESH_CLI_DIGESTS)]
        it.close()
    return {n: [[batch_digest(mesh_lib.shard_pytree_batch(g, mesh_lib.Mesh(n, r)))
                 for g in batches] for r in range(n)] for n in worlds}


def _grad_rel_all(torch, grads, ref):
    """Relative L2 distance of two gradients, each the concatenation of
    its tensors."""
    num = sum((g.double() - r.double()).norm().item() ** 2 for g, r in zip(grads, ref))
    den = sum(r.double().norm().item() ** 2 for r in ref)
    return (num / den) ** 0.5 if den > 0 else num ** 0.5


def small_reference_params(torch, dev, base=None):
    """train_small_config's params seeded 5 on the CPU (the params whose
    decisions TRAINING_MARGINS was checked against), or a copy of `base`
    (such params), on `dev`: a generator on the card draws other values."""
    import copy
    from rgrg_tpu_torch.models.full_model import RGRG
    if base is None:
        base = RGRG(train_small_config()).init(seed=5, device=torch.device("cpu"))
        if dev.type == "cpu":
            return base
    return {"detector": copy.deepcopy(base["detector"]).to(dev),
            "decoder": _tree_map(base["decoder"], lambda t: t.to(dev, copy=True))}


def mesh_reference_naive(np, torch, dev, batch, draws, budget):
    """The small reference step's inputs and yardsticks, from the same
    params (small_reference_params): whether the global batch of 4
    shows the traps of a naive data-parallel port on `dev` (its LM-valid
    rows exceed `budget`, the halves hold different numbers of valid
    target tokens, each half's first BatchNorm statistics differ from the
    batch's); the naive port's step on `dev` (each half alone: its own
    BatchNorm statistics, draws, LM compaction and means; losses and
    gradients averaged over the halves, as a DDP averages them); and the
    global step on the CPU, whose distance to world 1 on the card shows
    how far f32 rounding alone moves the gradients."""
    from rgrg_tpu_torch.core import config as TC
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import trainer
    cfg = train_small_config()
    model = RGRG(cfg)
    tc1 = TC.TrainConfig(grad_accumulation_steps=1)
    base = small_reference_params(torch, torch.device("cpu"))

    def step(d, rows):
        params = small_reference_params(torch, d, base)
        opt = trainer.make_optimizer(params, tc1, stage=3)
        part = trainer.batch_to_device({k: v[rows] for k, v in batch.items()}, d)
        total, losses = trainer.compute_losses(model, params, part, iter([x[rows] for x in draws]),
                                               3, tc1, budget)
        total.backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                [t.grad.detach().to("cpu", copy=True) if t.grad is not None
                 else torch.zeros(t.shape) for t in opt.tensors])

    det = small_reference_params(torch, dev, base)["detector"]
    t = trainer.batch_to_device(batch, dev)
    with torch.no_grad():
        _, aux = det.train_forward(t["images"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
                                   iter(draws))
        valid = aux["class_detected"] & t["region_has_sentence"]
        tokens = (t["attention_mask"][..., 1:] * valid[..., None]).sum(dim=(1, 2))
        x = det.backbone.conv1(t["images"].permute(0, 3, 1, 2))
        whole = x.mean(dim=(0, 2, 3))
        bn_gap = min((x[h].mean(dim=(0, 2, 3)) - whole).abs().max().item()
                     for h in (slice(0, 2), slice(2, 4)))
    traps = {"lm_valid_rows": int(valid.sum()), "budget": budget,
             "half_tokens": [float(tokens[:2].sum()), float(tokens[2:].sum())],
             "half_bn_gap": bn_gap}
    halves = [step(dev, rows) for rows in (slice(0, 2), slice(2, 4))]
    naive_losses = {k: (halves[0][0][k] + halves[1][0][k]) / 2 for k in halves[0][0]}
    naive_grads = [(a + b) / 2 for a, b in zip(halves[0][1], halves[1][1])]
    cpu_losses, cpu_grads = step(torch.device("cpu"), slice(0, 4))
    return traps, {"losses": naive_losses, "grads": naive_grads, "cpu_losses": cpu_losses,
                   "cpu_grads": cpu_grads}


def mesh_reference_step(np, torch, dev, mesh, job):
    """One stage-3 mini-step (an AdamW update at accumulation 1) of the
    small training model (small_reference_params) on this
    rank's rows of a global batch of 4 distinct images whose decisions
    clear TRAINING_MARGINS, its sampling draws replayed: the losses, the
    all-reduced gradients' and the trained tensors' digests, the
    gradients' distance to the CPU's global step (mesh_reference_naive),
    and (world 1) a file of the gradients, tensors and BatchNorm
    statistics, or (a larger world) their distances to that file and the
    naive port's distances to it."""
    from rgrg_tpu_torch.core import config as TC
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.train import trainer

    cfg = train_small_config()
    params = small_reference_params(torch, dev)
    tc1 = TC.TrainConfig(grad_accumulation_steps=1)
    state = trainer.TrainState(params, trainer.make_optimizer(params, tc1, stage=3), 0)
    opt = state.opt_state
    grads = []
    adamw_step = opt.adamw.step

    def recording_step():
        grads.extend(t.grad.detach().to("cpu", copy=True) for t in opt.tensors)
        return adamw_step()
    opt.adamw.step = recording_step
    step = trainer.make_train_step(RGRG(cfg), tc1, stage=3, lm_budget=MESH_REF_BUDGET,
                                   mesh=mesh)
    state, losses = step(state, mesh_lib.shard_pytree_batch(job["ref_batch"], mesh),
                         iter(job["ref_draws"]))
    names = [n for n, _ in params["detector"].named_parameters()]
    names += [f"decoder trainable {i}" for i in range(len(grads) - len(names))]
    tensors = [t.detach().cpu() for t in opt.tensors]
    stats = {k: v.cpu() for k, v in params["detector"].named_buffers() if "running" in k}
    naive = torch.load(os.path.join(job["dir"], "reference_naive.pt"))
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "digest": params_digest(torch, tensors), "grad_digest": params_digest(torch, grads),
           "cpu_rel": {n: _rel_l2(torch, g, r) for n, g, r in zip(names, grads,
                                                                  naive["cpu_grads"])},
           "cpu_rel_all": _grad_rel_all(torch, grads, naive["cpu_grads"])}
    path = os.path.join(job["dir"], "reference_step_world1.pt")
    if mesh.size == 1:
        torch.save({"grads": grads, "params": tensors, "stats": stats,
                    "losses": out["losses"]}, path)
    else:
        ref = torch.load(path)
        out["grad_rel"] = {n: _rel_l2(torch, g, r) for n, g, r in zip(names, grads, ref["grads"])}
        out["grad_rel_all"] = _grad_rel_all(torch, grads, ref["grads"])
        out["naive_rel_all"] = _grad_rel_all(torch, naive["grads"], ref["grads"])
        out["naive_loss_err"] = {k: abs(v - ref["losses"][k]) / max(abs(ref["losses"][k]), 1e-6)
                                 for k, v in naive["losses"].items()}
        out["grad_norm"] = {n: r.norm().item() for n, r in zip(names, ref["grads"])}
        out["param_diff"] = max((a - r).abs().max().item()
                                for a, r in zip(tensors, ref["params"]))
        out["bn_err"] = max((stats[k] - r).abs().max().item() / max(1.0, r.abs().max().item())
                            for k, r in ref["stats"].items())
    mesh_lib.barrier(mesh)
    return out


def mesh_job(rank, job):
    """Phase 21 on one rank of a data-parallel mesh (core/mesh.launch): the
    small reference step, serving, then training, as `job` asks. Returns
    host objects."""
    import numpy as np
    import torch
    from rgrg_tpu_torch.core import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_lib.rank_device()
    mesh = mesh_lib.make_mesh()
    out = {"rank": rank, "world": mesh.size, "device": str(dev), "backend": mesh.backend}
    out["reference_step"] = mesh_reference_step(np, torch, dev, mesh, job)
    if job.get("serve"):
        out["serve"] = mesh_serve(np, torch, dev, mesh, job)
    if job.get("train"):
        out["train"] = mesh_train(np, torch, dev, mesh, job)
    if job.get("train_cli"):
        out["train_cli"] = mesh_train_cli(np, torch, dev, mesh, job)
    return out


def mesh_cli_checks(ranks, world, b, want_digests, train_chunks, expect):
    """Phase 21's checks of the train CLI over `world` ranks (mesh_train_cli
    on each), through `expect`; returns its record: per rank the loaders'
    host ms a batch (each, and the mean after the first: the replicated
    loader builds ahead across batches), ms per mini-step, the wait for
    data and the wall per mini-step (medians after the first), images/s,
    samples built and rows received."""
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    for r in ranks:
        c, i = r["train_cli"], r["rank"]
        expect(c["digests"] == want_digests[i],
               f"rank {i}: the train CLI's first batches are not its rows of the replicated "
               f"loader's")
        st = c["stats"]
        expect(st["built"] == st["rows"] == CLI_STEPS * (b // world)
               and st["unreadable"] == 0 and st["rounds"] == CLI_STEPS,
               f"rank {i}: the rank-local loader built {st}")
        expect(c["steps"] == CLI_STEPS and c["finite"],
               f"rank {i}: train CLI {c['steps']} mini-steps, losses finite {c['finite']}")
        expect(c["saved"] == (["best", "last"] if i == 0 else []),
               f"rank {i}: train CLI saved {c['saved']}")
        tc = c["counts"]
        expect(tc["nms"] >= CLI_STEPS and tc["roi_align"] >= train_chunks * CLI_STEPS,
               f"rank {i}: train CLI launches {tc}")
    lead = ranks[0]["train_cli"]
    expect(lead["files"] == {"best": True, "last": True}
           and len(lead["val"]) == 1 and lead["val"][0] == lead["val"][0],
           f"train CLI: checkpoints {lead['files']}, validation {lead['val']}")
    row = {"val_loss": lead["val"], "ranks": []}
    for r in ranks:
        c = r["train_cli"]
        wall = med(c["wall_ms"][1:])
        row["ranks"].append(dict(
            rank=r["rank"], replicated_host_ms=c["replicated_host_ms"],
            rank_local_host_ms=c["rank_local_host_ms"],
            replicated_host_ms_mean=mean(c["replicated_host_ms"][1:]),
            rank_local_host_ms_mean=mean(c["rank_local_host_ms"][1:]),
            step_ms=c["step_ms"], wait_ms=c["wait_ms"], wall_ms=c["wall_ms"],
            steady_step_ms=med(c["step_ms"][1:]), steady_wait_ms=med(c["wait_ms"][1:]),
            steady_wall_ms=wall, rank_images_per_s=c["stats"]["rows"] / CLI_STEPS / wall * 1e3,
            built=c["stats"]["built"], rows=c["stats"]["rows"], counts=c["counts"],
            total_s=c["total_s"]))
    return row


def log_mesh_cli(name, row, b, result):
    fmt = lambda xs: "/".join(f"{x:.0f}" for x in xs)  # noqa: E731
    rs = row["ranks"]
    log(f"  {name} train CLI (--workers {CLI_WORKERS}, rank-local loading, global batch {b}, "
        f"{CLI_STEPS} mini-steps + 1 validation), per rank: host ms a batch, rank-local rows "
        f"{fmt(r['rank_local_host_ms_mean'] for r in rs)} against the replicated global "
        f"batch {fmt(r['replicated_host_ms_mean'] for r in rs)} (mean of batches 2-"
        f"{MESH_LOADER_BATCHES}); mini-step {fmt(r['steady_step_ms'] for r in rs)} ms, waiting "
        f"for data {fmt(r['steady_wait_ms'] for r in rs)} ms, wall "
        f"{fmt(r['steady_wall_ms'] for r in rs)} ms (medians after the first) = "
        f"{'/'.join('%.1f' % r['rank_images_per_s'] for r in rs)} images/s a rank; built "
        f"{fmt(r['built'] for r in rs)} samples for {fmt(r['rows'] for r in rs)} rows; "
        f"validation loss {row['val_loss']}; CLI {fmt(r['total_s'] for r in rs)} s; "
        f"launches {[r['counts'] for r in rs]} [{result['card']}]")


def phase_mesh(np, torch, dev, result, cfg=None, train_cfg=None, raw_shape=RAW_SHAPE,
               max_length=MAX_LENGTH, lm_budget=TRAIN_LM_BUDGET, train_seq=TRAIN_SEQ):
    """21. The data-parallel mesh (core/mesh.py): one process per rank,
    started by core.mesh.launch after the kernels are built. A checkpoint
    directory of the main path's full-width seeded weights (as phase 20
    writes it). Each world serves, through generate_reports_pipelined(mesh=),
    2 batches of 8 uint8 2048x2500 X-rays greedy (max_length 60,
    weights_int8="pallas", int8 KV cache) and 1 batch at beam 4, then trains
    4 mini-steps (one update) of train.loop.train at RGRGConfig() (stage
    3, f32, TF32 off, global batch 16) on synthetic batches:
    (a) world 1 through NCCL on cuda:0; (b) world 2, two ranks sharing
    cuda:0 through gloo; (c) with 2 or more cards, world min(count, 4)
    through NCCL, one card per rank. In every world: the params' digest
    the same on every rank before and after their replication; every
    rank's reports equal to its own shards served without a mesh at
    batch_size 8 / world in the same order (the shapes and row budgets its
    mesh call meets: at world 1, the calls without a mesh), which holds the
    sharding, padding and gathering exact; each rank's K1, K2, K4 (greedy)
    and K3 (beam) counters as its shard needs them; the trained tensors
    bitwise equal across ranks, and against world 1 the parameters after
    the update within 2 x lr and BN statistics within 1e-5. Against world
    1, the reports and selections that agree and the first losses are
    measured, not required: another batch per card picks other cuDNN and
    cuBLAS algorithms and other decode row budgets, so random bf16 weights'
    near-ties and the detector's decisions at full width can go another
    way; world 1 measures how far its first losses move when only the
    convolutions' rounding changes (first_losses_witness). What is held
    instead is a small training step (train_small_config) on a global batch
    of 4 distinct images whose decisions clear TRAINING_MARGINS and which,
    checked on the card, shows a naive port's traps (mesh_reference_naive):
    losses within 1e-4 of world 1's, parameters within 2 x lr, BN
    statistics within 1e-5, each tensor's gradient within 1e-2 relative L2
    (phase 14(c)'s bound in the backbone), while the naive port's gradient
    and its total and LM losses fall outside those bounds. ms per batch and per mini-step, the params'
    replication and peak GB per rank are recorded. Worlds 2 and 4 then run
    `python -m rgrg_tpu_torch.train` over their ranks (mesh_train_cli:
    stage 3 at train_cfg, --workers CLI_WORKERS, CLI_STEPS mini-steps and a
    validation, the X-rays held in memory in each rank): each rank's first
    batches digest-equal to its rows of the replicated loader's, built
    here; samples built equal to rows received (no image is unreadable);
    finite losses; `best` and `last` saved once, by rank 0; K1 and K2 on
    every rank; both loaders' host ms a batch, the wait for data, ms and
    wall per mini-step recorded per rank. Returns the launches of the mesh
    runs (all ranks)."""
    import dataclasses
    import shutil
    from rgrg_tpu_torch.core import mesh as mesh_lib
    from rgrg_tpu_torch.core.checkpoint import save_checkpoint
    from rgrg_tpu_torch.core.config import RGRGConfig
    from rgrg_tpu_torch.models.full_model import RGRG

    t_phase = time.perf_counter()
    cfg = cfg or full_width_config()
    train_cfg = train_cfg or RGRGConfig()
    layers = cfg.decoder.num_layers
    chunks = -(-cfg.detector.rpn.pre_nms_top_n_test // cfg.detector.roi.proposal_chunk)
    train_chunks = -(-train_cfg.model.detector.roi.batch_size_per_image
                     // train_cfg.model.detector.roi.proposal_chunk)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    out, launches = {}, dict.fromkeys(("nms", "roi_align", "beam_attention", "dense_wint8"), 0)
    try:
        params = RGRG(cfg).init(seed=0, device=dev, decoder_dtype=torch.bfloat16)
        ckpt = os.path.join(MESH_DIR, "params")
        save_checkpoint(ckpt, params)
        del params
        tok = report_tokenizer(cfg.decoder.vocab_size, cfg.decoder.eos_token_id,
                               byte_level=True)
        tok_dir = write_tokenizer_dir(tok, os.path.join(MESH_DIR, "tokenizer"))
        # 4 distinct images divide over 1, 2 and 4 ranks
        ref_batch, ref_draws, _ = reference_training_batch(np, torch, MESH_REF_SEED, b=4)
        traps, naive = mesh_reference_naive(np, torch, dev, ref_batch, ref_draws,
                                            MESH_REF_BUDGET)
        torch.save(naive, os.path.join(MESH_DIR, "reference_naive.pt"))
        out["reference_traps"] = traps
        log(f"mesh: small reference step's traps on the card: {traps}")
        check(traps["lm_valid_rows"] > traps["budget"]
              and traps["half_tokens"][0] != traps["half_tokens"][1]
              and traps["half_bn_gap"] > 1e-3,
              f"mesh: the small reference batch does not show the naive port's traps: {traps}")
        del naive
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()   # each rank brings its own context
        # the train CLI over ranks: split CSVs over the in-memory X-rays,
        # validation after its CLI_STEPS mini-steps
        b = train_cfg.train.batch_size
        cli_dir = os.path.join(MESH_DIR, "cli")
        cli_tok = report_tokenizer(train_cfg.model.decoder.vocab_size,
                                   train_cfg.model.decoder.eos_token_id, byte_level=True)
        cli = dict(cfg=dataclasses.replace(train_cfg, train=dataclasses.replace(
                       train_cfg.train, evaluate_every_k_batches=CLI_STEPS)),
                   tok_dir=write_tokenizer_dir(cli_tok, os.path.join(cli_dir, "tokenizer")),
                   train_csv=write_split_csv(np, os.path.join(cli_dir, "train.csv"),
                                             CLI_STEPS * b, CLI_IMAGES, raw_shape, seed=42),
                   val_csv=write_split_csv(np, os.path.join(cli_dir, "val.csv"), b,
                                           CLI_IMAGES, raw_shape, seed=43))
        job = dict(ckpt=ckpt, tok_dir=tok_dir, cfg=cfg, train_cfg=train_cfg, dir=MESH_DIR,
                   raw_shape=raw_shape, max_length=max_length, lm_budget=lm_budget,
                   train_seq=train_seq, serve=True, train=True, ref_batch=ref_batch,
                   ref_draws=ref_draws, cli=cli)
        card0 = [f"cuda:{torch.cuda.current_device()}"] if dev.type == "cuda" else None
        worlds = [("world 1", dict(nprocs=1, devices=card0, backend=None)),
                  ("world 2", dict(nprocs=2, devices=card0 and card0 * 2, backend="gloo"))]
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        if count >= 2:
            n = min(count, 4)
            worlds.append((f"world {n}", dict(nprocs=n, devices=[f"cuda:{i}" for i in range(n)],
                                              backend="nccl")))
        t = time.perf_counter()
        cli_digests = cli_expected_digests(np, job, [how["nprocs"] for _, how in worlds[1:]])
        log(f"mesh: the replicated loader's first {MESH_CLI_DIGESTS} batches of {b} built "
            f"here in {time.perf_counter() - t:.1f} s")
        runs = {}
        for name, how in worlds:
            t = time.perf_counter()
            ranks = mesh_lib.launch(mesh_job, how["nprocs"],
                                    args=(dict(job, train_cli=how["nprocs"] > 1),),
                                    device=dev.type, devices=how["devices"],
                                    backend=how["backend"], timeout_s=MESH_TIMEOUT_S)
            runs[name] = ranks
            wall = time.perf_counter() - t
            backend = ranks[0]["backend"] or "none"
            per = BATCH // how["nprocs"]
            one = runs["world 1"][0]
            failed = []

            def expect(cond, msg):
                if not cond:
                    failed.append(msg)
            expect(all(r["world"] == how["nprocs"] for r in ranks), "mesh sizes")
            loaded = {r["serve"]["digest_loaded"] for r in ranks}
            expect(len(loaded) == 1 and all(r["serve"]["digest_replicated"] in loaded
                                            for r in ranks),
                   "the params differ across ranks or after their replication")
            agreement = {}
            for call in ("greedy", "beam"):
                want = interleaved([r["serve"][call]["own"] for r in ranks], per)
                for r in ranks:
                    expect(r["serve"][call]["reports"] == want,
                           f"rank {r['rank']}: {call} reports differ from the ranks' own "
                           f"shards served without a mesh")
                    expect(r["serve"][call]["reports"] == ranks[0]["serve"][call]["reports"],
                           f"rank {r['rank']}: {call} reports differ from rank 0's")
                agreement[call] = world_agreement(ranks[0]["serve"][call], one["serve"][call])
            for r in ranks:
                sv, tr = r["serve"], r["train"]
                g, bm = sv["greedy"]["counts"], sv["beam"]["counts"]
                expect(g["nms"] == MESH_BATCHES and g["roi_align"] == MESH_BATCHES * chunks
                       and g["greedy_steps"] > 0 and g["beam_attention"] == 0
                       and g["dense_wint8"] == 4 * layers * (g["greedy_steps"] + g["prefills"]),
                       f"rank {r['rank']}: greedy launches {g}")
                expect(bm["nms"] == 1 and bm["roi_align"] == chunks and bm["beam_steps"] > 0
                       and bm["beam_attention"] == layers * bm["beam_steps"]
                       and bm["dense_wint8"] > 0, f"rank {r['rank']}: beam launches {bm}")
                tc = tr["counts"]
                expect(tc["nms"] == MESH_TRAIN_STEPS
                       and tc["roi_align"] == train_chunks * MESH_TRAIN_STEPS,
                       f"rank {r['rank']}: training launches {tc}")
                expect(tr["update"], f"rank {r['rank']}: no AdamW update after "
                       f"{MESH_TRAIN_STEPS} mini-steps")
                for counts in (g, bm, tc):
                    for k in launches:
                        launches[k] += counts[k]
                r["train"]["loss_err"] = {
                    k: abs(tr["first_losses"][k] - v) / max(abs(v), 1e-6)
                    for k, v in one["train"]["first_losses"].items()}
            expect(len({r["train"]["digest"] for r in ranks}) == 1,
                   "trained parameters differ across ranks")
            refs = [r["reference_step"] for r in ranks]
            expect(len({x["digest"] for x in refs}) == 1
                   and len({x["grad_digest"] for x in refs}) == 1,
                   "the reference step's gradients or parameters differ across ranks")
            ref_err = max(abs(refs[0]["losses"][k] - v) / max(abs(v), 1e-6)
                          for k, v in one["reference_step"]["losses"].items())
            expect(ref_err <= 1e-4, f"reference step: losses rel err {ref_err} against "
                   f"world 1")
            if how["nprocs"] > 1:
                # every tensor's gradient within phase 14(c)'s backbone
                # bound of 1e-2 (f32 cancellation in train-mode BatchNorm's
                # backward puts two summation orders ~4e-3 apart in the
                # backbone and the RPN conv that reads it: cpu_rel), and
                # the naive port's losses and gradient outside the
                # tolerances, so that the check sees the trap
                rs = refs[0]
                expect(max(rs["grad_rel"].values()) <= 1e-2,
                       f"reference step: gradients rel L2 {max(rs['grad_rel'].values())} "
                       f"(worst tensor), {rs['grad_rel_all']} (whole) against world 1")
                expect(rs["naive_rel_all"] > 1e-2 and rs["naive_loss_err"]["loss_total"] > 1e-4
                       and rs["naive_loss_err"]["loss_lm"] > 1e-4,
                       f"reference step: the naive port is within the tolerances (gradient "
                       f"{rs['naive_rel_all']}, losses {rs['naive_loss_err']})")
                expect(refs[0]["param_diff"] <= 2 * train_cfg.train.learning_rate + 1e-6
                       and refs[0]["bn_err"] <= 1e-5,
                       f"reference step: parameters {refs[0]['param_diff']}, BN statistics "
                       f"{refs[0]['bn_err']} against world 1")
            if how["nprocs"] > 1:
                cli_row = mesh_cli_checks(ranks, how["nprocs"], b, cli_digests[how["nprocs"]],
                                          train_chunks, expect)
                for r in ranks:
                    for k in launches:
                        launches[k] += r["train_cli"]["counts"][k]
            lead = ranks[0]["train"]
            lr = train_cfg.train.learning_rate
            if how["nprocs"] > 1:
                expect(lead["param_diff"] <= 2 * lr + 1e-6,
                       f"parameters after the update differ from world 1's by "
                       f"{lead['param_diff']} > 2 x lr")
                expect(lead["bn_err"] <= 1e-5, f"BN statistics differ from world 1's by "
                       f"{lead['bn_err']}")
            greedy_ms = [r["serve"]["greedy"]["yield_ms"][-1] / MESH_BATCHES for r in ranks]
            beam_ms = [r["serve"]["beam"]["yield_ms"][-1] for r in ranks]
            steady = [sorted(r["train"]["ms"][1:])[len(r["train"]["ms"][1:]) // 2]
                      for r in ranks]
            row = dict(backend=backend, devices=[r["device"] for r in ranks], wall_s=wall,
                       greedy_ms_per_batch=greedy_ms, beam_ms=beam_ms,
                       greedy_yield_ms=[r["serve"]["greedy"]["yield_ms"] for r in ranks],
                       agreement_with_world_1=agreement,
                       train_ms=[r["train"]["ms"] for r in ranks], train_steady_ms=steady,
                       serve_peak_gb=[r["serve"]["peak_gb"] for r in ranks],
                       train_peak_gb=[r["train"]["peak_gb"] for r in ranks],
                       first_losses=lead["first_losses"], loss_err=lead["loss_err"],
                       reference_step=dict(losses=refs[0]["losses"], loss_err=ref_err,
                                           grad_rel=refs[0].get("grad_rel"),
                                           grad_rel_all=refs[0].get("grad_rel_all"),
                                           naive_rel_all=refs[0].get("naive_rel_all"),
                                           naive_loss_err=refs[0].get("naive_loss_err"),
                                           cpu_rel=refs[0]["cpu_rel"],
                                           cpu_rel_all=refs[0]["cpu_rel_all"],
                                           param_diff=refs[0].get("param_diff"),
                                           bn_err=refs[0].get("bn_err")),
                       replicate_ms=[r["serve"]["replicate_ms"] for r in ranks],
                       first_losses_witness=lead["witness"],
                       param_diff=lead.get("param_diff"), bn_err=lead.get("bn_err"),
                       counts=[{c: r["serve"][c]["counts"] for c in ("greedy", "beam")}
                               | {"train": r["train"]["counts"]}
                               | ({"train_cli": r["train_cli"]["counts"]} if "train_cli" in r
                                  else {}) for r in ranks],
                       failed=failed)
            if how["nprocs"] > 1:
                row["train_cli"] = cli_row
            out[name] = row
            fmt = lambda xs: "/".join(f"{x:.0f}" for x in xs)  # noqa: E731
            agree = ", ".join(f"{c} {a['identical']}/{a['of']} reports and "
                              f"{a['same_selections']}/{a['of']} selections"
                              for c, a in agreement.items())
            log(f"mesh {name} ({backend}, {len(ranks)} rank(s) on {sorted(set(row['devices']))}):"
                f" greedy {fmt(greedy_ms)} ms a batch of {BATCH} (per rank, {MESH_BATCHES} "
                f"batches after a warm-up), beam-{BEAMS} batch {fmt(beam_ms)} ms; reports equal "
                f"to the ranks' own shards served without a mesh (batch {per}); against world "
                f"1: {agree}; train {MESH_TRAIN_STEPS} mini-steps of global batch "
                f"{train_cfg.train.batch_size}: ms {[fmt(r['train']['ms']) for r in ranks]}, "
                f"steady {fmt(steady)} ms, peak GB serve "
                f"{['%.1f' % x for x in row['serve_peak_gb'] if x is not None]} train "
                f"{['%.1f' % x for x in row['train_peak_gb'] if x is not None]}; first losses "
                f"{ {k: round(v, 5) for k, v in lead['first_losses'].items()} } (rel err "
                f"against world 1 { {k: float('%.1e' % v) for k, v in lead['loss_err'].items()} })"
                + (f", params vs world 1 {row['param_diff']:.1e} (2 x lr = {2 * lr:.0e}), BN "
                   f"{row['bn_err']:.1e}" if how["nprocs"] > 1 else "")
                + f"; small reference step: losses rel err {ref_err:.1e}"
                + (f", gradients rel L2 {refs[0]['grad_rel_all']:.1e} whole, <= "
                   f"{max(refs[0]['grad_rel'].values()):.1e} a tensor, params "
                   f"{refs[0]['param_diff']:.1e}, BN {refs[0]['bn_err']:.1e}; the naive port: "
                   f"gradient {refs[0]['naive_rel_all']:.1e}, losses "
                   f"{ {k: float('%.1e' % v) for k, v in refs[0]['naive_loss_err'].items()} }"
                   if how["nprocs"] > 1 else "")
                + f"; card vs CPU (rounding alone) {refs[0]['cpu_rel_all']:.1e} whole, <= "
                  f"{max(refs[0]['cpu_rel'].values()):.1e} a tensor"
                + f"; params replicated in {fmt(row['replicate_ms'])} ms"
                + f"; launches {row['counts'][0]}; {wall:.1f} s [{result['card']}]")
            if lead["witness"] is not None:
                log(f"  {name} first losses with cuDNN's and with PyTorch's own convolutions "
                    f"(rel gap): { {k: float('%.1e' % v) for k, v in lead['witness']['gap'].items()} }")
            worst_cpu = sorted(refs[0]["cpu_rel"].items(), key=lambda kv: -kv[1])[:6]
            log(f"  {name} small reference step: worst gradients against the CPU (rel L2) "
                f"{[(k, float('%.1e' % v)) for k, v in worst_cpu]}")
            if how["nprocs"] > 1:
                worst = sorted(refs[0]["grad_rel"].items(), key=lambda kv: -kv[1])[:6]
                log(f"  {name} small reference step: worst gradients against world 1 (rel L2, "
                    f"world 1's norm) {[(k, float('%.1e' % v), float('%.1e' % refs[0]['grad_norm'][k])) for k, v in worst]}")
            if how["nprocs"] > 1:
                log_mesh_cli(name, cli_row, b, result)
            for call, a in agreement.items():
                for d in a["differing"]:
                    log(f"  {name} {call}: image {d['image']} differs from world 1: same "
                        f"selection {d['same_selection']}, sentences {d['sentences']}, first "
                        f"differing sentence {d['first_differing_sentence']}")
            check(not failed, f"mesh {name}: " + "; ".join(failed))
        if count < 2:
            log(f"mesh: {count} card visible: ran worlds 1 (NCCL) and 2 (gloo, one card) only")
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    out.update(launches=launches, seconds=time.perf_counter() - t_phase, cards=count)
    log(f"mesh: phase 21 took {out['seconds']:.1f} s; launches {launches}")
    result["mesh"] = out
    return launches


# ------------------------------------------------------------------ slice 13

REHEARSAL_DIR = os.path.join(ROOT, "build", "smoke_rehearsal")
# the default smoke's depth; `--rehearsal-only` runs the reference's 400 / 150 / 400
REHEARSAL_STEPS = (16, 8, 16)
REHEARSAL_FULL_STEPS = (400, 150, 400)
REHEARSAL_TIME_DETECT = 32
REHEARSAL_ARTIFACT = os.path.join(ROOT, "docs", "artifacts", "three_stage_rehearsal.json")
# the default depth's budgets: at 16 / 8 / 16 mini-steps 866-926 of the
# 1000 proposals survive NMS, so a budget must sit above them to be safe
REHEARSAL_SMOKE_BUDGETS = (992, 960, 600)
# K3 at the rehearsal's beam decode: the 4 x 256 decoder's 4 heads of 64
# dims, 1 + max_length 40 slots, an f32 cache; the items are the run's own
# decode row budget (the largest of its batches), x 4 beams
K3_REHEARSAL_SHAPE = dict(beams=BEAMS, heads=4, slots=41, dim=64)
K3_REHEARSAL_SLOTS = (2, 20, 39)
# the full run's trend bands against the JAX artifact (PERF.md): each
# stage's final validation loss_total at most this factor times JAX's
REHEARSAL_LOSS_FACTOR = 1.5
REHEARSAL_BANDS = {"avg_detections_per_image": 26.0, "avg_iou": 0.80,
                   "region_abnormal_f1": 0.85, "region_selection_recall": 0.9,
                   "stage3_loss_lm": 4.0}


def cpu_paths_count_nothing(np, torch):
    """K1-K3's wrappers on CPU tensors: their plain versions' results, and
    no launch counted."""
    from rgrg_tpu_torch.ops.beam_attn import beam_attention, beam_attention_plain
    from rgrg_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
    from rgrg_tpu_torch.ops.roi_align import roi_align, roi_align_plain
    cpu = torch.device("cpu")
    before = mesh_counts()
    boxes, valid = nms_inputs(np, torch, cpu, n=256)
    check(torch.equal(nms_keep_mask(boxes, valid, 0.7), nms_keep_mask_plain(boxes, valid, 0.7)),
          "K1's wrapper on the CPU is not its plain version")
    feats, rboxes = roi_inputs(np, torch, cpu, torch.float32, b=2, n=8, c=16)
    check(torch.equal(roi_align(feats, rboxes), roi_align_plain(feats, rboxes)),
          "K2's wrapper on the CPU is not its plain version")
    q, k, v, anc, _ = k3_inputs(np, torch, cpu, "f32", 5,
                                shape=dict(items=2, beams=BEAMS, heads=4, slots=8, dim=64))
    check(torch.equal(beam_attention(q, k, v, anc, 5, scale=0.125),
                      beam_attention_plain(q, k, v, anc, 5, scale=0.125)),
          "K3's wrapper on the CPU is not its plain version")
    check(mesh_counts() == before, f"a wrapper counted a launch on the CPU: {before} -> "
          f"{mesh_counts()}")


def rehearsal_bands(summary, reference, first_val):
    """The full run's bands: {name: (value, limit, held)}."""
    stages, ev = summary["stages"], summary["final_eval"]
    bands = {}
    for name in ("stage1", "stage2", "stage3"):
        limit = REHEARSAL_LOSS_FACTOR * reference["stages"][name]["final_val_losses"]["loss_total"]
        got = stages[name]["final_val_losses"]["loss_total"]
        bands[f"{name} final loss_total"] = (got, limit, got <= limit)
    got = stages["stage1"]["final_val_losses"]["loss_total"]
    bands["stage1 final below its first validation"] = (got, first_val, got < first_val)
    lb = REHEARSAL_BANDS
    for name, got, limit in (
            ("avg_detections_per_image", ev["object_detector"]["avg_detections_per_image"],
             lb["avg_detections_per_image"]),
            ("avg_iou", ev["object_detector"]["avg_iou"], lb["avg_iou"]),
            ("region_abnormal f1", ev["region_abnormal"]["f1"], lb["region_abnormal_f1"]),
            ("region_selection recall", ev["region_selection"]["all"]["recall"],
             lb["region_selection_recall"])):
        bands[name] = (got, limit, got >= limit)
    got = stages["stage3"]["final_val_losses"]["loss_lm"]
    bands["stage3 loss_lm"] = (got, lb["stage3_loss_lm"], got <= lb["stage3_loss_lm"])
    closed = ev["language_generation"]["rows_closed_before_max_length"]
    bands["rows closed before max_length"] = (closed, 0, closed > 0)
    budget = summary["proposal_budget"]
    bands["survivors_max below capacity"] = (budget["survivors_max"],
                                             budget["post_nms_capacity"],
                                             budget["survivors_max"] < budget["post_nms_capacity"])
    safe = budget["smallest_safe_budget_tested"]
    bands["a tested budget is safe"] = (safe, None, safe is not None)
    return bands


def phase_rehearsal(np, torch, dev, result, full=False):
    """22. The three-stage rehearsal (tools/three_stage_rehearsal.py) at the
    reference rehearsal's widths: ResNet-50 (DetectorConfig()), a 4 x 256
    GPT-2 with 4 heads over the dummy tokenizer's 257 tokens, batch 8,
    sequences of 40, f32 with TF32 off, on its synthetic corpus: stage 1 ->
    stage 2 -> stage 3 through train.loop.train with warm-start handoffs,
    evaluate_model at beam 4 (max_length 40, early stopping), then the
    proposal-budget check (tools/validate_proposal_budget.py) on the stage-3
    checkpoint with --ladder and detect timed at B=32. Default depth 16 / 8
    / 16 mini-steps, 1 evaluation batch and the budgets
    REHEARSAL_SMOKE_BUDGETS; full=True (`--rehearsal-only`) 400 / 150 / 400,
    3 batches and the tool's budgets, written to
    chiprun_out/{three_stage_rehearsal,proposal_budget_trained}.json and
    held to the trend bands of PERF.md. First K1 at B=8 x N=2000 and B=32
    x N=1000 against its plain version, and K1-K3's wrappers on CPU
    tensors (no launch counted); after the run K3 at the decode's shape
    (the run's largest row budget x 4 beams). Checks that stage 2 begins
    with stage 1's final detector and stage 3 with stage 2's params bit
    for bit (the tool's watch_handoffs), every loss finite, K1-K3 launched
    during the run, a tested budget safe and detect timed, and the
    summary's keys those of the JAX artifact (plus the port's additions).
    Returns the run's K1-K3 launches."""
    import shutil
    from rgrg_tpu_torch.eval import evaluator
    from rgrg_tpu_torch.tools import three_stage_rehearsal as rehearsal

    t_phase = time.perf_counter()
    result["nms_rehearsal"] = {f"B={b} N={n}": nms_row(np, torch, dev, result, b, n)
                               for b, n in ((8, 2000), (32, 1000))}
    cpu_paths_count_nothing(np, torch)

    steps = REHEARSAL_FULL_STEPS if full else REHEARSAL_STEPS
    out_dir = os.path.join(ROOT, "chiprun_out")
    out = os.path.join(out_dir, "three_stage_rehearsal.json" if full
                       else "three_stage_rehearsal_smoke.json")
    argv = ["--stage1-steps", str(steps[0]), "--stage2-steps", str(steps[1]),
            "--stage3-steps", str(steps[2]), "--eval-batches", "3" if full else "1",
            "--num-figure-images", "0", "--time-detect", str(REHEARSAL_TIME_DETECT),
            "--run-dir", os.path.relpath(REHEARSAL_DIR), "--out", os.path.relpath(out),
            "--device", "cuda"]
    if full:
        argv += ["--budget-out",
                 os.path.relpath(os.path.join(out_dir, "proposal_budget_trained.json"))]
    else:
        argv += ["--budgets"] + [str(b) for b in REHEARSAL_SMOKE_BUDGETS]
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)

    step_ms, vals = {1: [], 2: [], 3: []}, {1: [], 2: [], 3: []}
    train_losses = {1: [], 2: [], 3: []}
    val_losses = evaluator.validation_losses

    def timed_step(stage, step):
        def run(state, batch, rng):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, losses = step(state, batch, rng)
            torch.cuda.synchronize()
            step_ms[stage].append((time.perf_counter() - t) * 1e3)
            train_losses[stage].append({k: float(v) for k, v in losses.items()})
            return state, losses
        return run

    def recording_val(*a, **kw):
        losses = val_losses(*a, **kw)
        vals[seen["entering"][-1]].append(losses)
        return losses

    reset_mesh_counts()
    evaluator.validation_losses = recording_val
    try:
        with rehearsal.watch_handoffs(REHEARSAL_DIR, wrap_step=timed_step) as seen:
            summary, _ = quiet(rehearsal.main, argv)
    finally:
        evaluator.validation_losses = val_losses
    launches = mesh_counts()
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    check(seen["entering"] == [1, 2, 3], f"stages entered {seen['entering']}")
    last = [os.path.join(f"stage{n}", "last") for n in (1, 2, 3)]
    check(seen["loaded"] == last + last[2:],
          f"checkpoints loaded {seen['loaded']}: each stage's reload check, then the budget "
          f"check's stage 3")
    for what in ("stage 2 begins with stage 1's final detector",
                 "stage 3 begins with stage 2's params", "stage 3 moved the decoder"):
        check(seen.get(what, False), f"not so: {what}")
    check(all(np.isfinite(v) for ls in train_losses.values() for x in ls for v in x.values()),
          "a training loss is not finite")
    check(all(np.isfinite(v) for s in summary["stages"].values()
              for v in s["final_val_losses"].values())
          and all(np.isfinite(v) for vs in vals.values() for x in vs for v in x.values()),
          "a validation loss is not finite")
    check([len(step_ms[s]) for s in (1, 2, 3)] == list(steps), f"mini-steps {step_ms}")
    n_steps = sum(steps)
    check(launches["nms"] >= n_steps and launches["roi_align"] >= 2 * n_steps
          and launches["beam_attention"] > 0,
          f"K1-K3 did not run on the rehearsal's path: {launches}")
    with open(REHEARSAL_ARTIFACT) as f:
        reference = json.load(f)
    check(rehearsal.reference_key_paths(summary) == rehearsal.key_paths(reference),
          "the summary's keys differ from the JAX artifact's: "
          f"{sorted(rehearsal.reference_key_paths(summary) ^ rehearsal.key_paths(reference))}")
    ev, budget = summary["final_eval"], summary["proposal_budget"]
    lg = ev["language_generation"]
    detect_key = f"detect_ms_at_B{REHEARSAL_TIME_DETECT}"
    check(budget["smallest_safe_budget_tested"] is not None and detect_key in budget,
          f"no tested budget is safe, or detect was not timed: survivors max "
          f"{budget['survivors_max']}, agreement {budget['budget_agreement']}")

    # K3 at the shape this run's decode gave it
    shape = dict(K3_REHEARSAL_SHAPE, items=max(lg["row_budgets"]))
    phase_beam_attn(np, torch, dev, result, shape=shape, slots=K3_REHEARSAL_SLOTS,
                    kinds=("f32",), key="beam_attention_rehearsal")
    result["beam_attention_rehearsal_shape"] = shape

    row = {"steps": list(steps), "launches": launches, "summary": summary,
           "validations": {str(s): v for s, v in vals.items()},
           "train_losses": {str(s): v for s, v in train_losses.items()},
           "ms_per_mini_step": {str(s): v for s, v in step_ms.items()}}
    for s in (1, 2, 3):
        ms = step_ms[s]
        steady = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
        row[f"stage{s}_steady_ms"] = steady
        st = summary["stages"][f"stage{s}"]
        log(f"rehearsal stage {s}: {len(ms)} mini-steps of batch 8, first {ms[0]:.1f} ms, "
            f"median after the first {steady:.1f} ms; stage wall {st['wall_seconds']} s "
            f"(validations, checkpoints and the reload check included); final validation "
            f"{st['final_val_losses']} [{result['card']}]")
        # the trajectory: each loss's mean over windows of 25 mini-steps,
        # and every validation
        window = 25
        for key in train_losses[s][0]:
            means = [np.mean([x[key] for x in train_losses[s][i:i + window]])
                     for i in range(0, len(train_losses[s]), window)]
            log(f"rehearsal stage {s} training {key}, means of {window} mini-steps: "
                + " ".join(f"{m:.4g}" for m in means))
        for i, v in enumerate(vals[s]):
            log(f"rehearsal stage {s} validation {i + 1}: "
                + ", ".join(f"{k} {x:.4f}" for k, x in v.items()))
    log(f"rehearsal evaluation: {ev['wall_seconds']} s, decode {lg['decode_seconds']} s; "
        f"detections/image {ev['object_detector']['avg_detections_per_image']:.3f}, IoU "
        f"{ev['object_detector']['avg_iou']:.4f}, selection recall "
        f"{ev['region_selection']['all']['recall']:.4f}, abnormal F1 "
        f"{ev['region_abnormal']['f1']:.4f}; rows closed before max_length "
        f"{lg['rows_closed_before_max_length']} of {lg['decoded_rows']}; row budgets "
        f"{lg['row_budgets']}; cascade {lg['cascade']} [{result['card']}]")
    log(f"rehearsal budget check: survivors max {budget['survivors_max']} mean "
        f"{budget['survivors_mean']} of {budget['post_nms_capacity']}; agreement "
        f"{budget['budget_agreement']}; smallest safe {budget['smallest_safe_budget_tested']}; "
        f"detect ms at B={REHEARSAL_TIME_DETECT} {budget[detect_key]} [{result['card']}]")
    if full:
        bands = rehearsal_bands(summary, reference, vals[1][0]["loss_total"])
        row["bands"] = {k: {"value": v, "limit": lim, "held": held}
                        for k, (v, lim, held) in bands.items()}
        for k, (v, lim, held) in bands.items():
            log(f"rehearsal band {k}: {v} against {lim}: {'held' if held else 'MISSED'}")
        missed = [k for k, (_, _, held) in bands.items() if not held]
        check(not missed, f"rehearsal bands missed: {missed}")
    row["seconds"] = time.perf_counter() - t_phase
    log(f"rehearsal: phase 22 took {row['seconds']:.1f} s; launches {launches}")
    result["rehearsal"] = row
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        from rgrg_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    built = kernels.build()
    build_s = time.perf_counter() - t0
    log(f"build: {sorted(built)} in {build_s:.1f} s wall (nvcc in parallel: "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in built.items()) + ")")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s}
    if "--mesh-only" in sys.argv[1:]:
        # phase 21 alone, e.g. on four cards: `python3 chip_smoke.py --mesh-only`
        phase_mesh(np, torch, dev, result)
        return finish(result, t_start, None, card, kind, "chip_smoke_mesh.json")
    if "--rehearsal-only" in sys.argv[1:]:
        # phase 22 at the reference rehearsal's depth: `python3 chip_smoke.py --rehearsal-only`
        phase_rehearsal(np, torch, dev, result, full=True)
        return finish(result, t_start, None, card, kind, "chip_smoke_rehearsal.json")
    seconds = result["phase_seconds"] = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its wall seconds kept under `name`."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    timed("3 nms", phase_nms, np, torch, dev, result)
    timed("4 roi_align", phase_roi, np, torch, dev, result)
    timed("14ab train kernels", phase_train_kernels, np, torch, dev, result)
    timed("5 beam_attn", phase_beam_attn, np, torch, dev, result)
    timed("5a beam_attn long", phase_beam_attn, np, torch, dev, result, shape=K3_LONG_SHAPE,
          slots=K3_LONG_SLOTS, kinds=("bf16", "f32"), key="beam_attention_long")
    timed("15 beam_attn t0", phase_beam_attn, np, torch, dev, result, slots=K3_T0_SLOTS,
          key="beam_attention_t0", t0=1)
    timed("15 beam_attn long t0", phase_beam_attn, np, torch, dev, result, shape=K3_LONG_SHAPE,
          slots=K3_T0_LONG_SLOTS, key="beam_attention_long_t0", t0=1)
    timed("6 dense_wint8", phase_dense_wint8, np, torch, dev, result)
    distilbert = timed("6a soft dedup", phase_soft_dedup, np, torch, dev, result)
    with distilbert_dir(distilbert):
        timed("7 reference", phase_reference, np, torch, dev)
        timed("7a eval reference", phase_eval_reference, np, torch, dev, result)
    timed("7 reference serving", phase_reference_serving, np, torch, dev)
    timed("14c train reference", phase_train_reference, np, torch, dev, result)
    cfg = full_width_config()
    launches, gen = timed("8-10 main path", phase_main, np, torch, dev, result, cfg)
    k4_launches = timed("11 serving", phase_serving, np, torch, dev, result, gen, cfg)
    with distilbert_dir(distilbert):
        timed("12 soft dedup full width", phase_soft_dedup_full_width, np, torch, dev, result,
              gen, cfg)
        timed("13 eval full width", phase_eval_full_width, np, torch, dev, result, gen, cfg)
    no_image_launches = timed("16 no_image", phase_no_image, np, torch, dev, result, gen, cfg)
    timed("17 sampling", phase_sampling, np, torch, dev, result, gen, cfg)
    del gen
    torch.cuda.empty_cache()
    train_launches = timed("14d train full width", phase_train_full_width, np, torch, dev,
                           result)
    cli_launches = timed("18 train CLI", phase_train_cli, np, torch, dev, result)
    timed("19 chexbert train", phase_chexbert_train, np, torch, dev, result)
    offline_launches = timed("20 offline", phase_offline, np, torch, dev, result)
    mesh_launches = timed("21 mesh", phase_mesh, np, torch, dev, result)
    rehearsal_launches = timed("22 rehearsal", phase_rehearsal, np, torch, dev, result)
    k4 = result["dense_wint8_row"] = k4_summary(result["dense_wint8"])

    k1, k2 = result["nms"], result["roi_align"]["bf16"]
    k1t, k2t = result["nms_train"]["N=2000"], result["roi_align_train"]["f32"]
    k3 = result["beam_attention"]["bf16 slot 31"]
    k3t0, k3t0_long = (result["beam_attention_t0"]["bf16 slot 31"],
                       result["beam_attention_long_t0"]["bf16 slot 303"])
    k1r = result["nms_rehearsal"]["B=8 N=2000"]
    k3r = result["beam_attention_rehearsal"]["f32 slot 20"]
    k3r_shape = result["beam_attention_rehearsal_shape"]
    k3r_lanes = k3r_shape["items"] * k3r_shape["beams"]
    kernels_line = {"kernels": [
        {"name": "nms_keep_mask", "route": "cuda",
         "source": "rgrg_tpu_torch/csrc/nms.cu",
         "replaces": "rgrg_tpu/ops/nms_pallas.py:52",
         "launches": launches["nms"] + train_launches["nms"] + cli_launches["nms"]
                     + offline_launches["nms"] + mesh_launches["nms"]
                     + rehearsal_launches["nms"],
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "train_ms": k1t["ms"], "train_bound_ms": k1t["bound_ms"],
         "rehearsal_ms": k1r["ms"], "rehearsal_bound_ms": k1r["bound_ms"],
         "shape": "B=8 x N=1000 (serving); train_*: B=16 x N=2000; launches: the "
                  "beam-4 serving requests, the full-width training runs, the train CLI "
                  "and the evaluation of its checkpoint, phase 20's evaluate, "
                  "generate_reports and serve CLIs and traced request, phase 21's "
                  "data-parallel serving, training and train CLI (every rank), and phase "
                  "22's rehearsal; rehearsal_*: B=8 x N=2000"},
        {"name": "roi_align", "route": "cuda",
         "source": "rgrg_tpu_torch/csrc/roi_align.cu",
         "replaces": "rgrg_tpu/ops/roi_align_pallas.py:63",
         "launches": launches["roi_align"] + train_launches["roi_align"]
                     + cli_launches["roi_align"] + offline_launches["roi_align"]
                     + mesh_launches["roi_align"] + rehearsal_launches["roi_align"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "train_ms": k2t["ms"], "train_backward_ms": k2t["backward_ms"],
         "train_backward_bmm_ms": k2t["bmm_ms"],
         "train_backward_bound_ms": k2t["backward_bound_ms"],
         "shape": "B=8 x 256 RoIs, bf16 features (serving); train_*: B=16 x 256 RoIs, "
                  "f32, the backward a torch.bmm over the fused weights; launches: the "
                  "beam-4 serving requests, the full-width training runs, the train CLI "
                  "and the evaluation of its checkpoint, phase 20's evaluate, "
                  "generate_reports and serve CLIs and traced request, phase 21's "
                  "data-parallel serving, training and train CLI (every rank), and phase "
                  "22's rehearsal"},
        {"name": "beam_attention", "route": "cuda",
         "source": "rgrg_tpu_torch/csrc/beam_attn.cu",
         "replaces": "rgrg_tpu/ops/beam_attn_pallas.py:81",
         "launches": launches["beam_attention"] + no_image_launches
                     + cli_launches["beam_attention"] + offline_launches["beam_attention"]
                     + mesh_launches["beam_attention"] + rehearsal_launches["beam_attention"],
         "max_abs_err": max(k3["max_abs_err"], k3t0["max_abs_err"]),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None, "warm_ms": k3["warm_ms"],
         "t0_ms": k3t0["ms"], "t0_bound_ms": k3t0["bound_ms"],
         "t0_long_ms": k3t0_long["ms"], "t0_long_bound_ms": k3t0_long["bound_ms"],
         "rehearsal_ms": k3r["ms"], "rehearsal_bound_ms": k3r["bound_ms"],
         "shape": "384 lanes (96 items x 4 beams), 16 heads x 64 dims, slot 31, bf16 "
                  "cache; ms cold (caches cycled past the L2), warm_ms relaunched on one; "
                  "t0_*: from slot 1 (the no_image decode), slot 31, and 256 lanes x 305 "
                  "slots at slot 303; launches: the beam-4 serving requests, the no_image "
                  "beam, the evaluation of the train CLI's checkpoint, phase 20's "
                  "evaluate and generate_reports CLIs (max_length 300) and traced request, "
                  "phase 21's data-parallel beam batches (every rank) and phase 22's "
                  f"rehearsal; rehearsal_*: {k3r_lanes} lanes ({k3r_shape['items']} items x "
                  f"{k3r_shape['beams']} beams, the rehearsal decode's row budget), 4 heads x "
                  "64 dims, 41 slots, f32 cache, slot 20"},
        {"name": "dense_wint8", "route": "cuda",
         "source": "rgrg_tpu_torch/csrc/dense_wint8.cu",
         "replaces": "rgrg_tpu/ops/dense_wint8_pallas.py:70",
         "launches": k4_launches + offline_launches["dense_wint8"]
                     + mesh_launches["dense_wint8"],
         "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
         "shape": "mean of one layer's 4 products, M=64, bf16 x; library_ms: "
                  "torch.addmm over dequantised bf16 weights (weights_int8=False); "
                  "launches: the 'pallas' serving run, phase 20's serve CLI and phase 21's "
                  "data-parallel serving (every rank)"},
    ]}
    return finish(result, t_start, kernels_line, card, kind, "chip_smoke.json")


def finish(result, t_start, kernels_line, card, kind, name) -> int:
    """Write chiprun_out/<name>, then print the kernels line (if any), the
    card line and the last line."""
    import torch
    result["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(result, f, indent=1)
    log(f"total {result['total_s']:.1f} s")
    if kernels_line is not None:
        print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
