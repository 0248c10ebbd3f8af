#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rgrg_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: compiles every kernel of csrc/ with nvcc for sm_90a, in
     parallel, and prints the build time and ptxas resource lines;
  3. K1 NMS: kernel vs plain PyTorch at B=8 x N=1000 score-sorted boxes with
     ties, duplicates, zero-area and padding boxes (masks bit-identical);
  4. K2 RoIAlign: kernel vs plain PyTorch at feats [8, 16, 16, 2048] in bf16
     and f32 with 256 boxes per image, edge boxes included (max abs error
     <= 1e-4);
  5. reference: a small model (shallow backbone, tiny decoder) serves the
     same uint8 images on the card (kernels) and on the CPU (plain
     versions); reports and detector decisions must be identical;
  6. main path: a full-width ReportGenerator (ResNet-50, 1000 proposals,
     bf16 detector; GPT-2 Medium, 24 layers x 1024 wide x 16 heads, vocab
     50257, bf16) with seeded random weights answers 3 requests of 8 raw
     uint8 2048x2500 X-rays through generate_reports (greedy,
     max_length 60); the NMS launch counter must rise by 1 and the
     RoIAlign counter by 4 per detect;
  7. int8 KV cache: the last request's selected regions decoded again with
     decode_selected_cascade(..., kv_cache_dtype=torch.int8);
  8. breakdown: upload, detect and decode timed apart, and one request
     under torch.profiler (device busy share, top kernels).

TF32 is off for the comparison phases. Output: progress lines, then a JSON
line of per-kernel numbers, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Full numbers also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet) for the bound columns
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

REQUESTS = 3
BATCH = 8
RAW_SHAPE = (2048, 2500)
MAX_LENGTH = 60


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
    """Mean device time of fn() over `iters` back-to-back calls (events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    from rgrg_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
    boxes, valid = nms_inputs(np, torch, dev)
    thr = 0.7
    got = nms_keep_mask(boxes, valid, thr)
    want = nms_keep_mask_plain(boxes, valid, thr)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "NMS kernel mask != plain mask")
    check(not got[BATCH - 1].any(), "NMS kept a box of the all-invalid image")
    ms = cuda_ms(torch, lambda: nms_keep_mask(boxes, valid, thr), 50)
    plain_ms = cuda_ms(torch, lambda: nms_keep_mask_plain(boxes, valid, thr), 3, warmup=1)
    b, n = valid.shape
    keep = got.cpu().numpy()
    pairs = nms_pairs_needed(np, boxes.cpu().numpy(), valid.cpu().numpy(), keep, thr)
    nbytes = b * n * (16 + 1 + 1)
    flops = 16 * pairs  # ~16 f32 operations per IoU test
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    log(f"K1 nms: B={b} N={n} kept={int(keep.sum())} identical=True "
        f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.6f} ms "
        f"({nbytes} B, {pairs} IoU tests) [{result['card']}]")
    result["nms"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
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
            f"max_abs_err {err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}: "
            f"{nbytes} B = {t_bytes * 1e3:.4f} ms, {flops} FLOP = {t_ops * 1e3:.4f} ms) "
            f"[{result['card']}]")
        del got, feats, boxes
        torch.cuda.empty_cache()
    result["roi_align"] = rows


def phase_reference(np, torch, dev):
    """Small model, same weights and uint8 inputs, on the card (kernels) and
    on the CPU (plain versions): identical reports and decisions. Inputs
    are the first seeded batch whose decisions all have margins well above
    the two devices' f32 disagreement (tests/torch_parity.py)."""
    import copy
    from rgrg_tpu_torch.core import config as TC
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.resize import device_preprocess
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer
    from tests.torch_parity import greedy_logit_margin, has_parity_margins

    cfg = TC.ModelConfig(
        detector=TC.DetectorConfig(backbone_stages=(1, 1, 1, 1),
                                   rpn=TC.RPNConfig(pre_nms_top_n_test=32)),
        decoder=TC.DecoderConfig(vocab_size=512, hidden_dim=64, num_heads=4,
                                 num_layers=2, max_positions=64, bos_token_id=0,
                                 eos_token_id=0, pad_token_id=0))
    cpu = torch.device("cpu")
    p_cpu = RGRG(cfg).init(seed=3, device=cpu)
    p_gpu = {"detector": copy.deepcopy(p_cpu["detector"]).to(dev),
             "decoder": _tree_to(p_cpu["decoder"], dev)}
    tok = GPT2Tokenizer.dummy()
    g_cpu = ReportGenerator(p_cpu, tok, cfg=cfg)
    g_gpu = ReportGenerator(p_gpu, tok, cfg=cfg)
    shape = (1024, 768)  # exact 2x downscale: both devices preprocess identically
    for seed in range(24):
        images = list(np.random.default_rng(seed).integers(0, 256, (2, *shape),
                                                           dtype=np.uint8))
        raw, (wy, wx) = g_cpu.preprocess_raw(images)
        x = device_preprocess(raw, wy, wx)
        if not has_parity_margins(p_cpu["detector"], x):
            continue
        det = RGRG(cfg).detect(p_cpu, x)
        if greedy_logit_margin(p_cpu["decoder"], det["region_features"].reshape(-1, 1024),
                               cfg.decoder, 12) >= 3e-5:
            break
    else:
        raise RuntimeError("no seeded reference input with decision margins")
    want = g_cpu.generate_reports(images, max_length=12)
    got = g_gpu.generate_reports(images, max_length=12)
    for g, w in zip(got, want):
        check(g.report == w.report, "card report != CPU report")
        check(g.region_sentences == w.region_sentences, "card sentences != CPU")
        check(np.array_equal(g.selected_regions, w.selected_regions), "selection differs")
        check(np.array_equal(g.class_detected, w.class_detected), "detections differ")
        check(np.allclose(g.top_region_boxes, w.top_region_boxes, rtol=1e-4, atol=1e-2),
              "boxes differ")
    n_sel = int(sum(r.selected_regions.sum() for r in got))
    log(f"reference: input seed {seed}, 2 images, {n_sel} regions decoded: card == "
        f"CPU (reports, sentences, selection, detections; boxes within 1e-2 px)")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


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


def phase_main(np, torch, dev, result, cfg, raw_shape=RAW_SHAPE):
    from rgrg_tpu_torch.inference import ReportGenerator
    from rgrg_tpu_torch.models.full_model import RGRG
    from rgrg_tpu_torch.ops.nms import nms_keep_mask
    from rgrg_tpu_torch.ops.roi_align import roi_align
    from rgrg_tpu_torch.text.tokenizer import GPT2Tokenizer

    t0 = time.perf_counter()
    params = RGRG(cfg).init(seed=0, device=dev, decoder_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = list(params["detector"].parameters()) + list(params["detector"].buffers())
    stack = [params["decoder"]]
    while stack:
        node = stack.pop()
        for v in node.values():
            (stack.append(v) if isinstance(v, dict) else tensors.append(v))
    check(all(t.device.type == dev.type for t in tensors), "a parameter is off the card")
    n_params = sum(t.numel() for t in tensors)
    gen = ReportGenerator(params, GPT2Tokenizer.dummy(), cfg=cfg)
    rng = np.random.default_rng(7)
    requests = [list(rng.integers(0, 256, (BATCH, *raw_shape), dtype=np.uint8))
                for _ in range(REQUESTS)]
    log(f"main path: random params {n_params / 1e6:.1f} M tensors on {dev} "
        f"(init {init_s:.1f} s); {REQUESTS} requests x {BATCH} uint8 {raw_shape}")

    torch.cuda.reset_peak_memory_stats()
    nms_keep_mask.launches = 0
    roi_align.launches = 0
    times, n_regions = [], []
    for reqs in requests:
        t0 = time.perf_counter()
        reports = gen.generate_reports(reqs, max_length=MAX_LENGTH)
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
    launches = {"nms": nms_keep_mask.launches, "roi_align": roi_align.launches}
    chunks = -(-cfg.detector.rpn.pre_nms_top_n_test // cfg.detector.roi.proposal_chunk)
    check(launches["nms"] == REQUESTS, f"NMS launches {launches['nms']} != {REQUESTS}")
    check(launches["roi_align"] == REQUESTS * chunks,
          f"RoIAlign launches {launches['roi_align']} != {REQUESTS * chunks}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = sum(times[1:]) / len(times[1:])
    log(f"main path: ms per request {['%.1f' % t for t in times]} (first includes "
        f"warm-up), steady {steady:.1f} ms = {BATCH / steady * 1e3:.2f} reports/s; "
        f"regions decoded per request {n_regions}; launches {launches}; "
        f"peak {peak_gb:.1f} GB [{result['card']}]")

    # int8 KV cache: re-decode the last request's selected regions
    model = gen.model
    raw, mats = gen.preprocess_raw(requests[-1])
    det = model.detect(params, raw, mats)
    check(all(v.device.type == dev.type for v in det.values()), "detector output off the card")
    sel = det["selected_regions"]

    def decode(kv):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, dec = model.decode_selected_cascade(params, det["region_features"], sel,
                                                 MAX_LENGTH, kv_cache_dtype=kv)
        torch.cuda.synchronize()
        return ids, dec, (time.perf_counter() - t) * 1e3

    ids16, dec16, ms16 = decode(None)
    ids8, dec8, ms8 = decode(torch.int8)
    check(ids8.device.type == dev.type and tuple(ids8.shape) == (BATCH, 29, MAX_LENGTH),
          "int8 decode output")
    check(torch.equal(dec8, sel), "int8 decode skipped a selected region")
    valid = ids8[sel]
    check(bool((valid[:, 0] == cfg.decoder.bos_token_id).all())
          and int(valid.min()) >= 0 and int(valid.max()) < cfg.decoder.vocab_size,
          "int8 decode ids out of range")
    agree = (ids8[sel] == ids16[sel]).float().mean().item()
    log(f"int8 KV decode: {int(sel.sum())} regions, {ms8:.1f} ms (bf16 cache "
        f"{ms16:.1f} ms); token agreement with the bf16 cache {agree:.3f} "
        f"[{result['card']}]")
    result["main"] = dict(ms_per_request=times, steady_ms=steady,
                          reports_per_s=BATCH / steady * 1e3, regions=n_regions,
                          launches=launches, peak_gb=peak_gb, init_s=init_s,
                          int8_decode_ms=ms8, bf16_decode_ms=ms16,
                          int8_bf16_token_agreement=agree, params_m=n_params / 1e6)
    result["breakdown"] = breakdown(torch, gen, params, requests[-1], ms16, steady)
    return launches


def breakdown(torch, gen, params, images, decode_ms, steady_ms):
    """Where a request's time goes: the host-side upload, the detector and
    the decode cascade timed apart (host clock around synchronized work),
    then one whole request under torch.profiler for device busy time by
    kernel. Runs after the launch counters were read."""
    model = gen.model

    def timed(fn, reps=3):
        out, ts = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, sum(ts) / len(ts)

    (raw, mats), upload_ms = timed(lambda: gen.preprocess_raw(images))
    _, detect_ms = timed(lambda: model.detect(params, raw, mats))
    log(f"breakdown: upload {upload_ms:.1f} ms, detect {detect_ms:.1f} ms, "
        f"decode cascade {decode_ms:.1f} ms (bf16 cache)")
    out = {"upload_ms": upload_ms, "detect_ms": detect_ms, "decode_ms": decode_ms}

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen.generate_reports(images, max_length=MAX_LENGTH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # device-side events only (kernels, memcpy, memset): the aten ops that
    # launched them carry the same time again
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        log("breakdown: profiler saw no device time (device busy share not measured)")
        out["profile"] = None
        return out
    top = [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "calls": e.count}
           for e in events[:12] if dev_us(e) > 0]
    launches = sum(e.count for e in events)
    log(f"breakdown: device busy {busy_ms:.1f} ms in one request ({launches} device "
        f"ops); idle share {1 - busy_ms / steady_ms:.1%} of the unprofiled "
        f"{steady_ms:.1f} ms request ({1 - busy_ms / wall_ms:.1%} of the profiled "
        f"{wall_ms:.1f} ms)")
    for row in top:
        log(f"  {row['device_ms']:9.2f} ms {row['calls']:7d}x  {row['name']}")
    out["profile"] = {"profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / steady_ms,
                      "idle_share_profiled": 1 - busy_ms / wall_ms,
                      "device_ops": launches, "top": top}
    return out


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
    phase_nms(np, torch, dev, result)
    phase_roi(np, torch, dev, result)
    phase_reference(np, torch, dev)
    launches = phase_main(np, torch, dev, result, full_width_config())

    k1, k2 = result["nms"], result["roi_align"]["bf16"]
    kernels_line = {"kernels": [
        {"name": "nms_keep_mask", "route": "cuda",
         "source": "rgrg_tpu_torch/csrc/nms.cu",
         "replaces": "rgrg_tpu/ops/nms_pallas.py:52",
         "launches": launches["nms"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "roi_align", "route": "cuda",
         "source": "rgrg_tpu_torch/csrc/roi_align.cu",
         "replaces": "rgrg_tpu/ops/roi_align_pallas.py:63",
         "launches": launches["roi_align"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
    ]}
    result["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(f"total {result['total_s']:.1f} s")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
