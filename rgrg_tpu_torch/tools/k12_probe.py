"""Kernels K1 (csrc/nms.cu) and K2 (csrc/roi_align.cu) against earlier
versions of themselves, timed in turns in one process on one card.

Builds into build/rgrg_tpu_torch/k12_probe/:
- K2 as it is ("taps"), with plain stores instead of streaming ones
  ("cached_stores"), with every C on the one-channel route
  ("one_channel": 4-byte reads and stores, one channel a thread), at most
  64 registers a thread ("bounds8": 8 blocks an SM), and with each bin
  row's outputs staged in shared memory and written by bulk copies
  ("bulk_stores", `cp.async.bulk`);
- with `--baseline DIR`, the `roi_align.cu` and `nms.cu` found in DIR as
  "base" (an earlier commit's sources, e.g. written there by
  `git show <commit>:rgrg_tpu_torch/csrc/roi_align.cu`).
Each K2 build runs on chip_smoke.py's phase-4 inputs (B=8, 256 ROIs,
C=2048, bf16 and f32) and is checked against the plain version (1e-4) and,
where there is a base, against the base bit for bit (finite features: the
taps the new kernel skips are exact zeros). K1 and its base run on phase
3's inputs (B=8, N=1000) and must give the same mask. Times come from
chip_smoke.cuda_ms in the order base, new, new, base. Run on the card from
the repository root (it imports chip_smoke.py from there):

    python -m rgrg_tpu_torch.tools.k12_probe [--baseline DIR]

Prints one line per case and writes chiprun_out/k12_probe.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke  # the repository root's: inputs, timing, card line
from rgrg_tpu_torch.ops import kernels
from rgrg_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
from rgrg_tpu_torch.ops.roi_align import roi_align_plain

INCLUDE = "#include <stdint.h>\n"
ROUTE = "const bool vec = c % 4 == 0"
BOUNDS = "__launch_bounds__(kThreads)"
BODY = "  const int ch = (blockIdx.x * kThreads + threadIdx.x) * V;\n"
KERNEL_END = "\ntemplate <typename T>\nvoid launch("
# The 4-channel route with each bin row's 8 outputs of the block's channels
# staged in shared memory (two buffers) and written by bulk copies
# (cp.async.bulk, issued by one thread) instead of 16-byte stores.
BULK = """    __shared__ __align__(128) float4 stage[2][kP][kThreads];
    const int ch0 = blockIdx.x * kThreads * 4;
    const unsigned bytes = static_cast<unsigned>(min(kThreads * 4, c - ch0)) * 4u;
    const bool live = ch < c;
    const T* f = feats + static_cast<size_t>(b) * kExtent * kExtent * c + (live ? ch : 0);
    int it = 0;
    for (int r = 0; r < nrois; ++r) {
      float* o = out + (static_cast<size_t>(b) * n + roi0 + r) * kP * kP * c + ch0;
#pragma unroll 1
      for (int p = 0; p < kP; ++p, ++it) {
        const Taps& ty = taps[r][0][p];
        Vec<V> acc[kP] = {};
        const int ny = live ? ty.n : 0;
#pragma unroll 1
        for (int t = 0; t < ny; ++t) {
          const float a = ty.w[t];
          const T* fr = f + ty.off[t];
#pragma unroll
          for (int q = 0; q < kP; ++q) {
            const Taps& tx = taps[r][1][q];
            Vec<V> u = {};
#pragma unroll
            for (int s = 0; s < kTaps; ++s)
              if (s < tx.n) fma_into(u, tx.w[s], load(fr + tx.off[s], Vec<V>{}));
#pragma unroll
            for (int i = 0; i < V; ++i) acc[q].v[i] = __fmaf_rn(a, u.v[i], acc[q].v[i]);
          }
        }
        const int sb = it & 1;
        if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kP; ++q)
          stage[sb][q][threadIdx.x] =
              make_float4(acc[q].v[0], acc[q].v[1], acc[q].v[2], acc[q].v[V - 1]);
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0) {
#pragma unroll
          for (int q = 0; q < kP; ++q) {
            const unsigned src =
                static_cast<unsigned>(__cvta_generic_to_shared(&stage[sb][q][0]));
            asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                         ::"l"(o + static_cast<size_t>(p * kP + q) * c), "r"(src), "r"(bytes)
                         : "memory");
          }
          asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
        }
      }
    }
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
"""
ROI_ARGS = kernels.KERNELS["roi_align"][2]["rgrg_roi_align"]
BASE_NMS_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def roi_variants():
    """{name: source} of K2's variants."""
    src = (kernels.CSRC / "roi_align.cu").read_text()
    assert all(a in src for a in (INCLUDE, ROUTE, BOUNDS, BODY, KERNEL_END)), \
        "csrc/roi_align.cu changed"
    start, end = src.index(BODY), src.index(KERNEL_END)
    body = src[start:src.rindex("}\n", start, end)]  # the kernel's closing brace dropped
    return {
        "taps": src,
        "cached_stores": src.replace(INCLUDE, INCLUDE + "#define __stcs(p, v) (*(p) = (v))\n", 1),
        "one_channel": src.replace(ROUTE, "const bool vec = false && c % 4 == 0", 1),
        "bounds8": src.replace(BOUNDS, "__launch_bounds__(kThreads, 8)", 1),
        "bulk_stores": (src[:start] + BODY + "  if constexpr (V == 1) {\n" + body[len(BODY):]
                        + "  } else {\n" + BULK + "  }\n}\n" + src[end:]),
    }


def build(sources, flags):
    """{name: ctypes library} of {name: source text}, one nvcc each, in parallel."""
    out = kernels.BUILD_DIR / "k12_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = out / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc()] + kernels.ARCH_FLAGS + kernels.COMMON_FLAGS
            + flags.get(name, []) + ["-o", str(out / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def roi_call(lib, feats, boxes, out):
    def call():
        b, h, w, c = feats.shape
        code = lib.rgrg_roi_align(feats.data_ptr(), int(feats.dtype == torch.bfloat16),
                                  boxes.data_ptr(), out.data_ptr(), b, h, w, c,
                                  boxes.shape[1], 8, 2, 1.0 / 32.0, kernels.raw_stream(0))
        assert code == 0, code
    return call


def turns(names, fns, iters):
    """{name: [ms, ...]}: base first and last, the others twice in between."""
    order = (["base"] if "base" in names else []) + [n for n in names if n != "base"] * 2 \
        + (["base"] if "base" in names else [])
    times = {n: [] for n in names}
    for n in order:
        times[n].append(smoke.cuda_ms(torch, fns[n], iters))
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="a directory holding earlier roi_align.cu and nms.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k12_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    sources = {f"roi_{k}": v for k, v in roi_variants().items()}
    flags = {}
    if args.baseline:
        sources["roi_base"] = open(os.path.join(args.baseline, "roi_align.cu")).read()
        sources["nms_base"] = open(os.path.join(args.baseline, "nms.cu")).read()
        flags["nms_base"] = kernels.KERNELS["nms"][1]
    libs = build(sources, flags)
    for name, lib in libs.items():
        if name.startswith("roi_"):
            lib.rgrg_roi_align.argtypes = ROI_ARGS
        else:
            lib.rgrg_nms_keep_mask.argtypes = BASE_NMS_ARGS
    result = {"card": card, "ms": {}}

    for dtype in (torch.bfloat16, torch.float32):
        feats, boxes = smoke.roi_inputs(np, torch, dev, dtype)
        want = roi_align_plain(feats, boxes)
        outs, fns = {}, {}
        for name, lib in libs.items():
            if name.startswith("roi_"):
                short = name[4:]
                # not empty_like: the plain version's einsum output is not contiguous
                outs[short] = torch.empty(want.shape, dtype=torch.float32, device=dev)
                fns[short] = roi_call(lib, feats, boxes, outs[short])
                fns[short]()
        torch.cuda.synchronize()
        torch.cuda.synchronize()
        for name, out in outs.items():
            err = (out - want).abs().max().item()
            assert err <= 1e-4 and bool(torch.isfinite(out).all()), (name, err)
            if "base" in outs:
                assert torch.equal(out, outs["base"]), f"{name} differs from the base"
        del want, outs
        times = turns(list(fns), fns, 20)
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        result["ms"][f"roi_align {key}"] = times
        print(f"K2 roi_align {key} (B=8, 256 ROIs, C=2048), ms in turns: "
              + "; ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                          for n, ts in times.items())
              + (" (all bit-identical to base)" if "base" in fns else "") + f" [{card}]",
              flush=True)
        del feats, boxes, fns
        torch.cuda.empty_cache()

    boxes, valid = smoke.nms_inputs(np, torch, dev)
    want = nms_keep_mask_plain(boxes, valid, 0.7)
    fns = {"new": lambda: nms_keep_mask(boxes, valid, 0.7)}
    check = {"new": fns["new"]}
    if "nms_base" in libs:
        keep = torch.empty_like(valid)

        def base():
            code = libs["nms_base"].rgrg_nms_keep_mask(
                boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), boxes.shape[0],
                boxes.shape[1], 0.7, kernels.raw_stream(0))
            assert code == 0, code
            return keep
        fns["base"] = check["base"] = base
    for name, fn in check.items():
        assert torch.equal(fn(), want), f"K1 {name}: mask differs from the plain one"
    times = turns(list(fns), fns, 50)
    result["ms"]["nms"] = times
    print("K1 nms (B=8, N=1000), ms in turns: "
          + "; ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in ts) for n, ts in times.items())
          + f" (masks identical to plain) [{card}]", flush=True)
    os.makedirs(os.path.join(smoke.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(smoke.ROOT, "chiprun_out", "k12_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
