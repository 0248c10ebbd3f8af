"""Where a launch of kernel K3 (csrc/beam_attn.cu) spends its time.

Builds copies of csrc/beam_attn.cu into build/rgrg_tpu_torch/k3_probe/:
blocks that stop after each step of their chain (after the launch; once
the first chunk's ancestry and queries have arrived; once its rows are
staged; the whole kernel), and whole kernels under other
`__launch_bounds__` minimums (1: the compiler's own register count; 2:
the kernel's, at most 64 registers; 3: at most 40). Each is timed cold,
every launch reading another copy of the K/V cache (copies enough that
the rows they name fill twice the 50 MB L2 cache), on chip_smoke.py's K3
inputs: 96 items x 4 beams, 16 heads of 64 dims, 61 slots, an ancestry
grown as beam search grows it. Run on the card from the repository root
(it imports chip_smoke.py from there):

    python -m rgrg_tpu_torch.tools.k3_probe

Prints one line per case and writes chiprun_out/k3_probe.json.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke  # the repository root's: inputs, timing, card line
from rgrg_tpu_torch.ops import beam_attn, kernels

BOUNDS = "__launch_bounds__(kWarp * kMaxPairs, 2)"
# (name, anchor in the source, what goes before it)
STOPS = [
    ("launch", "  extern __shared__ __align__(16) unsigned char smem[];\n", "  return;\n"),
    ("anc+q", "    if (valid && first == kk) {\n",
     "    if (first == kMaxBeamsPerBlock) a.out[0] = 0.0f;  // keep the ancestry loads\n"
     "    return;\n"),
    ("rows", "\n    if (owner) {\n      // scores", "\n    return;"),
]
CASES = [(2, "bf16"), (31, "bf16"), (59, "bf16"), (31, "f32"), (31, "int8")]
PLANS = [(4, 1, 32), (4, 2, 32), (4, 1, 16)]   # (beams, heads a block, slots a chunk)


def build(variants):
    """{name: ctypes library} of the patched sources, one nvcc each, in parallel."""
    src = open(os.path.join(kernels.CSRC, "beam_attn.cu")).read()
    assert BOUNDS in src, "the kernel's __launch_bounds__ changed"
    out = os.path.join(kernels.BUILD_DIR, "k3_probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc()] + kernels.ARCH_FLAGS + kernels.COMMON_FLAGS
            + ["-o", os.path.join(out, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in log.splitlines() if "registers" in line})
        print(f"built {name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
        lib.rgrg_beam_attention.argtypes = kernels.KERNELS["beam_attn"][2]["rgrg_beam_attention"]
        lib.rgrg_beam_attention.restype = ctypes.c_int
        libs[name] = lib
    return libs


def variants():
    src = open(os.path.join(kernels.CSRC, "beam_attn.cu")).read()
    out = {}
    for i, (name, anchor, before) in enumerate(STOPS):
        assert anchor in src, f"stop {name}: anchor not found"
        out[f"stop{i + 1}_{name.replace('+', '_')}"] = src.replace(anchor, before + anchor, 1)
    for m in (1, 2, 3):
        out[f"min{m}"] = src.replace(BOUNDS, f"__launch_bounds__(kWarp * kMaxPairs, {m})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = build(variants())
    kind_code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    result = {"card": card, "us": {}}
    for slot, kind in CASES:
        q, k, v, anc, scales = smoke.k3_inputs(np, torch, dev, kind, slot)
        want = beam_attn.beam_attention_plain(q, k, v, anc, slot, scale=0.125, **scales)
        out = torch.empty_like(want)
        a = anc.cpu().numpy()
        pairs = sum(len(np.unique(a[i, :, t])) for i in range(a.shape[0])
                    for t in range(slot + 1))
        heads, dim = q.shape[1], q.shape[2]
        named = 2 * pairs * heads * (dim * k.element_size() + (4 if scales else 0))
        copies = max(3, 1 + -(-int(2 * smoke.L2_BYTES) // named))
        caches = itertools.cycle([(k, v, scales)] + [
            (k.clone(), v.clone(), {n: x.clone() for n, x in scales.items()})
            for _ in range(copies - 1)])
        line = []
        for plan in PLANS:
            for name, lib in libs.items():
                def launch():
                    kc, vc, sc = next(caches)
                    ks, vs = sc.get("k_scale"), sc.get("v_scale")
                    code = lib.rgrg_beam_attention(
                        q.data_ptr(), kind_code[q.dtype], kc.data_ptr(), vc.data_ptr(),
                        kind_code[kc.dtype], ks.data_ptr() if ks is not None else None,
                        vs.data_ptr() if vs is not None else None, anc.data_ptr(),
                        out.data_ptr(), q.shape[0], heads, k.shape[2], dim, anc.shape[1], 0,
                        slot, 0.125,
                        *plan, kernels.raw_stream(0))
                    assert code == 0, code
                if name.startswith("min"):
                    launch()
                    torch.cuda.synchronize()
                    err = (out - want).abs().max().item()
                    assert err <= 1e-4, (name, plan, err)
                us = smoke.cuda_ms(torch, launch, 200) * 1e3
                key = f"slot {slot} {kind} plan {'x'.join(map(str, plan))} {name}"
                result["us"][key] = us
                line.append(f"{name} {us:.2f}")
            print(f"slot {slot} {kind}, plan {plan} (beams, heads, slots), {copies} caches: "
                  + "; ".join(line) + f" us [{card}]", flush=True)
            line = []
        del caches
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(smoke.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(smoke.ROOT, "chiprun_out", "k3_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
