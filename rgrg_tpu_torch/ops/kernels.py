"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with ctypes. Builds go to
`build/rgrg_tpu_torch/` beside the package (a git-ignored directory),
named by a hash of the source and flags, so an edited source is rebuilt
and an unchanged one is reused. `build()` starts one `nvcc` per source,
all at once. Nothing here runs at import time: the CPU-only test host
imports this module without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rgrg_tpu_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# name -> (source, extra nvcc flags, {C function: argtypes})
KERNELS = {
    # NMS decisions must be bit-identical to the f32 reference: no FMA
    # contraction anywhere in the file
    "nms": ("nms.cu", ["-fmad=false"], {
        "rgrg_nms_keep_mask": [_P, _P, _P, _P, _I, _I, _F, _P],
        "rgrg_nms_words": [_P, _P, _I, _I, _F, _P],
    }),
    "roi_align": ("roi_align.cu", [], {
        "rgrg_roi_align": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    }),
    "beam_attn": ("beam_attn.cu", [], {
        "rgrg_beam_attention": [_P, _I, _P, _P, _I, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _F,
                                _I, _I, _I, _P],
        "rgrg_beam_attention_smem": [_I, _I, _I, _I, _I],
    }),
    "dense_wint8": ("dense_wint8.cu", [], {
        "rgrg_dense_wint8": [_P, _I, _P, _P, _P, _I, _P,
                             _I, _I, _I, _I, _I, _P],
    }),
}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    src, flags, _ = KERNELS[name]
    h = hashlib.sha256((CSRC / src).read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, started together. Returns
    {name: {"path", "seconds", "log"}}; "log" holds nvcc's `-Xptxas -v`
    report (registers, shared memory, spills). Raises on a failed build."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result: Dict[str, dict] = {}
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            result[name] = {"path": str(out), "seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        src, flags, _ = KERNELS[name]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ([find_nvcc()] + ARCH_FLAGS + COMMON_FLAGS + flags
               + ["-o", str(tmp), str(CSRC / src)])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    failures = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        result[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return result


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    path = build([name])[name]["path"]
    lib = ctypes.CDLL(path)
    for fn, argtypes in KERNELS[name][2].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.rgrg_error_string.argtypes = [ctypes.c_int]
    lib.rgrg_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.rgrg_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


# the current CUDA stream of a device as an int, without building a Stream
# object (PyTorch's CUDA builds export the raw getter)
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
