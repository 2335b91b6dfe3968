"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` becomes its own ``lib<name>-<hash>.so`` with a plain
C interface, compiled for ``sm_90a`` into ``ops/kernels/build/`` (listed in
``.gitignore``) the first time a kernel of it launches. The hash covers the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. ``build_all`` starts one nvcc per source at once, so the build
takes as long as the slowest file. Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = (
    "layer_norm", "ln_qkv_head", "attention", "decode_attention", "segment_attention",
    "paged_attention", "paged_gather", "flash_attention",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# the entry points of each library that has more than its uv_<name>
ENTRY_POINTS = {
    "segment_attention": ("segment_attention", "paged_segment_attention"),
    "flash_attention": ("flash_attention", "flash_attention_bwd"),
}
# C signature of each entry point uv_<entry> (see the .cu sources)
_SIGNATURES = {
    "layer_norm": (_P, _P, _P, _P, ctypes.c_longlong, _I, _F, _I, _P),
    "ln_qkv_head": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "attention": (
        _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
        _I, _I, _I, _I, _I, _I, _F, _P, _P, _I, _I, _I, _P,
    ),
    "decode_attention": (
        _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _P, _I,
        _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "segment_attention": (
        _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _P, _P, _I,
        _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "paged_segment_attention": (
        _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _P, _P, _P, _I,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "paged_attention": (
        _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _P, _P, _I,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "paged_gather": (_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _P),
    "flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    "flash_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P,
    ),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that is not built yet, all at once.
    Returns per source ``{"path", "seconds", "ptxas"}`` (seconds 0.0 and no
    ptxas report for a library that was already built). Raises with the
    compiler's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        out[name] = {"path": str(path), "seconds": 0.0, "ptxas": ""}
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            path,
        )
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["ptxas"] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for entry in ENTRY_POINTS.get(name, (name,)):
        fn = getattr(lib, f"uv_{entry}")
        fn.argtypes = list(_SIGNATURES[entry])
        fn.restype = ctypes.c_int
    getattr(lib, f"uv_{name}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"uv_{name}_error_string").argtypes = [ctypes.c_int]
    return lib


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = getattr(library(name), f"uv_{name}_error_string")(rc).decode()
        raise RuntimeError(f"uv_{name} launch failed: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require_cuda(*tensors: Optional[torch.Tensor]) -> None:
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError("all tensors of a launch must be on one device")
        dev = t.device
