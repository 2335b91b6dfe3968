"""Hand-written kernels beside an earlier build of the same kernels, in one
process on one card: the split KV kernel (#8 ``decode_attention``, #11
``segment_tail_attention``, and in its paged instances #9
``paged_decode_attention``, #12 ``paged_segment_tail_attention``), #14
``decode_matmul``, #1 ``fused_layer_norm``, #2 ``ln_qkv_head_fused``, #6
``ln_matmul_gelu``, #7 ``attn_out_proj_residual`` and #5
``qkv_head_transpose``.

    python -m ultravox_torch.scripts.compare_kernels --baseline DIR [--only PART ...]
        [--out FILE] [--sweep-splits]

DIR holds an earlier ``ultravox_torch/ops/kernels/csrc``, for example

    git archive <commit> ultravox_torch/ops/kernels/csrc | tar -x -C DIR

The script builds the libraries of DIR that the chosen parts need
(decode_attention, segment_attention, paged_attention, decode_matmul,
layer_norm, ln_qkv_head, ln_matmul_gelu, attn_out_proj, qkv_head_transpose)
with the port's nvcc flags into DIR/build (each entry point bound with the
signature its source declares: #8/#9/#11/#12 with or without the cluster
size, #14 with or without the fp32 partials of its second kernel, #1 with
or without the instance, #5 with or without the plan's rows and heads; an
entry point DIR's source lacks is left out), then, in bf16 unless said
otherwise (``--only`` picks among ``kv``, ``paged``, ``decode_matmul``,
``layer_norm``, ``ln_qkv_head``, ``ln_matmul_gelu``, ``out_proj`` and
``transpose``; all by default):

- kv: #8 at the flagship decode step (q (4, 32, 64) against a
  (4, 256, 8, 64) slab with 144 keys) and at serving run (c)'s (a
  (4, 2048, 8, 64) slab with 129-190 keys); #11 at the flagship scan step
  (layer 7 of a (16, 4, 256, 8, 64) cache, 128 keys, a 31-slot tail with 15
  written) and at serving run (c)'s block (a (16, 4, 2048, 8, 64) cache,
  129-190 keys, an 8-slot tail with 0-7 written). Each: the current kernel
  against its plain version and against the baseline (4 bf16 ulps of the
  largest output), and the card ms of baseline, current, current,
  baseline in turn (CUDA events, calls queued ahead), beside the bound over
  the visible bytes and SDPA on the same keys (a yardstick; the port never
  calls it); ``kv_pin_digests``: the digests of #8's and #11's outputs on
  ``kv_pin_inputs``, which must be equal for both libraries
  (tests/test_torch_cuda.py pins them); with ``--sweep-splits``, #8 and #11
  with the cluster size forced to 1, 2, 4 and 8 blocks, and the card's time
  for one tiny kernel timed the same way (``add_`` on one element: the floor
  a launch costs back to back);
- paged: #9 and #12 at serving run (a)'s shapes (layer 7 of a (16, 32, 256,
  8, 64) pool, one page per row, 129-190 keys; #12 with an 8-slot tail,
  0-7 written): current and baseline against the plain version, times in
  turns, the bound, and #8 / #11 on the same lengths from a contiguous
  (4, 2048, 8, 64) slab (what the page lookup costs is the gap); with
  ``--sweep-splits``, #9 and #12 at forced cluster sizes;
- decode_matmul: #14 at 4 rows (a decode step) on each Llama-3.2-1B decoder
  product, with a bf16 weight and an int8 weight + bf16 per-channel scale,
  on weight copies that rotate past the 50 MB L2: current and baseline
  against the plain version, two current calls bit-equal, times in turns,
  the bound (one read of the weight), ``torch.mm`` on the bf16 weight and,
  for int8, ``torch._weight_int8pack_mm`` on the weight transposed once to
  (N, K) where this PyTorch runs it on CUDA (else the error it raises);
  with ``--sweep-splits``, the current kernel with the cluster forced to
  1, 2, 4 and 8 blocks and the block's warps along N to 1 and 4, and
  the cost of a call that moves almost no bytes (``_matmul_floor``);
- layer_norm: #1 at (4, 500, 768) and (1, 500, 768) bf16 and (4, 500, 768)
  fp32 (scale and bias fp32): current and baseline against the plain
  version, two calls bit-equal, times in turns, the bound and
  ``F.layer_norm`` (bf16 scale and bias for bf16 x);
- ln_qkv_head: #2 at (4, 500, 768) and (1, 500, 768) x (768, 2304) and
  whisper-large's (1, 1500, 1280) x (1280, 3840), heads of 64 (scale and
  bias fp32): current and baseline against the plain version (4 bf16 ulps
  of the largest output), two current calls bit-equal, the current
  bit-equal to the baseline's tensor-core route where it has one, times in turns, the
  bound, ``torch.mm`` on the LN'd bf16 rows (the product alone) and the
  unfused chain ``F.layer_norm`` -> ``torch.mm`` -> ``+ bias`` ->
  ``view(...).transpose(1, 2).contiguous()`` timed as one run of its four
  calls (yardsticks; the port calls neither), and the tile ``_plan``
  chose; with ``--sweep-splits``, the current kernel with each tensor-core
  tile (128, 64 and 32 rows) that fits forced in turn. Then the routes that must not have moved:
  fp32 at (4, 500, 768) and a bf16 view one element off its storage (the
  CUDA-core kernel) bit-equal to the baseline's;
- ln_matmul_gelu: #6 at the encoder's fc1, (4, 500, 768) and (1, 500, 768)
  x (768, 3072), and whisper-large's FFN, (1, 1500, 1280) x (1280, 5120)
  (scale and bias fp32): current and baseline against the plain version,
  the current within 4 bf16 ulps of the baseline too and bit-equal to the
  baseline's own tensor-core route where it has one, two current calls
  bit-equal, times in turns and with the host's dispatch, the bound,
  ``torch.mm`` on the LN'd rows and the unfused chain ``F.layer_norm`` ->
  ``torch.addmm`` -> ``F.gelu(approximate="tanh")`` (yardsticks), and the
  plan; with ``--sweep-splits``, every tile that fits at 1, 2, 3, 4, 6, 8
  and 12 column tiles a block. Then fp32 and a bf16 view one element off
  its storage (the CUDA-core kernel) bit-equal to the baseline's build;
- out_proj: #7 at the encoder's out-projection, (4, 12, 500, 64) x (12, 64,
  768) + (4, 500, 768) and the same at one request, and whisper-large's,
  (1, 20, 1500, 64) x (20, 64, 1280): current and baseline against the
  plain version (4 bf16 ulps of the largest output), two current calls
  bit-equal, times in turns and with the host's dispatch, the plain
  version's time, the bound, ``torch.mm`` on the heads already
  concatenated, (B T, H Dh) x (H Dh, M), and the unfused chain
  ``transpose(1, 2).reshape`` (a copy) -> ``torch.addmm`` -> ``add_`` of
  the residual (yardsticks), and the plan; with ``--sweep-splits``, every
  tile that fits at every count of column tiles a block can run. Then fp32
  and a bf16 view one element off its storage (the CUDA-core kernel)
  bit-equal to the baseline's build;
- transpose: #5 bit-equal to its plain version (twice) and to the baseline
  at (B, 500, 36 heads of 64) for B 4 and 1, T 1, T 501 at B 4 (a partial
  last block), fp32 heads of 128 at T 77 and fp32 at B 4 and 1; timed at B
  1 and 4 on 32 inputs and outputs that rotate past L2, in turns, with the
  host's dispatch, beside the bound and ``transpose(1, 2).contiguous()``;
  with ``--sweep-splits``, at 1, 2, 4, 8 and 16 rows of T a block.

Prints one line per measurement and one JSON object last (also written to
``--out``). Needs a CUDA card and raises without one. ``paged_edge_inputs``
and ``seen_pool_slots`` build the paged split kernel's edge cases, which
chip_smoke.py and tests/test_torch_cuda.py both run.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import functools
import hashlib
import itertools
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ultravox_torch.ops.kernels import _build
from ultravox_torch.ops.kernels import decode_attention as da
from ultravox_torch.ops.kernels import decode_matmul as dm
from ultravox_torch.ops.kernels import fused_attention as fa
from ultravox_torch.ops.kernels import layer_norm as ln
from ultravox_torch.ops.kernels import paged_attention as pa
from ultravox_torch.ops.kernels import segment_attention as sa

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
B, H, HKV, D, L, LAYER = 4, 32, 8, 64, 16, 7
SERVING_LENS, SERVING_WRITTEN = (129, 150, 171, 190), (0, 3, 5, 7)  # serving runs' decode

L2_BYTES = 50 * 2**20  # H100 L2
# Llama-3.2-1B's decoder products (K, N), as chip_smoke.py's DECODE_PRODUCTS
DECODE_PRODUCTS = {
    "qkv_proj": (2048, 3072), "o_proj": (2048, 2048), "gateup_proj": (2048, 16384),
    "down_proj": (8192, 2048), "lm_head": (2048, 128256),
}
LN_SHAPES = {"(4,500,768) bf16": ((4, 500, 768), torch.bfloat16),
             "(1,500,768) bf16": ((1, 500, 768), torch.bfloat16),
             "(4,500,768) fp32": ((4, 500, 768), torch.float32)}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
# the earlier interfaces: the KV kernels one block per row (no `splits`),
# #14 with the fp32 partials of its second kernel, #1 with no instance
# arguments
KV_ENTRIES = ("decode_attention", "segment_attention", "paged_attention", "paged_segment_attention")
OLD_SIGNATURES = {
    **{e: tuple(a for i, a in enumerate(_build._SIGNATURES[e])
                if i != len(_build._SIGNATURES[e]) - 3) for e in KV_ENTRIES},  # drop `splits`
    "decode_matmul": (_P, _LL, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "layer_norm": (_P, _P, _P, _P, _LL, _I, _F, _I, _P),
    "qkv_head_transpose": (_P, _P, _I, _I, _I, _I, _P),  # 16-byte units a head, no plan
}
# the baseline's libraries each part builds and calls
PART_LIBS = {
    "kv": ("decode_attention", "segment_attention"),
    "paged": ("paged_attention", "segment_attention"),
    "decode_matmul": ("decode_matmul",),
    "layer_norm": ("layer_norm",),
    "ln_qkv_head": ("ln_qkv_head",),
    "ln_matmul_gelu": ("ln_matmul_gelu",),
    "out_proj": ("attn_out_proj",),
    "transpose": ("qkv_head_transpose",),
}
# #2's shapes: (B, T, D, C), heads of 64
LN_QKV_SHAPES = {"(4,500,768)": (4, 500, 768, 2304), "(1,500,768)": (1, 500, 768, 2304),
                 "(1,1500,1280)": (1, 1500, 1280, 3840)}
LN_QKV_HEAD_DIM = 64
# #6's shapes: (B, T, D, F), the encoder's fc1 at 4 requests and at one,
# and whisper-large's FFN (the JAX note's bench shape)
GELU_SHAPES = {"fc1 (4,500,768)": (4, 500, 768, 3072), "fc1 (1,500,768)": (1, 500, 768, 3072),
               "whisper-large (1,1500,1280)": (1, 1500, 1280, 5120)}
GELU_TILES = (1, 2, 3, 4, 6, 8, 12)  # column tiles a block runs, swept
# #7's shapes: (B, H, T, Dh, M), the encoder's out-projection at 4 requests
# and at one, and whisper-large's
OUT_PROJ_SHAPES = {"(4,12,500,64)x768": (4, 12, 500, 64, 768),
                   "(1,12,500,64)x768": (1, 12, 500, 64, 768),
                   "whisper-large (1,20,1500,64)x1280": (1, 20, 1500, 64, 1280)}
# #5's shapes: (B, T, G, head_dim); 36 heads of 64 bf16 at one request and at
# four (timed), then the edges: a single frame, a T the plan's 4-row blocks
# leave a partial last block of, fp32 heads of 128 at a ragged T
TRANSPOSE_TIMED = {"B 1": (1, 500, 36, 64), "B 4": (4, 500, 36, 64)}
TRANSPOSE_EDGES = {"T 1": ((1, 1, 36, 64), torch.bfloat16),
                   "T 501 (T % 4 == 1)": ((4, 501, 36, 64), torch.bfloat16),
                   "fp32 head_dim 128 (2,77)": ((2, 77, 6, 128), torch.float32),
                   "fp32 B 4": ((4, 500, 36, 64), torch.float32),
                   "fp32 B 1": ((1, 500, 36, 64), torch.float32)}
TRANSPOSE_ROWS = (1, 2, 4, 8, 16)  # rows of T a block owns, swept


def takes_splits(csrc: Path, name: str, entry: str) -> bool:
    """Whether the baseline's KV entry point ``uv_<entry>`` (in
    ``<name>.cu``) takes the cluster size."""
    text = (csrc / f"{name}.cu").read_text()
    decl = text[text.index(f"int uv_{entry}("):]
    return "int splits" in decl[:decl.index("{")]


def _current_interface(csrc: Path, name: str, entry: str) -> bool:
    """Whether the baseline's ``uv_<entry>`` has the current signature."""
    text = (csrc / f"{name}.cu").read_text()
    if entry in KV_ENTRIES:
        return takes_splits(csrc, name, entry)
    if name == "decode_matmul":
        return "void* partial" not in text
    if name == "layer_norm":
        return "int nv" in text
    if name == "qkv_head_transpose":
        return "int rows" in text
    return True


def build_baseline(csrc: Path, names) -> dict:
    """nvcc each named baseline library into csrc/build; returns name ->
    CDLL with its entry points' argtypes set."""
    for e in KV_ENTRIES:  # OLD_SIGNATURES drops the `splits` int third from the end
        now = _build._SIGNATURES[e]
        if len(OLD_SIGNATURES[e]) + 1 != len(now) or now[-3] is not _I:
            raise RuntimeError(f"uv_{e}'s signature no longer ends in (splits, ..., ...)")
    out = csrc / "build"
    out.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        so = out / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
               str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the baseline {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.current = {}
        text = (csrc / f"{name}.cu").read_text()
        for entry in _build.ENTRY_POINTS.get(name, (name,)):
            if f"int uv_{entry}(" not in text:  # an entry point added since
                continue
            fn = getattr(lib, f"uv_{entry}")
            lib.current[entry] = _current_interface(csrc, name, entry)
            fn.argtypes = list(_build._SIGNATURES[entry] if lib.current[entry]
                               else OLD_SIGNATURES.get(entry, _build._SIGNATURES[entry]))
            fn.restype = ctypes.c_int
        getattr(lib, f"uv_{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"uv_{name}_error_string").argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def _check(lib, name, rc):
    if rc:
        raise RuntimeError(f"baseline uv_{name}: CUDA error {rc} "
                           f"({getattr(lib, f'uv_{name}_error_string')(rc).decode()})")


def baseline_decode(lib, q, k, v, lengths, window=0):
    """The baseline #8 launch, marshalled as its wrapper did."""
    Bq, Hq, Dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 5)(q.stride(0), q.stride(1), *k.stride()[:3])
    splits = (da.kv_splits(S),) if lib.current["decode_attention"] else ()
    rc = lib.uv_decode_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), strides,
        _build.ptr(lengths), int(window), Bq, Hq, Hq // Hkv, S, Dq,
        da.rounded_scale(Dq**-0.5, q.dtype), *splits, _build.dtype_code(q),
        _build.stream_ptr(q.device))
    _check(lib, "decode_attention", rc)
    return out


def baseline_segment(lib, q, kc, vc, layer, lengths, tk, tv, written, window=0):
    """The baseline #11 launch, marshalled as its wrapper did."""
    Bq, T, Hq, Dq = q.shape
    S, Hkv, Ts = kc.shape[2], kc.shape[3], tk.shape[1]
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:3], *kc.stride()[:4], *tk.stride()[:3])
    splits = (da.kv_splits(S + Ts),) if lib.current["segment_attention"] else ()
    rc = lib.uv_segment_attention(
        _build.ptr(q), _build.ptr(kc), _build.ptr(vc), _build.ptr(tk), _build.ptr(tv),
        _build.ptr(out), strides, _build.ptr(lengths), _build.ptr(written), int(layer),
        int(window), Bq, T, Hq, Hq // Hkv, S, Ts, Dq, da.rounded_scale(Dq**-0.5, q.dtype),
        *splits, _build.dtype_code(q), _build.stream_ptr(q.device))
    _check(lib, "segment_attention", rc)
    return out


def baseline_paged_decode(lib, q, kp, vp, table, lengths, window=0):
    """The baseline #9 launch, marshalled as its wrapper did."""
    Bq, Hq, Dq = q.shape
    P, ps, Hkv = kp.shape[:3]
    n_per = table.shape[1]
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 5)(q.stride(0), q.stride(1), *kp.stride()[:3])
    splits = (da.kv_splits(n_per * ps),) if lib.current["paged_attention"] else ()
    rc = lib.uv_paged_attention(
        _build.ptr(q), _build.ptr(kp), _build.ptr(vp), _build.ptr(out), strides,
        _build.ptr(table), _build.ptr(lengths), int(window), Bq, Hq, Hq // Hkv, n_per, ps, P, Dq,
        da.rounded_scale(Dq**-0.5, q.dtype), *splits, _build.dtype_code(q),
        _build.stream_ptr(q.device))
    _check(lib, "paged_attention", rc)
    return out


def baseline_paged_segment(lib, q, kp, vp, layer, table, lengths, tk, tv, written, window=0):
    """The baseline #12 launch, marshalled as its wrapper did."""
    Bq, T, Hq, Dq = q.shape
    P, ps, Hkv = kp.shape[1:4]
    n_per, Ts = table.shape[1], tk.shape[1]
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 10)(*q.stride()[:3], *kp.stride()[:4], *tk.stride()[:3])
    splits = (da.kv_splits(n_per * ps + Ts),) if lib.current["paged_segment_attention"] else ()
    rc = lib.uv_paged_segment_attention(
        _build.ptr(q), _build.ptr(kp), _build.ptr(vp), _build.ptr(tk), _build.ptr(tv),
        _build.ptr(out), strides, _build.ptr(table), _build.ptr(lengths), _build.ptr(written),
        int(layer), int(window), Bq, T, Hq, Hq // Hkv, n_per, ps, P, Ts, Dq,
        da.rounded_scale(Dq**-0.5, q.dtype), *splits, _build.dtype_code(q),
        _build.stream_ptr(q.device))
    _check(lib, "segment_attention", rc)
    return out


def _old_matmul_plan(M, K, N, w, sms):
    """The plan of #14's earlier build (a K split over blocks adding fp32
    partials in a second kernel): (sum rows, columns per lane, splits, K
    rows per split)."""
    mt = next(t for t in (1, 4, 8, 16, 32) if M <= t)
    cpt = min(16 // w.element_size(), 32 // mt)
    if N % cpt or w.data_ptr() % (cpt * w.element_size()):
        cpt = 1
    tiles = -(-N // (32 * cpt))
    splits = max(1, min(2 * sms // tiles, K // 128))
    k_split = -(-K // splits)
    return mt, cpt, -(-K // k_split), k_split


def baseline_decode_matmul(lib, x, w, scale, partial=None):
    """The baseline #14 launch at 4 rows (bf16 out), marshalled as its
    wrapper did; an earlier build's K splits write into ``partial``."""
    if lib.current["decode_matmul"]:
        with baseline_library({"decode_matmul": lib}):
            return dm.decode_matmul(x, w, scale)
    M, K = x.shape
    N = w.shape[1]
    mt, cpt, splits, k_split = _old_matmul_plan(M, K, N, w, _build.sm_count(0))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = lib.uv_decode_matmul(
        _build.ptr(x), x.stride(0), _build.dtype_code(x), _build.ptr(w), dm.W_CODES[w.dtype],
        _build.ptr(scale), -1 if scale is None else _build.dtype_code(scale), _build.ptr(out),
        _build.dtype_code(out), _build.ptr(partial if splits > 1 else None), M, K, N, mt, cpt,
        splits, k_split, _build.stream_ptr(x.device))
    _check(lib, "decode_matmul", rc)
    return out


def baseline_layer_norm(lib, x, s32, b32):
    """The baseline #1 launch (fp32 scale and bias), as its wrapper did."""
    if lib.current["layer_norm"]:
        with baseline_library({"layer_norm": lib}):
            return ln.fused_layer_norm(x, s32, b32)
    out = torch.empty_like(x)
    D = x.shape[-1]
    rc = lib.uv_layer_norm(
        _build.ptr(x), _build.ptr(s32), _build.ptr(b32), _build.ptr(out),
        ctypes.c_longlong(x.numel() // D), D, ctypes.c_float(1e-5), _build.dtype_code(x),
        _build.stream_ptr(x.device))
    _check(lib, "layer_norm", rc)
    return out


@contextlib.contextmanager
def forced_splits(ns):
    """#8, #9, #11 and #12 launch clusters of ``ns`` blocks while this is
    open."""
    current = da.kv_splits
    da.kv_splits = sa.kv_splits = pa.kv_splits = lambda n_keys: ns
    try:
        yield
    finally:
        da.kv_splits = sa.kv_splits = pa.kv_splits = current


@contextlib.contextmanager
def baseline_library(libs):
    """The wrappers of the unchanged interfaces (#14, #1) launch the
    baseline's build while this is open."""
    current = _build.library
    _build.library = lambda name: libs.get(name) or current(name)
    try:
        yield
    finally:
        _build.library = current


@contextlib.contextmanager
def forced(name, **kw):
    """fa.<name> (a plan) called with ``kw`` while this is open."""
    plan = getattr(fa, name)
    setattr(fa, name, functools.partial(plan, **kw))
    try:
        yield
    finally:
        setattr(fa, name, plan)


def time_ms(fn, iters: int = 50, warmup: int = 5, queued: bool = True) -> float:
    """Mean card ms per call between CUDA events, the calls queued ahead
    while the card sleeps (``queued=False``: not, so the time includes the
    host's dispatch whenever that is the slower side)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(base_fn, cur_fn) -> dict:
    """baseline, current, current, baseline; the mean of each pair."""
    b1, c1, c2, b2 = time_ms(base_fn), time_ms(cur_fn), time_ms(cur_fn), time_ms(base_fn)
    return {"baseline_ms": (b1 + b2) / 2, "ms": (c1 + c2) / 2, "turns_ms": [b1, c1, c2, b2]}


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _tol(ref) -> float:
    return 4 * 2.0**-8 * float(ref.abs().max())


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _ints(dev, *v):
    return torch.tensor(v, dtype=torch.int32, device=dev)


def kv_pin_inputs(dev, dtype, libs=None):
    """#8's and #11's inputs for the digest pin, from numpy seed 3: 3 rows
    of 1, 37 and 100 keys in a 128-slot slab, GQA 4, head_dim 64, window 20;
    #11 with T = 2, an 8-slot tail, written 0/3/5, layer 1 of 2. Calls the
    current wrappers, or with ``libs`` the baseline's build."""
    rng = np.random.default_rng(3)
    S, Hkv, Dh, Hq = 128, 2, 64, 8
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)  # noqa: E731
    lens, written = _ints(dev, 1, 37, 100), _ints(dev, 0, 3, 5)
    q8, k, v = t(3, Hq, Dh), t(3, S, Hkv, Dh), t(3, S, Hkv, Dh)
    q11, kc, vc, tk, tv = t(3, 2, Hq, Dh), t(2, 3, S, Hkv, Dh), t(2, 3, S, Hkv, Dh), \
        t(3, 8, Hkv, Dh), t(3, 8, Hkv, Dh)
    if libs is None:
        return {
            "decode_attention": lambda: da.decode_attention(q8, k, v, lens, 20),
            "segment_tail_attention": lambda: sa.segment_tail_attention(
                q11, kc, vc, 1, lens, tk, tv, written, 20),
        }
    return {
        "decode_attention": lambda: baseline_decode(libs["decode_attention"], q8, k, v, lens, 20),
        "segment_tail_attention": lambda: baseline_segment(
            libs["segment_attention"], q11, kc, vc, 1, lens, tk, tv, written, 20),
    }


def kv_pin_digests(dev, libs=None) -> dict:
    """sha256 (first 16 hex digits) of #8's and #11's output bytes on
    ``kv_pin_inputs``, bf16 and fp32 (the baseline's with ``libs``)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, fn in kv_pin_inputs(dev, dtype, libs).items():
            o = fn()
            torch.cuda.synchronize()
            raw = o.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).cpu().numpy()
            out[f"{name} {str(dtype)[6:]}"] = hashlib.sha256(raw.tobytes()).hexdigest()[:16]
    return out


# lengths at the page (16, 48, 256), granule (16 keys) and split (32 keys a
# block) edges, a row of length 0, the pageless row of length 1 and a long
# row, for the paged instances of the split KV kernel (#9, #12)
PAGED_EDGE_LENS = (0, 1, 15, 16, 17, 47, 48, 49, 255, 256, 257, 1900)


def seen_pool_slots(table, lens, lo, ps, P):
    """(P, ps) bool: the pool slots some row reads, keys [lo_b, n_b) through
    the clamped table."""
    seen = torch.zeros((P, ps), dtype=torch.bool, device=table.device)
    for b, (n, l0) in enumerate(zip(lens.tolist(), lo)):
        j = torch.arange(max(l0, 0), n, device=table.device)
        seen[table[b, j // ps].long().clamp(0, P - 1), j % ps] = True
    return seen


def paged_edge_inputs(dev, dtype, D, G, ps, window=0, T=None, Ts=32, seed=0, Hkv=2, L=2):
    """One row per PAGED_EDGE_LENS length in a 2-layer pool of pages of
    ``ps``: each row's pages at shuffled ids, 3 spare pages, rows of length 0
    and 1 own no page (every entry the sentinel P), later entries the
    sentinel; n_per = ceil(1920 / ps). Returns q ((B, H, D), or (B, T, H, D)
    with a Ts-slot tail whose row i has (7 i) mod (Ts - T + 1) slots
    written), kp, vp, table, lens, and ``hidden``: the (P, ps) pool slots of
    layer 1 no query reads at ``window``; with T also tk, tv, written and
    ``hidden_tail``: the (B, Ts) tail slots no query of the row sees."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    B, n_per = len(PAGED_EDGE_LENS), -(-1920 // ps)
    used = [-(-n // ps) if n > 1 else 0 for n in PAGED_EDGE_LENS]
    P = sum(used) + 3
    order = np.random.default_rng(seed).permutation(P).tolist()
    table = np.full((B, n_per), P, np.int32)
    for b, u in enumerate(used):
        for i in range(u):
            table[b, i] = order.pop()
    table = torch.from_numpy(table).to(dev)
    lens = torch.tensor(PAGED_EDGE_LENS, dtype=torch.int32, device=dev)
    out = {"kp": r(L, P, ps, Hkv, D), "vp": r(L, P, ps, Hkv, D), "table": table, "lens": lens}
    if T is None:
        out["q"] = r(B, Hkv * G, D)
        lo = [n - window if window else 0 for n in PAGED_EDGE_LENS]
    else:
        written = [(7 * i) % (Ts - T + 1) for i in range(B)]
        wr = torch.tensor(written, dtype=torch.int32, device=dev)
        t = torch.arange(T, device=dev)[None, :, None]
        slot = torch.arange(Ts, device=dev)
        ok_t = slot <= wr.long()[:, None, None] + t
        if window:
            ok_t = ok_t & (wr.long()[:, None, None] + t - slot < window)
        out.update(q=r(B, T, Hkv * G, D), tk=r(B, Ts, Hkv, D), tv=r(B, Ts, Hkv, D), written=wr,
                   hidden_tail=~ok_t.any(1))
        lo = [n + x - window + 1 if window else 0 for n, x in zip(PAGED_EDGE_LENS, written)]
    out["hidden"] = ~seen_pool_slots(table, lens, lo, ps, P)
    return out


def _decode_case(dev, g, S, lens):
    bf = torch.bfloat16
    q = torch.randn((B, H, D), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, HKV, D), generator=g, device=dev).to(bf)
    v = torch.randn((B, S, HKV, D), generator=g, device=dev).to(bf)
    lens = _ints(dev, *lens)
    visible = torch.arange(S, device=dev)[None] < lens[:, None].long()
    keys = int(visible.sum())
    return {
        "current": lambda: da.decode_attention(q, k, v, lens),
        "plain": lambda: da.decode_attention_plain(q, k, v, lens, scale=D**-0.5),
        "baseline": lambda libs: baseline_decode(libs["decode_attention"], q, k, v, lens),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=visible[:, None, None], enable_gqa=True),
        "bytes": _nbytes(q, q, lens) + 2 * keys * HKV * D * 2, "flops": 4.0 * H * keys * D,
    }


def _segment_case(dev, g, S, Ts, lens, written):
    bf = torch.bfloat16
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    kc = torch.randn((L, B, S, HKV, D), generator=g, device=dev).to(bf)
    vc = torch.randn((L, B, S, HKV, D), generator=g, device=dev).to(bf)
    tk = torch.randn((B, Ts, HKV, D), generator=g, device=dev).to(bf)
    tv = torch.randn((B, Ts, HKV, D), generator=g, device=dev).to(bf)
    lens, written = _ints(dev, *lens), _ints(dev, *written)
    ok_p = torch.arange(S, device=dev)[None] < lens[:, None].long()
    ok_t = torch.arange(Ts, device=dev)[None] <= written[:, None].long()
    keys = int(ok_p.sum() + ok_t.sum())
    mask = torch.cat([ok_p, ok_t], dim=-1)[:, None, None]
    k_cat = torch.cat([kc[LAYER], tk], dim=1).transpose(1, 2)
    v_cat = torch.cat([vc[LAYER], tv], dim=1).transpose(1, 2)
    return {
        "current": lambda: sa.segment_tail_attention(q, kc, vc, LAYER, lens, tk, tv, written),
        "plain": lambda: sa.segment_tail_attention_plain(q, kc, vc, LAYER, lens, tk, tv, written,
                                                         scale=D**-0.5),
        "baseline": lambda libs: baseline_segment(libs["segment_attention"], q, kc, vc, LAYER,
                                                  lens, tk, tv, written),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k_cat, v_cat, attn_mask=mask, enable_gqa=True),
        "bytes": _nbytes(q, q, lens, written) + 2 * keys * HKV * D * 2,
        "flops": 4.0 * H * keys * D,
    }


def _paged_case(dev, g, name):
    """#9 or #12 at serving run (a)'s shapes: layer 7 of a 16-layer pool of
    32 pages of 256, one shuffled page per row (129-190 keys) and 7
    sentinel entries; #12 with an 8-slot tail, written 0/3/5/7."""
    bf = torch.bfloat16
    P, ps = 32, 256
    order = np.random.default_rng(0).permutation(P)
    table = np.full((B, 2048 // ps), P, np.int32)
    table[:, 0] = order[:B]
    table = torch.from_numpy(table).to(dev)
    lens = _ints(dev, *SERVING_LENS)
    kp = torch.randn((L, P, ps, HKV, D), generator=g, device=dev).to(bf)
    vp = torch.randn((L, P, ps, HKV, D), generator=g, device=dev).to(bf)
    keys = sum(SERVING_LENS)
    if name == "paged_decode_attention":
        q = torch.randn((B, H, D), generator=g, device=dev).to(bf)
        return {
            "current": lambda: pa.paged_decode_attention(q, kp[LAYER], vp[LAYER], table, lens),
            "plain": lambda: pa.paged_decode_attention_plain(q, kp[LAYER], vp[LAYER], table, lens,
                                                             scale=D**-0.5),
            "baseline": lambda libs: baseline_paged_decode(
                libs["paged_attention"], q, kp[LAYER], vp[LAYER], table, lens),
            "bytes": _nbytes(q, q, lens, table) + 2 * keys * HKV * D * 2,
            "flops": 4.0 * H * keys * D,
        }
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    tk = torch.randn((B, 8, HKV, D), generator=g, device=dev).to(bf)
    tv = torch.randn((B, 8, HKV, D), generator=g, device=dev).to(bf)
    written = _ints(dev, *SERVING_WRITTEN)
    keys += sum(w + 1 for w in SERVING_WRITTEN)
    return {
        "current": lambda: sa.paged_segment_tail_attention(q, kp, vp, LAYER, table, lens, tk, tv,
                                                           written),
        "plain": lambda: sa.paged_segment_tail_attention_plain(q, kp, vp, LAYER, table, lens, tk,
                                                               tv, written, scale=D**-0.5),
        "baseline": lambda libs: baseline_paged_segment(
            libs["segment_attention"], q, kp, vp, LAYER, table, lens, tk, tv, written),
        "bytes": _nbytes(q, q, lens, written, table) + 2 * keys * HKV * D * 2,
        "flops": 4.0 * H * keys * D,
    }


def _rotating(t, n_bytes=2 * L2_BYTES):
    """t and copies of it, at least ``n_bytes`` in all, to call in turn: no
    call finds its weight in L2, as a decode step does not."""
    copies = [t] + [t.clone() for _ in range(-(-n_bytes // _nbytes(t)) - 1)]
    return itertools.cycle(copies).__next__, copies


def _int8pack(x4, w_t, sc):
    """torch._weight_int8pack_mm on the card, or the error it raises."""
    try:
        out = torch._weight_int8pack_mm(x4, w_t, sc)
        torch.cuda.synchronize()
        return out, None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def compare_decode_matmul(libs, dev, g, sweep: bool) -> dict:
    """#14 at 4 rows on every decoder product, bf16 and int8 + scale."""
    bf = torch.bfloat16
    lib = libs["decode_matmul"]
    rows = {}
    for name, (K, N) in DECODE_PRODUCTS.items():
        w32 = 0.02 * torch.randn((K, N), generator=g, device=dev)
        scale = (w32.abs().amax(dim=0) / 127).to(bf)
        weights = {"bf16": (w32.to(bf), None),
                   "int8": (torch.round(w32 / scale.float()).clamp(-127, 127).to(torch.int8),
                            scale)}
        del w32
        x4 = torch.randn((4, K), generator=g, device=dev).to(bf)
        for kind, (wk, sc) in weights.items():
            label = f"decode_matmul {name} {kind}"
            nxt, copies = _rotating(wk)
            partial = torch.empty((max(1, 2 * _build.sm_count(0)), 4, N), dtype=torch.float32,
                                  device=dev)
            out, again = dm.decode_matmul(x4, wk, sc), dm.decode_matmul(x4, wk, sc)
            ref = dm.decode_matmul_plain(x4, wk, sc)
            base = baseline_decode_matmul(lib, x4, wk, sc, partial)
            torch.cuda.synchronize()
            row = {"max_abs_err": _err(out, ref), "tol": _tol(ref),
                   "baseline_err": _err(base, ref), "bit_equal": torch.equal(out, again)}
            if not (row["max_abs_err"] <= row["tol"] and row["baseline_err"] <= row["tol"]
                    and row["bit_equal"]):
                raise RuntimeError(f"{label}: {row}")
            row.update(in_turns(lambda: baseline_decode_matmul(lib, x4, nxt(), sc, partial),
                                lambda: dm.decode_matmul(x4, nxt(), sc)))
            w_bf = wk if sc is None else (wk.to(bf) * sc).to(bf)
            nxt_bf, bf_copies = _rotating(w_bf)
            row["torch_mm_ms"] = time_ms(lambda: torch.mm(x4, nxt_bf()))
            del bf_copies
            row["bound_ms"] = (_nbytes(x4, wk) + 4 * N * 2 + (_nbytes(sc) if sc is not None
                                                               else 0)) / HBM_BYTES_PER_S * 1e3
            row["speedup"] = row["baseline_ms"] / row["ms"]
            row["factor_to_torch_mm"] = row["ms"] / row["torch_mm_ms"]
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["plan"] = dm._plan(4, K, N, wk.element_size(), wk.data_ptr(), True,
                                   _build.sm_count(0))._asdict()
            if sc is not None:
                w_t = wk.t().contiguous()  # (N, K), once, outside the timing
                lib_out, err = _int8pack(x4, w_t, sc)
                row["int8pack_error"] = err
                if lib_out is not None:
                    row["int8pack_err"] = _err(lib_out, ref)
                    nxt_t, t_copies = _rotating(w_t)
                    row["int8pack_ms"] = time_ms(lambda: torch._weight_int8pack_mm(
                        x4, nxt_t(), sc))
                    del t_copies
                del w_t
            if sweep:  # the plan's other choices, each forced in turn
                plan = dm._plan
                forced = {f"cluster {cs}": {"cluster": cs} for cs in (1, 2, 4, 8)}
                forced.update({f"warps_n {wn}": {"cluster": row["plan"]["cluster"],
                                                 "warps_n": wn} for wn in (1, 4)})
                row["forced_ms"] = {}
                for key, kw in forced.items():
                    dm._plan = functools.partial(plan, **kw)
                    try:
                        if _err(dm.decode_matmul(x4, wk, sc), ref) > row["tol"]:
                            raise RuntimeError(f"{label} with {key}")
                        row["forced_ms"][key] = time_ms(lambda: dm.decode_matmul(x4, nxt(), sc))
                    finally:
                        dm._plan = plan
            del copies, partial
            rows[label] = row
            print(f"{label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
                  f"{row['speedup']:.2f}x; torch.mm on the bf16 weight {row['torch_mm_ms']:.4f}, "
                  f"{row['factor_to_torch_mm']:.2f}x; bound {row['bound_ms']:.5f}, "
                  f"{100 * row['share_of_bound']:.1f}%); turns {row['turns_ms']}; "
                  f"int8pack {row.get('int8pack_ms', row.get('int8pack_error'))}; "
                  f"forced {row.get('forced_ms')}; plan {row['plan']}", flush=True)
    if sweep:
        rows["launch floor"] = _matmul_floor(dev, g)
    return rows


def _matmul_floor(dev, g) -> dict:
    """What a call costs with almost no bytes: #14 at (4, 128) x (128, 64)
    bf16 as one block (a plain launch) and as a cluster of two, torch.mm on
    the same, and one tiny kernel (add_ on one element)."""
    bf = torch.bfloat16
    x = torch.randn((4, 128), generator=g, device=dev).to(bf)
    w = torch.randn((128, 64), generator=g, device=dev).to(bf)
    one = torch.zeros(1, device=dev)
    row = {"torch_mm_ms": time_ms(lambda: torch.mm(x, w)),
           "add_ms": time_ms(lambda: one.add_(1))}
    plan = dm._plan
    for cs in (1, 2):
        dm._plan = functools.partial(plan, cluster=cs)
        try:
            row[f"cluster_{cs}_ms"] = time_ms(lambda: dm.decode_matmul(x, w))
        finally:
            dm._plan = plan
    print(f"decode_matmul launch floor: {row}", flush=True)
    return row


def compare_layer_norm(libs, dev, g) -> dict:
    """#1 at the encoder's shapes, beside F.layer_norm."""
    lib = libs["layer_norm"]
    rows = {}
    for label, (shape, dtype) in LN_SHAPES.items():
        D = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
        b = 0.1 * torch.randn((D,), generator=g, device=dev)
        s_x, b_x = s.to(dtype), b.to(dtype)
        out, again = ln.fused_layer_norm(x, s, b), ln.fused_layer_norm(x, s, b)
        ref = ln.layer_norm_plain(x, s, b)
        base = baseline_layer_norm(lib, x, s, b)
        torch.cuda.synchronize()
        tol = _tol(ref) if dtype == torch.bfloat16 else 1e-5
        row = {"max_abs_err": _err(out, ref), "tol": tol, "baseline_err": _err(base, ref),
               "bit_equal": torch.equal(out, again)}
        if not (row["max_abs_err"] <= tol and row["baseline_err"] <= tol and row["bit_equal"]):
            raise RuntimeError(f"fused_layer_norm {label}: {row}")
        row.update(in_turns(lambda: baseline_layer_norm(lib, x, s, b),
                            lambda: ln.fused_layer_norm(x, s, b)))
        row["f_layer_norm_ms"] = time_ms(lambda: F.layer_norm(x, (D,), s_x, b_x, 1e-5))
        row["bound_ms"] = _nbytes(x, s, b, out) / HBM_BYTES_PER_S * 1e3
        row["speedup"] = row["baseline_ms"] / row["ms"]
        row["factor_to_library"] = row["ms"] / row["f_layer_norm_ms"]
        rows[f"fused_layer_norm {label}"] = row
        print(f"fused_layer_norm {label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
              f"{row['speedup']:.2f}x; F.layer_norm {row['f_layer_norm_ms']:.4f}, "
              f"{row['factor_to_library']:.2f}x; bound {row['bound_ms']:.5f}); "
              f"turns {row['turns_ms']}; err {row['max_abs_err']:.3g} (tol {tol:.3g})", flush=True)
    return rows


def baseline_ln_qkv_head(lib, x, s32, b32, w, b, Dh):
    """The baseline #2 launch (uv_ln_qkv_head, one signature throughout)."""
    B, T, D = x.shape
    C = w.shape[1]
    out = torch.empty((B, C // Dh, T, Dh), dtype=x.dtype, device=x.device)
    rc = lib.uv_ln_qkv_head(
        _build.ptr(x), _build.ptr(s32), _build.ptr(b32), _build.ptr(w), _build.ptr(b),
        _build.ptr(out), B, T, D, C, Dh, 1e-5, _build.dtype_code(x), _build.stream_ptr(x.device))
    _check(lib, "ln_qkv_head", rc)
    return out


def _ln_qkv_inputs(dev, g, B, T, D, C, dtype):
    x = torch.randn((B, T, D), generator=g, device=dev).to(dtype)
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    b = 0.1 * torch.randn((D,), generator=g, device=dev)
    w = (0.02 * torch.randn((D, C), generator=g, device=dev)).to(dtype)
    wb = (0.02 * torch.randn((C,), generator=g, device=dev)).to(dtype)
    return x, s, b, w, wb


def ln_qkv_chain(x, s, b, w, wb, Dh):
    """The unfused form in four PyTorch calls (bf16 LN scale and bias)."""
    B, T, D = x.shape
    h = F.layer_norm(x, (D,), s, b, 1e-5)
    qkv = torch.mm(h.view(B * T, D), w) + wb
    return qkv.view(B, T, -1, Dh).transpose(1, 2).contiguous()


def compare_ln_qkv_head(libs, dev, g, sweep: bool) -> dict:
    """#2 against the baseline at the encoder's shapes, beside torch.mm and
    the unfused chain, and bit-equal to the baseline's own tensor-core
    route where the baseline has one; then fp32 and an unaligned view
    bit-equal to the baseline's build."""
    lib, Dh, bf = libs["ln_qkv_head"], LN_QKV_HEAD_DIM, torch.bfloat16
    rows = {}
    for label, (B, T, D, C) in LN_QKV_SHAPES.items():
        x, s, b, w, wb = _ln_qkv_inputs(dev, g, B, T, D, C, bf)
        cur = lambda: fa.ln_qkv_head_fused(x, s, b, w, wb, Dh)  # noqa: E731
        base = lambda: baseline_ln_qkv_head(lib, x, s, b, w, wb, Dh)  # noqa: E731
        out, again, ref, old = cur(), cur(), fa.ln_qkv_head_plain(x, s, b, w, wb, Dh), base()
        torch.cuda.synchronize()
        row = {"max_abs_err": _err(out, ref), "tol": _tol(ref), "baseline_err": _err(old, ref),
               "bit_equal": torch.equal(out, again),
               "plan": fa._plan(True, B * T, D, C, Dh, [0])._asdict()}
        if lib.current.get("ln_qkv_head_mma"):
            with baseline_library({"ln_qkv_head": lib}):
                row["bit_equal_to_baseline_mma"] = torch.equal(cur(), out)
        if not (row["max_abs_err"] <= row["tol"] and row["baseline_err"] <= row["tol"]
                and row["bit_equal"] and row.get("bit_equal_to_baseline_mma", True)):
            raise RuntimeError(f"ln_qkv_head_fused {label}: {row}")
        row.update(in_turns(base, cur))
        h = fa._layer_norm_rounded(x, s, b, 1e-5).view(B * T, D)
        s_bf, b_bf = s.to(bf), b.to(bf)
        row["torch_mm_ms"] = time_ms(lambda: torch.mm(h, w))
        row["chain_ms"] = time_ms(lambda: ln_qkv_chain(x, s_bf, b_bf, w, wb, Dh))
        row["bound_ms"] = max(_nbytes(x, s, b, w, wb, out) / HBM_BYTES_PER_S,
                              2.0 * B * T * D * C / BF16_FLOPS) * 1e3
        row["speedup"] = row["baseline_ms"] / row["ms"]
        if sweep:
            row["tiles_ms"] = {}
            for bm in fa.MMA_ROWS:
                if fa.mma_smem_bytes(bm, D) > fa.MAX_SMEM:
                    continue
                with forced("_plan", bm=bm):
                    if _err(cur(), ref) > row["tol"]:
                        raise RuntimeError(f"ln_qkv_head_fused {label} with {bm}-row tiles")
                    row["tiles_ms"][f"{bm}x{fa.MMA_BN}"] = time_ms(cur)
        rows[f"ln_qkv_head_fused {label}"] = row
        print(f"ln_qkv_head_fused {label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
              f"{row['speedup']:.2f}x; torch.mm {row['torch_mm_ms']:.4f}, chain "
              f"{row['chain_ms']:.4f}; bound {row['bound_ms']:.5f}); turns {row['turns_ms']}; "
              f"err {row['max_abs_err']:.3g} (tol {row['tol']:.3g}); plan {row['plan']}; "
              f"tiles {row.get('tiles_ms')}", flush=True)
    rows["unchanged routes"] = _unchanged_routes(libs, dev, g)
    return rows


def _unchanged_routes(libs, dev, g) -> dict:
    """fp32 and an unaligned bf16 view of #2 (its CUDA-core kernel):
    bit-equal to the baseline's build, and timed."""
    Dh, out = LN_QKV_HEAD_DIM, {}
    B, T, D = 4, 500, 768
    lib2 = libs["ln_qkv_head"]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        x, s, b, w, wb = _ln_qkv_inputs(dev, g, B, T, D, 3 * D, dtype)
        if dtype == torch.bfloat16:  # one element off its storage: the CUDA-core route
            base = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            x = base[1:].view(B, T, D).copy_(x)
            name = "bfloat16 unaligned"
        out[f"ln_qkv_head {name}"] = _bit_equal_route(
            f"ln_qkv_head {name}", lambda: fa.ln_qkv_head_fused(x, s, b, w, wb, Dh),
            lambda: baseline_ln_qkv_head(lib2, x, s, b, w, wb, Dh))
    return out


def _bit_equal_route(label, cur, old) -> dict:
    """A route that must not have moved: bit-equal to the baseline's build
    (raises otherwise), then both timed in turns."""
    got, want = cur(), old()
    torch.cuda.synchronize()
    row = {"bit_equal_to_baseline": torch.equal(got, want)}
    if not row["bit_equal_to_baseline"]:
        raise RuntimeError(f"{label} differs from the baseline's build by {_err(got, want)}")
    row.update(in_turns(old, cur))
    print(f"{label}: bit-equal to the baseline; {row['ms']:.4f} ms (baseline "
          f"{row['baseline_ms']:.4f})", flush=True)
    return row


def baseline_ln_matmul_gelu(lib, x, s32, b32, w, b):
    """The baseline #6 launch (uv_ln_matmul_gelu, one signature throughout)."""
    B, T, D = x.shape
    F = w.shape[1]
    out = torch.empty((B, T, F), dtype=x.dtype, device=x.device)
    _check(lib, "ln_matmul_gelu", lib.uv_ln_matmul_gelu(
        _build.ptr(x), _build.ptr(s32), _build.ptr(b32), _build.ptr(w), _build.ptr(b),
        _build.ptr(out), B * T, D, F, 1e-5, _build.dtype_code(x), _build.stream_ptr(x.device)))
    return out


def gelu_chain(x, s, b, w, wb):
    """The unfused form in three PyTorch calls (bf16 LN scale and bias)."""
    D = x.shape[-1]
    h = F.layer_norm(x, (D,), s, b, 1e-5).view(-1, D)
    return F.gelu(torch.addmm(wb, h, w), approximate="tanh").view(*x.shape[:-1], -1)


def compare_ln_matmul_gelu(libs, dev, g, sweep: bool) -> dict:
    """#6 against the baseline at the encoder's fc1 and whisper-large's FFN:
    the bf16 tensor-core route within 4 bf16 ulps of the plain version and
    of the baseline, two calls bit-equal, times in turns, beside its bound,
    torch.mm on the LN'd rows and the three-call chain; with ``sweep``, each
    tile that fits at each count of column tiles a block runs. Then fp32
    and a bf16 view one element off its storage (the CUDA-core kernel)
    bit-equal to the baseline's build."""
    lib, bf, rows = libs["ln_matmul_gelu"], torch.bfloat16, {}
    for label, (B, T, D, Fd) in GELU_SHAPES.items():
        x, s, b, w, wb = _ln_qkv_inputs(dev, g, B, T, D, Fd, bf)
        cur = lambda: fa.ln_matmul_gelu(x, s, b, w, wb)  # noqa: E731
        base = lambda: baseline_ln_matmul_gelu(lib, x, s, b, w, wb)  # noqa: E731
        out, again, ref, old = cur(), cur(), fa.ln_matmul_gelu_plain(x, s, b, w, wb), base()
        torch.cuda.synchronize()
        row = {"max_abs_err": _err(out, ref), "tol": _tol(ref), "baseline_err": _err(old, ref),
               "vs_baseline": _err(out, old), "bit_equal": torch.equal(out, again),
               "plan": fa._gelu_plan(True, B * T, D, Fd, [0], _build.sm_count(0))._asdict()}
        if lib.current.get("ln_matmul_gelu_mma"):
            with baseline_library({"ln_matmul_gelu": lib}):
                row["bit_equal_to_baseline_mma"] = torch.equal(cur(), out)
        if not (row["max_abs_err"] <= row["tol"] and row["baseline_err"] <= row["tol"]
                and row["vs_baseline"] <= row["tol"] and row["bit_equal"]
                and row.get("bit_equal_to_baseline_mma", True)):
            raise RuntimeError(f"ln_matmul_gelu {label}: {row}")
        row.update(in_turns(base, cur))
        row["wrapper_ms"] = time_ms(cur, queued=False)
        h = fa._layer_norm_rounded(x, s, b, 1e-5).view(B * T, D)
        s_bf, b_bf = s.to(bf), b.to(bf)
        row["torch_mm_ms"] = time_ms(lambda: torch.mm(h, w))
        row["chain_ms"] = time_ms(lambda: gelu_chain(x, s_bf, b_bf, w, wb))
        row["bound_ms"] = max(_nbytes(x, s, b, w, wb, out) / HBM_BYTES_PER_S,
                              2.0 * B * T * D * Fd / BF16_FLOPS) * 1e3
        row["speedup"] = row["baseline_ms"] / row["ms"]
        if sweep:
            row["tiles_ms"] = {}
            for bm in fa.MMA_ROWS:
                if fa.mma_smem_bytes(bm, D) > fa.MAX_SMEM:
                    continue
                for k in GELU_TILES:
                    with forced("_gelu_plan", bm=bm, tiles=k):
                        if _err(cur(), ref) > row["tol"]:
                            raise RuntimeError(f"ln_matmul_gelu {label}, {bm} rows x {k} tiles")
                        row["tiles_ms"][f"{bm}x{fa.MMA_BN} k{k}"] = time_ms(cur)
        rows[f"ln_matmul_gelu {label}"] = row
        print(f"ln_matmul_gelu {label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
              f"{row['speedup']:.2f}x; with dispatch {row['wrapper_ms']:.4f}; torch.mm "
              f"{row['torch_mm_ms']:.4f}, chain {row['chain_ms']:.4f}; bound "
              f"{row['bound_ms']:.5f}); turns {row['turns_ms']}; err {row['max_abs_err']:.3g} "
              f"(tol {row['tol']:.3g}), vs baseline {row['vs_baseline']:.3g}; plan "
              f"{row['plan']}; tiles {row.get('tiles_ms')}", flush=True)
    B, T, D, Fd = GELU_SHAPES["fc1 (4,500,768)"]
    for name, dtype, offset in (("fp32", torch.float32, 0), ("bfloat16 unaligned", bf, 1)):
        x, s, b, w, wb = _ln_qkv_inputs(dev, g, B, T, D, Fd, dtype)
        if offset:  # one element off its storage: the CUDA-core route
            x = torch.empty(x.numel() + offset, dtype=dtype, device=dev)[offset:].view(
                B, T, D).copy_(x)
        rows[f"ln_matmul_gelu {name}"] = _bit_equal_route(
            f"ln_matmul_gelu {name}", lambda: fa.ln_matmul_gelu(x, s, b, w, wb),
            lambda: baseline_ln_matmul_gelu(lib, x, s, b, w, wb))
    return rows


def _out_proj_inputs(dev, g, B, H, T, Dh, M, dtype, offset=0):
    """attn (B, H, T, Dh) starting ``offset`` elements into its storage, W
    (H, Dh, M), bias (M,), x_res (B, T, M)."""
    attn = torch.randn((B * H * T * Dh + offset,), generator=g, device=dev).to(dtype)
    attn = attn[offset:].view(B, H, T, Dh)
    w = (0.05 * torch.randn((H, Dh, M), generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn((M,), generator=g, device=dev)).to(dtype)
    x = torch.randn((B, T, M), generator=g, device=dev).to(dtype)
    return attn, w, b, x


def baseline_out_proj(lib, attn, w, b, x):
    """The baseline #7 launch (uv_attn_out_proj, one signature throughout)."""
    B, H, T, Dh = attn.shape
    out = torch.empty_like(x)
    _check(lib, "attn_out_proj", lib.uv_attn_out_proj(
        _build.ptr(attn), _build.ptr(w), _build.ptr(b), _build.ptr(x), _build.ptr(out), B, H, T,
        Dh, w.shape[-1], _build.dtype_code(x), _build.stream_ptr(x.device)))
    return out


def out_proj_chain(attn, w, b, x):
    """The unfused form in three PyTorch calls: the heads concatenated (a
    copy), the product with the bias, the residual added in place."""
    B, H, T, Dh = attn.shape
    rows = attn.transpose(1, 2).reshape(B * T, H * Dh)
    return torch.addmm(b, rows, w.view(H * Dh, -1)).view_as(x).add_(x)


def compare_out_proj(libs, dev, g, sweep: bool) -> dict:
    """#7 against the baseline at OUT_PROJ_SHAPES: the bf16 tensor-core
    route within 4 bf16 ulps of the plain version and of the baseline, two
    calls bit-equal, times in turns, beside its bound, the plain version,
    torch.mm on the concatenated heads and the three-call chain; with
    ``sweep``, every tile that fits at every count of column tiles (each
    within 4 ulps, and whether bit-equal to the plan's). Then fp32 and a
    bf16 view one element off its storage (the CUDA-core kernel) bit-equal
    to the baseline's build."""
    lib, bf, rows = libs["attn_out_proj"], torch.bfloat16, {}
    sms = _build.sm_count(0)
    for label, (B, H, T, Dh, M) in OUT_PROJ_SHAPES.items():
        a, w, b, x = _out_proj_inputs(dev, g, B, H, T, Dh, M, bf)
        cur = lambda: fa.attn_out_proj_residual(a, w, b, x)  # noqa: E731
        base = lambda: baseline_out_proj(lib, a, w, b, x)  # noqa: E731
        out, again, ref, old = cur(), cur(), fa.attn_out_proj_residual_plain(a, w, b, x), base()
        torch.cuda.synchronize()
        row = {"max_abs_err": _err(out, ref), "tol": _tol(ref), "baseline_err": _err(old, ref),
               "vs_baseline": _err(out, old), "bit_equal": torch.equal(out, again),
               "plan": fa._out_proj_plan(True, B * T, H, Dh, M, [0], sms)._asdict()}
        if not (row["max_abs_err"] <= row["tol"] and row["baseline_err"] <= row["tol"]
                and row["vs_baseline"] <= row["tol"] and row["bit_equal"]):
            raise RuntimeError(f"attn_out_proj_residual {label}: {row}")
        row.update(in_turns(base, cur))
        row["wrapper_ms"] = time_ms(cur, queued=False)
        row["plain_ms"] = time_ms(lambda: fa.attn_out_proj_residual_plain(a, w, b, x))
        heads = a.transpose(1, 2).reshape(B * T, H * Dh)
        w2 = w.view(H * Dh, M)
        row["torch_mm_ms"] = time_ms(lambda: torch.mm(heads, w2))
        row["chain_ms"] = time_ms(lambda: out_proj_chain(a, w, b, x))
        row["bound_ms"] = max(_nbytes(a, w, b, x, out) / HBM_BYTES_PER_S,
                              2.0 * B * T * H * Dh * M / BF16_FLOPS) * 1e3
        row["speedup"] = row["baseline_ms"] / row["ms"]
        if sweep:
            row["tiles_ms"], row["tiles_bit_equal"] = {}, {}
            for bm in fa.MMA_ROWS:
                if fa.mma_smem_bytes(bm, H * Dh, ln=False) > fa.MAX_SMEM:
                    continue
                for k in range(1, -(-M // fa.MMA_BN) + 1):
                    with forced("_out_proj_plan", bm=bm, tiles=k):
                        got = cur()
                        if _err(got, ref) > row["tol"]:
                            raise RuntimeError(f"attn_out_proj_residual {label}, {bm} rows x "
                                               f"{k} tiles: {_err(got, ref)}")
                        key = f"{bm}x{fa.MMA_BN} k{k}"
                        row["tiles_bit_equal"][key] = torch.equal(got, out)
                        row["tiles_ms"][key] = time_ms(cur)
        rows[f"attn_out_proj_residual {label}"] = row
        print(f"attn_out_proj_residual {label}: {row['ms']:.4f} ms (baseline "
              f"{row['baseline_ms']:.4f}, {row['speedup']:.2f}x; with dispatch "
              f"{row['wrapper_ms']:.4f}; plain {row['plain_ms']:.4f}; torch.mm "
              f"{row['torch_mm_ms']:.4f}, chain {row['chain_ms']:.4f}; bound "
              f"{row['bound_ms']:.5f}); turns {row['turns_ms']}; err {row['max_abs_err']:.3g} "
              f"(tol {row['tol']:.3g}), vs baseline {row['vs_baseline']:.3g}; plan "
              f"{row['plan']}; tiles {row.get('tiles_ms')}; bit-equal to the plan's "
              f"{row.get('tiles_bit_equal')}", flush=True)
    B, H, T, Dh, M = OUT_PROJ_SHAPES["(4,12,500,64)x768"]
    for name, dtype, offset in (("fp32", torch.float32, 0), ("bfloat16 unaligned", bf, 1)):
        a, w, b, x = _out_proj_inputs(dev, g, B, H, T, Dh, M, dtype, offset)
        rows[f"attn_out_proj_residual {name}"] = _bit_equal_route(
            f"attn_out_proj_residual {name}", lambda: fa.attn_out_proj_residual(a, w, b, x),
            lambda: baseline_out_proj(lib, a, w, b, x))
    return rows


def baseline_transpose(lib, qkv, Dh):
    """The baseline #5 launch, marshalled as its wrapper did."""
    if lib.current["qkv_head_transpose"]:
        with baseline_library({"qkv_head_transpose": lib}):
            return fa.qkv_head_transpose(qkv, Dh)
    B, T, C = qkv.shape
    out = torch.empty((B, C // Dh, T, Dh), dtype=qkv.dtype, device=qkv.device)
    _check(lib, "qkv_head_transpose", lib.uv_qkv_head_transpose(
        _build.ptr(qkv), _build.ptr(out), B, T, C // Dh, Dh * qkv.element_size() // 16,
        _build.stream_ptr(qkv.device)))
    return out


def compare_transpose(libs, dev, g, sweep: bool) -> dict:
    """#5 against the baseline: bit-equal to the plain version and to the
    baseline (twice) at every shape of TRANSPOSE_TIMED and TRANSPOSE_EDGES;
    timed at TRANSPOSE_TIMED in turns on 32 inputs and outputs that rotate
    (the 50 MB L2 holds none of them when it is read again), beside its
    bound (one read and one write of every byte), the time with the host's
    dispatch and ``transpose(1, 2).contiguous()``; with ``sweep``, at each
    row count of TRANSPOSE_ROWS."""
    lib, rows = libs["qkv_head_transpose"], {}
    cases = {label: (shape, torch.bfloat16) for label, shape in TRANSPOSE_TIMED.items()}
    cases.update(TRANSPOSE_EDGES)
    for label, ((B, T, G, Dh), dtype) in cases.items():
        qkv = torch.randn((B, T, G * Dh), generator=g, device=dev).to(dtype)
        out, again = fa.qkv_head_transpose(qkv, Dh), fa.qkv_head_transpose(qkv, Dh)
        old, ref = baseline_transpose(lib, qkv, Dh), fa.qkv_head_transpose_plain(qkv, Dh)
        torch.cuda.synchronize()
        plan = fa._transpose_plan(B, T, G, Dh * qkv.element_size(), _build.sm_count(0))
        row = {"bit_equal": torch.equal(out, ref) and torch.equal(again, ref),
               "baseline_bit_equal": torch.equal(old, ref), "plan": plan._asdict()}
        if not (row["bit_equal"] and row["baseline_bit_equal"]):
            raise RuntimeError(f"qkv_head_transpose {label}: {row}")
        if label in TRANSPOSE_TIMED:
            inputs = [qkv] + [torch.randn_like(qkv) for _ in range(31)]
            nxt = itertools.cycle(inputs).__next__
            keep = collections.deque(maxlen=len(inputs)).append
            cur = lambda: keep(fa.qkv_head_transpose(nxt(), Dh))  # noqa: E731
            base = lambda: keep(baseline_transpose(lib, nxt(), Dh))  # noqa: E731
            for _ in inputs:  # the allocator holds every kept output before a timed call
                cur(), base()
            row.update(in_turns(base, cur))
            row["wrapper_ms"] = time_ms(cur, queued=False)
            row["library_ms"] = time_ms(
                lambda: keep(nxt().view(B, T, G, Dh).transpose(1, 2).contiguous()))
            row["bound_ms"] = _nbytes(qkv, out) / HBM_BYTES_PER_S * 1e3
            row["speedup"] = row["baseline_ms"] / row["ms"]
            if sweep:
                row["rows_ms"] = {}
                for r in TRANSPOSE_ROWS:
                    with forced("_transpose_plan", rows=r):
                        if not torch.equal(fa.qkv_head_transpose(qkv, Dh), ref):
                            raise RuntimeError(f"qkv_head_transpose {label} with {r} rows")
                        row["rows_ms"][r] = time_ms(cur)
            print(f"qkv_head_transpose {label}: {row['ms']:.4f} ms (baseline "
                  f"{row['baseline_ms']:.4f}, {row['speedup']:.2f}x; with dispatch "
                  f"{row['wrapper_ms']:.4f}; transpose(1,2).contiguous() {row['library_ms']:.4f}; "
                  f"bound {row['bound_ms']:.5f}); turns {row['turns_ms']}; plan {row['plan']}; "
                  f"rows {row.get('rows_ms')}", flush=True)
        else:
            print(f"qkv_head_transpose {label}: bit-equal to the plain version twice and to the "
                  f"baseline; plan {row['plan']}", flush=True)
        rows[f"qkv_head_transpose {label}"] = row
    return rows


def _time_against_baseline(libs, c, label, row_extra=None) -> dict:
    """A case's current kernel against its plain version and the baseline
    (4 bf16 ulps of the largest output), then both timed in turns, with the
    bound over the visible bytes."""
    out, ref, base = c["current"](), c["plain"](), c["baseline"](libs)
    torch.cuda.synchronize()
    row = {"max_abs_err": _err(out, ref), "tol": _tol(ref), "baseline_err": _err(base, ref),
           "vs_baseline": _err(out, base), "bit_equal_to_baseline": torch.equal(out, base)}
    if not (row["max_abs_err"] <= row["tol"] and row["baseline_err"] <= row["tol"]):
        raise RuntimeError(f"{label}: {row}")
    row.update(in_turns(lambda: c["baseline"](libs), c["current"]))
    row["bound_ms"] = max(c["bytes"] / HBM_BYTES_PER_S, c["flops"] / BF16_FLOPS) * 1e3
    row["speedup"] = row["baseline_ms"] / row["ms"]
    row.update(row_extra or {})
    return row


def _sweep_splits(c, row, label) -> None:
    """The case's current kernel at clusters of 1, 2, 4 and 8 blocks."""
    ref_out = c["current"]()
    row["splits_ms"] = {}
    for ns in (1, 2, 4, 8):
        with forced_splits(ns):
            again = c["current"]()
            row["splits_ms"][ns] = time_ms(c["current"])
        if _err(again, ref_out) > row["tol"]:
            raise RuntimeError(f"{label} with {ns} splits: {_err(again, ref_out)}")
    print(f"{label}: ms by cluster size {row['splits_ms']}", flush=True)


def compare_kv(libs, dev, g, sweep_splits: bool, result: dict) -> None:
    """#8 and #11 against the baseline; their pinned outputs equal to it."""
    cases = {
        "decode_attention flagship": _decode_case(dev, g, 256, (144,) * 4),
        "decode_attention serving (c)": _decode_case(dev, g, 2048, SERVING_LENS),
        "segment_tail_attention flagship": _segment_case(dev, g, 256, 31, (128,) * 4, (15,) * 4),
        "segment_tail_attention serving (c)": _segment_case(dev, g, 2048, 8, SERVING_LENS,
                                                            SERVING_WRITTEN),
    }
    for label, c in cases.items():
        row = _time_against_baseline(libs, c, label)
        row["sdpa_ms"] = time_ms(c["sdpa"])
        row["factor_to_sdpa"] = row["ms"] / row["sdpa_ms"]
        result["cases"][label] = row
        print(f"{label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
              f"{row['speedup']:.2f}x; SDPA {row['sdpa_ms']:.4f}, {row['factor_to_sdpa']:.2f}x; "
              f"bound {row['bound_ms']:.5f}); turns {row['turns_ms']}; err {row['max_abs_err']:.3g} "
              f"(tol {row['tol']:.3g}), vs baseline {row['vs_baseline']:.3g}", flush=True)
        if sweep_splits:
            _sweep_splits(c, row, label)
    if sweep_splits:
        one = torch.zeros(1, device=dev)
        result["one_launch_ms"] = time_ms(lambda: one.add_(1))
        print(f"one tiny kernel (add_ on one element): {result['one_launch_ms']:.4f} ms",
              flush=True)
    digests, base_digests = kv_pin_digests(dev), kv_pin_digests(dev, libs)
    result["kv_pin_digests"] = digests
    result["kv_pin_digests_baseline"] = base_digests
    print(f"kv pin digests {digests}; the baseline's {base_digests}; equal "
          f"{digests == base_digests}", flush=True)
    if digests != base_digests:
        raise RuntimeError(f"#8/#11 digests differ from the baseline's: {digests} vs {base_digests}")


def compare_paged(libs, dev, g, sweep_splits: bool, result: dict) -> None:
    """#9 and #12 against the baseline at serving run (a)'s shapes, beside
    #8 and #11 on the same lengths (a contiguous 2048-slot slab)."""
    same = {"paged_decode_attention": _decode_case(dev, g, 2048, SERVING_LENS),
            "paged_segment_tail_attention": _segment_case(dev, g, 2048, 8, SERVING_LENS,
                                                          SERVING_WRITTEN)}
    for name, contiguous in same.items():
        c = _paged_case(dev, g, name)
        label = f"{name} serving (a)"
        row = _time_against_baseline(libs, c, label, {
            "cluster": da.kv_splits(2048 + (8 if "segment" in name else 0))})
        row["contiguous_ms"] = time_ms(contiguous["current"])
        row["page_lookup_ms"] = row["ms"] - row["contiguous_ms"]
        result["cases"][label] = row
        print(f"{label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
              f"{row['speedup']:.2f}x; bound {row['bound_ms']:.5f}; cluster {row['cluster']}); "
              f"{'#8' if 'decode' in name else '#11'} on the same lengths "
              f"{row['contiguous_ms']:.4f} ms, the page lookup's cost "
              f"{row['page_lookup_ms']:+.4f} ms; turns {row['turns_ms']}; err "
              f"{row['max_abs_err']:.3g} (tol {row['tol']:.3g}), baseline err "
              f"{row['baseline_err']:.3g}", flush=True)
        if sweep_splits:
            _sweep_splits(c, row, label)


PARTS = tuple(PART_LIBS)


def run(baseline: Path, sweep_splits: bool = False, only=PARTS) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("compare_kernels needs a CUDA card")
    dev = "cuda"
    names = sorted({n for part in only for n in PART_LIBS[part]})
    libs = build_baseline(baseline, names)
    _build.build_all(names)
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "cases": {}}
    if "kv" in only:
        compare_kv(libs, dev, g, sweep_splits, result)
    if "paged" in only:
        compare_paged(libs, dev, g, sweep_splits, result)
    if "decode_matmul" in only:
        result["cases"].update(compare_decode_matmul(libs, dev, g, sweep_splits))
    if "layer_norm" in only:
        result["cases"].update(compare_layer_norm(libs, dev, g))
    if "ln_qkv_head" in only:
        result["cases"].update(compare_ln_qkv_head(libs, dev, g, sweep_splits))
    if "ln_matmul_gelu" in only:
        result["cases"].update(compare_ln_matmul_gelu(libs, dev, g, sweep_splits))
    if "out_proj" in only:
        result["cases"].update(compare_out_proj(libs, dev, g, sweep_splits))
    if "transpose" in only:
        result["cases"].update(compare_transpose(libs, dev, g, sweep_splits))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result["nvidia_smi"] = smi
    print(smi, flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="directory holding the earlier csrc sources")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    ap.add_argument("--sweep-splits", action="store_true",
                    help="also time #8, #9, #11, #12 and #14 at clusters of 1, 2, 4 and 8 "
                         "blocks, #2, #6 and #7 at each tensor-core tile (#6 and #7 also at "
                         "each count of column tiles a block runs) and #5 at each row count")
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS,
                    help="the kernels to compare (all by default)")
    args = ap.parse_args()
    result = run(args.baseline, args.sweep_splits, args.only)
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
