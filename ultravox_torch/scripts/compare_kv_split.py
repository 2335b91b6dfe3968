"""The split KV kernel (#8 ``decode_attention``, #11
``segment_tail_attention``) beside an earlier build of the same kernels,
in one process on one card.

    python -m ultravox_torch.scripts.compare_kv_split --baseline DIR [--out FILE]

DIR holds an earlier ``ultravox_torch/ops/kernels/csrc``: the one-block
kernels (their entry points take no ``splits`` argument) or an earlier
split kernel (they do), for example

    git archive <commit> ultravox_torch/ops/kernels/csrc | tar -x -C DIR

The script builds DIR's decode_attention, segment_attention and
paged_attention with the port's nvcc flags into DIR/build, then, in bf16:

- #8 at the flagship decode step (q (4, 32, 64) against a (4, 256, 8, 64)
  slab with 144 keys) and at serving run (c)'s (a (4, 2048, 8, 64) slab
  with 129-190 keys); #11 at the flagship scan step (layer 7 of a
  (16, 4, 256, 8, 64) cache, 128 keys, a 31-slot tail with 15 written) and
  at serving run (c)'s block (a (16, 4, 2048, 8, 64) cache, 129-190 keys,
  an 8-slot tail with 0-7 written). Each: the current kernel against its
  plain version and against the baseline (4 bf16 ulps of the largest
  output), and the card ms of baseline, current, current, baseline in turn
  (CUDA events, calls queued ahead), beside the bound over the visible
  bytes and SDPA on the same keys (a yardstick; the port never calls it);
- #9 ``paged_decode_attention`` and #12 ``paged_segment_tail_attention``
  at the paged engine's shapes: current and baseline bit-equal, timed in
  the same turns;
- ``paged_pin_digests``: the digests of #9's and #12's outputs on
  ``paged_pin_inputs``, for both libraries (tests/test_torch_cuda.py pins
  them);
- with ``--sweep-splits``, #8 and #11 at both shapes with the cluster size
  forced to 1, 2, 4 and 8 blocks (``kv_splits`` picks 8 there), and the
  card's time for one tiny kernel timed the same way (``add_`` on one
  element: the floor a launch costs back to back).

Prints one line per measurement and one JSON object last (also written to
``--out``). Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ultravox_torch.ops.kernels import _build
from ultravox_torch.ops.kernels import decode_attention as da
from ultravox_torch.ops.kernels import paged_attention as pa
from ultravox_torch.ops.kernels import segment_attention as sa

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
B, H, HKV, D, L, LAYER = 4, 32, 8, 64, 16, 7

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
# the one-block-per-row interface: the current signatures without `splits`
BASELINE_SIGNATURES = {
    "decode_attention": (_P, _P, _P, _P, _LLP, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "segment_attention": (_P, _P, _P, _P, _P, _P, _LLP, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
}


def takes_splits(csrc: Path) -> bool:
    """Whether the baseline's #8 and #11 take the cluster size."""
    return "int splits" in (csrc / "decode_attention.cu").read_text()


def build_baseline(csrc: Path) -> dict:
    """nvcc each baseline library into csrc/build; returns name -> CDLL with
    its entry points' argtypes set."""
    split = takes_splits(csrc)
    out = csrc / "build"
    out.mkdir(exist_ok=True)
    names = ("decode_attention", "segment_attention", "paged_attention")
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
        for entry in _build.ENTRY_POINTS.get(name, (name,)):
            fn = getattr(lib, f"uv_{entry}")
            sig = _build._SIGNATURES[entry] if split else BASELINE_SIGNATURES.get(
                entry, _build._SIGNATURES[entry])
            fn.argtypes = list(sig)
            fn.restype = ctypes.c_int
        getattr(lib, f"uv_{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"uv_{name}_error_string").argtypes = [ctypes.c_int]
        lib.takes_splits = split
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
    splits = (da.kv_splits(S),) if lib.takes_splits else ()
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
    splits = (da.kv_splits(S + Ts),) if lib.takes_splits else ()
    rc = lib.uv_segment_attention(
        _build.ptr(q), _build.ptr(kc), _build.ptr(vc), _build.ptr(tk), _build.ptr(tv),
        _build.ptr(out), strides, _build.ptr(lengths), _build.ptr(written), int(layer),
        int(window), Bq, T, Hq, Hq // Hkv, S, Ts, Dq, da.rounded_scale(Dq**-0.5, q.dtype),
        *splits, _build.dtype_code(q), _build.stream_ptr(q.device))
    _check(lib, "segment_attention", rc)
    return out


@contextlib.contextmanager
def forced_splits(ns):
    """#8 and #11 launch clusters of ``ns`` blocks while this is open."""
    current = da.kv_splits
    da.kv_splits = sa.kv_splits = lambda n_keys: ns
    try:
        yield
    finally:
        da.kv_splits = sa.kv_splits = current


@contextlib.contextmanager
def baseline_library(libs):
    """The wrappers of the unchanged interfaces (#9, #12) launch the
    baseline's build while this is open."""
    current = _build.library
    _build.library = lambda name: libs.get(name) or current(name)
    try:
        yield
    finally:
        _build.library = current


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean card ms per call between CUDA events, the calls queued ahead
    while the card sleeps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def paged_pin_inputs(dev, dtype):
    """#9's and #12's inputs for the digest pin, from numpy seed 3: 3 rows
    of 1, 37 and 100 keys in pages of 16 (shuffled ids, sentinel entries),
    GQA 4, head_dim 64; #12 with T = 2, an 8-slot tail, written 0/3/5, layer
    1 of 2, window 20."""
    rng = np.random.default_rng(3)
    P, ps, Hkv, Dh, Hq, n_per = 12, 16, 2, 64, 8, 8
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)  # noqa: E731
    table = np.full((3, n_per), P, np.int32)
    order = list(rng.permutation(P))
    for b, n in enumerate((1, 37, 100)):
        for i in range(-(-n // ps)):
            table[b, i] = order.pop()
    table = torch.from_numpy(table).to(dev)
    lens = _ints(dev, 1, 37, 100)
    q9, kp, vp = t(3, Hq, Dh), t(2, P, ps, Hkv, Dh), t(2, P, ps, Hkv, Dh)
    q12, tk, tv = t(3, 2, Hq, Dh), t(3, 8, Hkv, Dh), t(3, 8, Hkv, Dh)
    return {
        "paged_decode_attention": lambda: pa.paged_decode_attention(
            q9, kp[1], vp[1], table, lens, 20),
        "paged_segment_tail_attention": lambda: sa.paged_segment_tail_attention(
            q12, kp, vp, 1, table, lens, tk, tv, _ints(dev, 0, 3, 5), 20),
    }


def paged_pin_digests(dev) -> dict:
    """sha256 (first 16 hex digits) of #9's and #12's output bytes on
    ``paged_pin_inputs``, bf16 and fp32."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, fn in paged_pin_inputs(dev, dtype).items():
            o = fn()
            torch.cuda.synchronize()
            raw = o.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).cpu().numpy()
            out[f"{name} {str(dtype)[6:]}"] = hashlib.sha256(raw.tobytes()).hexdigest()[:16]
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
    """#9 or #12 at the paged engine's shapes: a pool of 32 pages of 256,
    one page per row (129-190 keys), layer 7 of 16; #12 with an 8-slot
    tail, written 0/3/5/7."""
    bf = torch.bfloat16
    P, ps = 32, 256
    order = np.random.default_rng(0).permutation(P)
    table = np.full((B, 2048 // ps), P, np.int32)
    table[:, 0] = order[:B]
    table = torch.from_numpy(table).to(dev)
    lens = _ints(dev, 129, 150, 171, 190)
    kp = torch.randn((L, P, ps, HKV, D), generator=g, device=dev).to(bf)
    vp = torch.randn((L, P, ps, HKV, D), generator=g, device=dev).to(bf)
    if name == "paged_decode_attention":
        q = torch.randn((B, H, D), generator=g, device=dev).to(bf)
        return lambda: pa.paged_decode_attention(q, kp[LAYER], vp[LAYER], table, lens)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    tk = torch.randn((B, 8, HKV, D), generator=g, device=dev).to(bf)
    tv = torch.randn((B, 8, HKV, D), generator=g, device=dev).to(bf)
    written = _ints(dev, 0, 3, 5, 7)
    return lambda: sa.paged_segment_tail_attention(q, kp, vp, LAYER, table, lens, tk, tv, written)


def run(baseline: Path, sweep_splits: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("compare_kv_split needs a CUDA card")
    dev = "cuda"
    libs = build_baseline(baseline)
    _build.build_all(["decode_attention", "segment_attention", "paged_attention"])
    g = torch.Generator(device=dev).manual_seed(0)
    serving_lens = (129, 150, 171, 190)
    cases = {
        "decode_attention flagship": _decode_case(dev, g, 256, (144,) * 4),
        "decode_attention serving (c)": _decode_case(dev, g, 2048, serving_lens),
        "segment_tail_attention flagship": _segment_case(dev, g, 256, 31, (128,) * 4, (15,) * 4),
        "segment_tail_attention serving (c)": _segment_case(dev, g, 2048, 8, serving_lens,
                                                            (0, 3, 5, 7)),
    }
    result = {"device": torch.cuda.get_device_name(0), "cases": {}}
    for label, c in cases.items():
        out, ref, base = c["current"](), c["plain"](), c["baseline"](libs)
        torch.cuda.synchronize()
        row = {"max_abs_err": _err(out, ref), "tol": _tol(ref), "vs_baseline": _err(out, base)}
        if not (row["max_abs_err"] <= row["tol"] and row["vs_baseline"] <= row["tol"]):
            raise RuntimeError(f"{label}: {row}")
        row.update(in_turns(lambda: c["baseline"](libs), c["current"]))
        row["sdpa_ms"] = time_ms(c["sdpa"])
        row["bound_ms"] = max(c["bytes"] / HBM_BYTES_PER_S, c["flops"] / BF16_FLOPS) * 1e3
        row["speedup"] = row["baseline_ms"] / row["ms"]
        row["factor_to_sdpa"] = row["ms"] / row["sdpa_ms"]
        result["cases"][label] = row
        print(f"{label}: {row['ms']:.4f} ms (baseline {row['baseline_ms']:.4f}, "
              f"{row['speedup']:.2f}x; SDPA {row['sdpa_ms']:.4f}, {row['factor_to_sdpa']:.2f}x; "
              f"bound {row['bound_ms']:.5f}); turns {row['turns_ms']}; err {row['max_abs_err']:.3g} "
              f"(tol {row['tol']:.3g}), vs baseline {row['vs_baseline']:.3g}", flush=True)
        if sweep_splits:
            ref_out = out
            row["splits_ms"] = {}
            for ns in (1, 2, 4, 8):
                with forced_splits(ns):
                    again = c["current"]()
                    row["splits_ms"][ns] = time_ms(c["current"])
                if _err(again, ref_out) > row["tol"]:
                    raise RuntimeError(f"{label} with {ns} splits: {_err(again, ref_out)}")
            print(f"{label}: ms by cluster size {row['splits_ms']}", flush=True)
    if sweep_splits:
        one = torch.zeros(1, device=dev)
        result["one_launch_ms"] = time_ms(lambda: one.add_(1))
        print(f"one tiny kernel (add_ on one element): {result['one_launch_ms']:.4f} ms",
              flush=True)
    for name in ("paged_decode_attention", "paged_segment_tail_attention"):
        fn = _paged_case(dev, g, name)
        out = fn()
        with baseline_library(libs):
            base = fn()
        torch.cuda.synchronize()
        if not torch.equal(out, base):
            raise RuntimeError(f"{name}: the current build differs from the baseline")

        def base_fn(fn=fn):
            with baseline_library(libs):
                fn()

        row = dict(in_turns(base_fn, fn), bit_equal=True)
        row["change"] = row["ms"] / row["baseline_ms"] - 1
        result["cases"][name] = row
        print(f"{name}: bit-equal to the baseline; {row['ms']:.4f} ms against "
              f"{row['baseline_ms']:.4f} ({100 * row['change']:+.2f}%); turns {row['turns_ms']}",
              flush=True)
    digests = paged_pin_digests(dev)
    with baseline_library(libs):
        base_digests = paged_pin_digests(dev)
    result["paged_pin_digests"] = digests
    result["paged_pin_digests_equal"] = digests == base_digests
    print(f"paged pin digests {digests}; equal to the baseline's {digests == base_digests}",
          flush=True)
    if digests != base_digests:
        raise RuntimeError(f"paged digests differ: {digests} vs {base_digests}")
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
                    help="also time #8 and #11 at clusters of 1, 2, 4 and 8 blocks")
    args = ap.parse_args()
    result = run(args.baseline, args.sweep_splits)
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
