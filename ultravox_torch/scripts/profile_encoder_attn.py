"""Encoder-attention probes on the card: the port's counterpart of the JAX
package's ``scripts/profile_encoder_attn.py``.

    python -m ultravox_torch.scripts.profile_encoder_attn

At the reference's shape (B 8, T = S = 1500, H 20, D 64, bf16, inputs from
numpy seed 0 times 0.3, every key valid) it times the production encoder
attention (``fused_attention``, the port's kernel of the reference's
``fused_attention``) and then every probe of the reference's ``main``, in
its order: ``attn_v2`` at block_q 500 and 1500 with the exponent in fp32
and bf16, ``attn_nt`` at (1500, fp32), (1500, bf16) and (500, fp32), and
``attn_v2`` with no mask; last, ``scaled_dot_product_attention`` as a
library yardstick. Each line gives the card's ms per call (CUDA events, the
calls queued ahead), TF/s of QK^T + PV (92.16 GFLOP per call) and the
largest difference from the production kernel's output. The card's kernel
tiles queries by 64 rows at every block_q, so the two block_q lines of a
probe time the same kernel. Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ultravox_torch.ops.kernels import encoder_attn_probe as probes
from ultravox_torch.ops.kernels.fused_attention import fused_attention

B, T, H, D = 8, 1500, 20, 64
S = T
GFLOP = 4.0 * B * H * T * S * D / 1e9  # QK^T + PV: 2 products of 2 flop per MAC

# the reference's probes, in the order of its main: (label, probe, block_q,
# exponent dtype, key-length mask)
VARIANTS = (
    ("v2 bq=500 exp=fp32", "attn_v2", 500, torch.float32, True),
    ("v2 bq=500 exp=bf16", "attn_v2", 500, torch.bfloat16, True),
    ("v2 bq=1500 exp=fp32", "attn_v2", 1500, torch.float32, True),
    ("v2 bq=1500 exp=bf16", "attn_v2", 1500, torch.bfloat16, True),
    ("no-transpose bq=1500 exp=fp32", "attn_nt", 1500, torch.float32, True),
    ("no-transpose bq=1500 exp=bf16", "attn_nt", 1500, torch.bfloat16, True),
    ("no-transpose bq=500 exp=fp32", "attn_nt", 500, torch.float32, True),
    ("v2 no-mask exp=fp32", "attn_v2", 1500, torch.float32, False),
)


def make_inputs(device, seed: int = 0):
    """q, k, v (B, T, H, D) bf16: standard normal from numpy, times 0.3."""
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal((B, n, H, D))).to(device, torch.bfloat16) * 0.3
        for n in (T, S, S)
    )


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean card ms per call between CUDA events. The card sleeps while the
    host queues the calls, so the events time the card's work alone."""
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


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def run(*, check: bool = False, iters: int = 20, seed: int = 0) -> dict:
    """Time the production kernel, every probe and SDPA; print one line
    each. ``check``: also hold each probe against its plain version
    (``attn_probe_plain``) at this shape, within 4 bf16 ulps of the largest
    output, and raise if one disagrees. Returns the device, the shape and one
    dict per line."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_encoder_attn runs on a CUDA card, and none is available")
    dev = torch.device("cuda")
    q, k, v = make_inputs(dev, seed)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    scale = D**-0.5
    result = {"device": torch.cuda.get_device_name(0), "shape": [B, T, H, D], "gflop": GFLOP,
              "rows": []}
    print(f"device: {result['device']}; q/k/v {tuple(q.shape)} bf16; {GFLOP:.2f} GFLOP per call",
          flush=True)

    def report(label, fn, ref=None, **extra):
        ms = time_ms(fn, iters)
        out = fn()
        torch.cuda.synchronize()
        row = {"label": label, "ms": ms, "tflops": GFLOP / ms, **extra}
        line = f"{label:34s} {ms:7.3f} ms = {GFLOP / ms:5.1f} TF/s"
        if ref is not None:
            row["maxdiff"] = _max_diff(out, ref)
            line += f"  maxdiff {row['maxdiff']:.2e}"
        result["rows"].append(row)
        print(line, flush=True)
        return row, out

    _, ref = report("prod kernel (fused_attention)",
                    lambda: fused_attention(q, k, v, lens, scale=scale))
    plains = {}
    for label, name, block_q, exp_dtype, masked in VARIANTS:
        kw = dict(scale=scale, block_q=block_q, exp_dtype=exp_dtype)
        fn = functools.partial(getattr(probes, name), q, k, v, lens if masked else None, **kw)
        row, out = report(label, fn, ref, probe=name, block_q=block_q,
                          exp=str(exp_dtype)[6:], masked=masked)
        if check:
            key = (exp_dtype, masked)
            if key not in plains:
                plains[key] = probes.attn_probe_plain(
                    q, k, v, lens if masked else None, scale=scale, exp_dtype=exp_dtype)
            plain = plains[key]
            row["max_abs_err"] = _max_diff(out, plain)
            row["tol"] = 4 * 2.0**-8 * float(plain.abs().max())
            print(f"  against its plain version: max_abs_err {row['max_abs_err']:.3g} "
                  f"(tol {row['tol']:.3g})", flush=True)
            if not row["max_abs_err"] <= row["tol"]:
                raise RuntimeError(f"{label} disagrees with its plain version: "
                                   f"{row['max_abs_err']} > {row['tol']}")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    report("library: scaled_dot_product_attention",
           lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale).transpose(1, 2), ref)
    return result


def main() -> None:
    run()


if __name__ == "__main__":
    main()
