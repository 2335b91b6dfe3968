"""The arithmetic the metric files share. Each reader takes the run's
record (``entries/serve.py::ServeRun``; its ``kind`` names the entry) and
returns a number, or None where it finds nothing to read; it logs the
sample count behind each percentile on standard error."""

from __future__ import annotations

import math
from typing import Optional

from uvbench import work
from uvbench.peaks import HBM_BYTES_PER_S, least_s
from uvbench.stats import percentile

# kernel names in a trace (less a leading "void "), by the port's kernel
DECODE_ATTENTION = ("decode_attention_split_kernel", "paged_decode_attention_split_kernel",
                    "paged_gather_kernel", "segment_attention_split_kernel",
                    "paged_segment_attention_split_kernel")
LAYER_NORM = ("layer_norm_kernel<", "layer_norm_warp_kernel<")
LN_QKV_HEAD = ("ln_qkv_head_kernel<", "ln_qkv_head_mma_kernel<")
QKV_HEAD_TRANSPOSE = ("qkv_head_transpose_kernel",)


def attention_mma(head_dim: int) -> tuple:
    """The bf16 attention kernel of ``csrc/attention.cu``, instantiated per
    head size: the encoder's (#3) and the prefill's (#4) differ by it."""
    return (f"attention_mma_kernel<{head_dim},",)


def setup_s_reader(run) -> Optional[float]:
    return run.setup_s


def ttft_ms(run) -> Optional[float]:
    due = run.due_in_window()
    if run.kind != "serve" or not due:
        return None
    vals = [(r.first - r.due) * 1e3 if r.ok else math.inf for r in due]
    p95 = percentile(vals, 95)
    run.log(f"ttft: p50 {percentile(vals, 50)!r} ms, p95 {p95!r} ms over {len(vals)} turns due "
            f"in the window ({sum(1 for v in vals if v == math.inf)} missing)")
    return p95 if p95 != math.inf else None


def tpot_ms(run) -> Optional[float]:
    if run.kind != "serve":
        return None
    vals = [(r.times[-1] - r.times[0]) / (len(r.times) - 1) * 1e3
            for r in run.due_in_window() if r.ok and len(r.times) >= 2]
    if not vals:
        return None
    p95 = percentile(vals, 95)
    run.log(f"tpot: p50 {percentile(vals, 50)!r} ms, p95 {p95!r} ms over {len(vals)} turns")
    return p95


def output_tok_s(run) -> Optional[float]:
    if run.kind != "serve":
        return None
    n = sum(1 for r in run.records for t in r.times if run.w0 <= t < run.w1)
    run.log(f"output tokens delivered in the window: {n} in {run.seconds!r} s")
    return n / run.seconds


def dispatch_share(run) -> Optional[float]:
    a, b = run.span()
    if run.kind != "serve" or b <= a:
        return None
    return 100.0 * run.counter("stat_dispatch_s") / (b - a)


def prefix_reuse_share(run) -> Optional[float]:
    done = [r for r in run.due_in_window() if r.prompt_len]
    total = sum(r.prompt_len for r in done)
    if run.kind != "serve" or not total:
        return None
    return 100.0 * sum(r.reused for r in done) / total


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def serve_least_s(run) -> Optional[float]:
    """Least time of the work the traced span completed, per phase: the
    audio tower and projector of each turn prefilled in it, each such
    turn's prefill past its reused prefix, and the decode steps (the
    weights once a step, each decoded token's products and keys)."""
    if run.kind != "serve" or run.trace is None:
        return None
    m = run.m
    enc, pre = work.Work(), work.Work()
    for r in run.prefilled_in_span():
        enc += work.encoder_call(m, r.turn.frames)
        pre += work.prefill(m, r.reused, r.prompt_len - r.reused, run.chunk)
    dec = work.decode_tokens(m, run.decode_contexts_in_span())
    dec += work.decode_steps(m, int(run.counter("stat_decode_steps")))
    return enc.least_s() + pre.least_s() + dec.least_s()


def mfu_busy(run) -> Optional[float]:
    least = serve_least_s(run)
    if least is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * least / run.trace.busy_s


def mfu_wall(run) -> Optional[float]:
    least = serve_least_s(run)
    if least is None or run.trace.window_s <= 0:
        return None
    return 100.0 * least / run.trace.window_s


def decode_attn_roofline(run) -> Optional[float]:
    if run.kind != "serve" or run.trace is None:
        return None
    spent = run.trace.kernel_s(DECODE_ATTENTION)
    if not spent:
        return None
    nbytes = work.decode_attention_bytes(run.m, run.decode_contexts_in_span())
    return 100.0 * nbytes / HBM_BYTES_PER_S / spent


def prefill_attn_roofline(run) -> Optional[float]:
    m = run.m
    if run.kind != "serve" or run.trace is None or m.Dh == m.de:
        return None
    spent = run.trace.kernel_s(attention_mma(m.Dh))
    if not spent:
        return None
    least = sum(work.prefill_attention(m, r.reused, r.prompt_len - r.reused, run.chunk)
                for r in run.prefilled_in_span())
    return 100.0 * least / spent


def encoder_kernel_roofline(run) -> Optional[float]:
    """The fused tower's kernels (#1 LayerNorm, #2 LayerNorm + q/k/v, #3
    attention, #5 the q/k/v transpose where it runs) over the valid frames
    of each turn prefilled in the span."""
    m = run.m
    if run.kind != "serve" or run.trace is None or m.Dh == m.de:
        return None
    names = LAYER_NORM + LN_QKV_HEAD + QKV_HEAD_TRANSPOSE + attention_mma(m.de)
    spent = run.trace.kernel_s(names)
    if not spent:
        return None
    B = work.BYTES
    least = 0.0
    for r in run.prefilled_in_span():
        T, d = r.turn.frames // 2, m.d
        ln = least_s(0.0, 2 * T * d * B)
        qkv = least_s(2 * T * d * 3 * d, (T * d + 3 * d * d + 3 * T * d) * B)
        attn = least_s(4 * T * T * d, 4 * T * d * B)
        least += m.Le * (ln + qkv + attn)
    return 100.0 * least / spent

