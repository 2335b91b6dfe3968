"""Run one cell of BENCHMARK.json and print its result as the last line of
standard output.

    python3 uvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``ultravox_torch``. With ``--trace
0`` the result carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer ones and the traced window's device busy time. A run that
finds no CUDA card, fewer cards than the cell asks for, no program in the
checkout, or JAX loaded once its window has closed exits with 1 and prints
no result. Options for finding a cell's settings, never passed by a check:
``--rate`` (sessions a second, for a sweep), ``--check 0`` (no reference),
``--control 1`` (the low-precision control compared in the program's place), ``--device cpu``
(a test at a tiny size on the plain paths)."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(Path(os.path.abspath(__file__)).parent.parent))
FORBIDDEN = ("jax", "jaxlib", "flax", "ultravox_tpu")
CACHE = ROOT / ".uvbench_cache"


def log(msg: str) -> None:
    print(f"uvbench: {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--check", type=int, choices=(0, 1), default=1)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that are JAX or its package,
    compared whole (``ultravox_torch`` is not ``ultravox_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def host_speed_ms() -> float:
    """Milliseconds of a fixed stretch of pure Python: the host's speed,
    logged beside each run (the serving loop is host code)."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return (time.perf_counter() - t) * 1e3


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


class Context:
    """What an entry gets: its arguments and files, the device, and the
    harness's clock, memory and metric readers."""

    def __init__(self, args, cell, device):
        self.args, self.cell, self.device = args, cell, device
        self.log = log
        self.setup_s = None
        self.memory_peak = 0

    def mark_setup_end(self) -> None:
        self.setup_s = time.monotonic() - T_START

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def read_metrics(self, run) -> dict:
        """Each of the cell's metrics from its reader, left out where the
        reader finds nothing to read."""
        from uvbench import spec

        run.setup_s = self.setup_s
        wanted = self.cell["per_layer"] if self.args.trace else self.cell["end_to_end"]
        out = {}
        for metric in wanted:
            value = spec.load_module("metrics", metric["name"]).read(run)
            if value is None:
                log(f"metric {metric['name']}: nothing to read")
                continue
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
            log(f"metric {metric['name']}: {float(value)!r} {metric['unit']}")
        return out


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    from uvbench import spec

    cell = spec.cell(ROOT, args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA card(s), found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 1
    import ultravox_torch

    if not Path(os.path.abspath(ultravox_torch.__file__)).is_relative_to(ROOT.absolute()):
        log(f"the program is not in this checkout ({ultravox_torch.__file__})")
        return 1
    device = torch.device(args.device)
    if device.type == "cuda":
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    speed0 = host_speed_ms()
    ctx = Context(args, cell, device)
    entry = spec.load_module("entries", cell["settings"]["entry"])
    out = entry.run(ctx)
    bad = forbidden_loaded()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 1
    checks = out.get("checks", {})
    correct = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    dev.update(out.get("device_extra", {}))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": dev}
    if args.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    if device.type == "cuda":
        mem = torch.cuda.memory_stats(device)
        log(f"allocator: {mem.get('num_alloc_retries', 0)} retries, "
            f"{mem.get('num_device_alloc', 0)} device allocations, "
            f"{mem.get('num_device_free', 0)} frees")
    log(f"host speed: {host_speed_ms():.1f} ms for a fixed loop (before the run: {speed0:.1f} ms)")
    log(f"the run took {time.monotonic() - T_START:.1f} s")
    print(f"correct: {correct} (failed turns or steps: {out['failed']})", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - any failure: no result line, a non-zero exit
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
