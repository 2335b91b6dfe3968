"""The serving cells' correctness check, and its control.

Once the window has closed and the program's state is freed, a sample of
the window's finished turns is drawn from the seed, the turn with the
most served tokens always in it. The reference runs once over each turn's
prompt (its audio from the same mel frames) followed by the served tokens
and reads, at each served position, how far the served token's logit lies
below the reference's best: the number compared is the widest such gap.
Greedy decoding in bfloat16 may pick a near-tie's other token; a program
that serves a wrong token reads a gap of the logits' own spread.

The control (``--control 1``) puts the reference in the program's place
at float8 (W8A8 e4m3, ``plain.FP8``): at each position of the same prompts
and tokens the number compared is the exact reference's gap of the token
float8 puts first, so the run's own comparison gives its verdict; the
program's reading is logged beside it. Imports nothing of the program."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from uvbench import weights as weights_lib
from uvbench.reference import plain

SALT = 0x5EC0  # the sample's stream, apart from the traffic's


def sample(records: List, n: int, seed: int) -> List:
    """The turn with the most served tokens, and n - 1 others drawn from
    the seed."""
    if not records:
        return []
    rng = np.random.default_rng((int(seed) ^ SALT) % (2**63))
    longest = max(range(len(records)), key=lambda i: (len(records[i].tokens), -i))
    rest = [i for i in range(len(records)) if i != longest]
    pick = list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False)) if rest else []
    return [records[i] for i in [longest, *pick]]


def readings(ctx, plan, picked: List, control: bool = False) -> Dict[str, float]:
    """``max_gap`` over the served tokens of ``picked`` (and with
    ``control`` the float8 reference's ``control_max_gap``)."""
    plain.exact_float32()
    cfgfile = ctx.cell["config"]
    m = weights_lib.dims(cfgfile)
    w = weights_lib.make(cfgfile, ctx.args.seed, ctx.device, fused=True)
    dev = ctx.device
    out = {"max_gap": 0.0, "tokens": 0}
    if control:
        out["control_max_gap"] = 0.0
    with torch.no_grad():
        for r in picked:
            ids = torch.from_numpy(r.ids).to(dev)
            mel = torch.from_numpy(np.ascontiguousarray(plan.mel(r.turn))).to(dev)
            served = torch.tensor(r.tokens, dtype=torch.long, device=dev)
            ref = plain.served_logits(w, m, ids, mel, r.start, served)
            out["max_gap"] = max(out["max_gap"], float(plain.gaps(ref, served).max()))
            out["tokens"] += len(r.tokens)
            if control:
                low = plain.served_logits(w, m, ids, mel, r.start, served, plain.FP8)
                g = plain.gaps(ref, low.argmax(dim=-1))
                out["control_max_gap"] = max(out["control_max_gap"], float(g.max()))
            del ref
    del w
    return out


def check(ctx, plan, finished: List, spec: Dict) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each with its limit: the program's, or with
    ``--control 1`` the float8 reference's in its place."""
    picked = sample(finished, int(spec["sample"]), ctx.args.seed)
    if not picked:
        raise RuntimeError("no finished turn in the window to check")
    t0 = time.monotonic()
    r = readings(ctx, plan, picked, control=bool(ctx.args.control))
    ctx.log(f"check: {len(picked)} turns, {r['tokens']} served tokens compared with the reference "
            f"in {time.monotonic() - t0:.1f} s")
    value = r["max_gap"]
    if ctx.args.control:
        ctx.log(f"control: the float8 reference in the program's place reads "
                f"{r['control_max_gap']!r}; the program read {value!r}")
        value = r["control_max_gap"]
    return {"max_gap": {"value": value, "limit": float(spec["max_gap"])}}
