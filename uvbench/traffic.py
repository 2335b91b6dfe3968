"""The general generator of serving traffic: sessions of turns, each turn
one audio utterance with its chat-template text, from the parameters of a
traffic file and the seed.

Two arrival patterns cover the mixes:

- ``{"kind": "poisson", "rate_per_s": r}``: an open loop. Sessions arrive
  at rate r; a session's next turn is due when its previous answer has
  ended, plus the next utterance's duration and ``think_s`` (the user
  speaks). Sessions are already in progress at the start, with a history drawn
  from the seed (``rate_per_s`` times
  ``warm_session_s``, the mean session's length as measured on the card),
  so the load is near its steady state after a short ramp.
- ``{"kind": "clients", "count": n}``: a closed loop of n clients, each
  sending its next turn when its last one ends.

Every size is drawn stratified: n draws of a distribution are its
quantiles at (i + 0.5) / n, in an order the seed permutes. So every seed
serves the same sizes and arrival gaps in another order, and the work of
a run does not depend on its seed. Token ids are random from the seed; the
model's weights are random too, so what the ids say does not matter, only
how many there are and which of them repeat (system prompts, history).
Audio comes as log-mel frames drawn from the seed, a whole number of LLM
positions long (16 frames each)."""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

FRAMES_PER_S = 100  # Whisper's 10 ms hop
_PHI_INV = NormalDist().inv_cdf


def _frames(seconds: float) -> int:
    """Mel frames of an utterance: a whole number of LLM positions (16
    frames each), rounded down."""
    return max(16, int(seconds * FRAMES_PER_S) // 16 * 16)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _ppf(spec: Dict, u: np.ndarray) -> np.ndarray:
    """Inverse CDF of a size distribution of a traffic file."""
    kind = spec["dist"]
    if kind == "lognormal":
        z = np.array([_PHI_INV(float(x)) for x in u])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif kind == "uniform":
        x = spec["min"] + u * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(x, spec["min"], spec["max"])


def stratified(rng: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    return rng.permutation(_ppf(spec, _quantiles(n)))


@dataclass
class Turn:
    audio_s: float
    frames: int
    mel_offset: int
    max_tokens: int
    transcript: np.ndarray  # the ids standing for the utterance in later history


@dataclass
class Session:
    sid: int
    start_s: float  # when its first turn is due, from the start of the traffic
    agent: Optional[int]
    turns: List[Turn]  # empty for a closed-loop client: it draws from the pool
    history: List[np.ndarray] = field(default_factory=list)
    done: int = 0  # turns finished


class Plan:
    def __init__(self, params: Dict, vocab: int, n_mels: int, seed: int, seconds: float,
                 rate: Optional[float] = None):
        self.p = params
        rng = np.random.default_rng(int(seed) % (2**63))
        self.rng = rng
        lo = int(params.get("min_token_id", 1000))
        self.token_bank = rng.integers(lo, vocab, size=1 << 20, dtype=np.int64)
        self._bank_pos = 0
        tpl = params["template"]
        self.before = self._tokens(tpl["before_audio"])
        self.after = self._tokens(tpl["after_audio"])
        self.audio_id = int(params.get("audio_token_id", 1))
        self.min_frames = _frames(params["audio_s"]["min"])
        self.max_frames = _frames(params["audio_s"]["max"])
        self.mel_bank = rng.standard_normal((n_mels, 8 * self.max_frames), dtype=np.float32) * 0.5

        ag = params.get("agents")
        self.system: List[np.ndarray] = []
        if ag:
            lo_t, hi_t = ag["system_tokens"]
            lens = rng.permutation(np.round(lo_t + _quantiles(ag["count"]) * (hi_t - lo_t)))
            self.system = [self._tokens(int(n)) for n in lens]
            w = np.arange(1, ag["count"] + 1, dtype=np.float64) ** -ag["zipf_s"]
            self._agent_cdf = np.cumsum(w / w.sum())

        arr = params["arrival"]
        self.ramp_s = float(params["ramp_s"])
        self.closed = arr["kind"] == "clients"
        if self.closed:
            n = int(arr["count"])
            starts = rng.permutation(_quantiles(n) * float(arr.get("stagger_s", 0.0)))
            self.sessions = [Session(i, float(s), None, []) for i, s in enumerate(starts)]
            self._pool = self._turns(int(params.get("pool", 8192)))
            self._pool_pos = 0
            self._lock = threading.Lock()
            return
        self.rate = float(rate if rate is not None else arr["rate_per_s"])
        horizon = self.ramp_s + seconds + float(params.get("tail_s", 60.0))
        n_new = int(math.ceil(self.rate * horizon))
        # sessions in progress at the start: the rate times how long a
        # session lasts at this rate (a property of the system, measured)
        n_warm = int(round(self.rate * float(params.get("warm_session_s", 0.0))))
        gaps = rng.permutation(-np.log1p(-_quantiles(n_new)) / self.rate)
        starts = list(np.cumsum(gaps))
        warm_starts = rng.permutation(_quantiles(n_warm) * float(params.get("warm_spread_s", 1.0)))
        lo_n, hi_n = params["turns"]
        n_sess = n_new + n_warm
        n_turns = rng.permutation(lo_n + np.floor(_quantiles(n_sess) * (hi_n - lo_n + 1))).astype(int)
        agents = (rng.permutation(np.searchsorted(self._agent_cdf, _quantiles(n_sess)))
                  if ag else [None] * n_sess)
        pool = self._turns(int(n_turns.sum()))
        self.sessions = []
        k = 0
        for i in range(n_sess):
            turns = pool[k: k + n_turns[i]]
            k += n_turns[i]
            warm = i >= n_new
            s = Session(i, float(warm_starts[i - n_new] if warm else starts[i]),
                        None if agents[i] is None else int(agents[i]), turns)
            if warm:  # in progress: its earlier turns are history already
                s.done = int(rng.integers(1, len(turns))) if len(turns) > 1 else 0
                for t in turns[: s.done]:
                    s.history.append(self.history_entry(t, self._tokens(t.max_tokens)))
            self.sessions.append(s)
        self.sessions.sort(key=lambda s: s.start_s)

    def _tokens(self, n: int) -> np.ndarray:
        n = int(n)
        if self._bank_pos + n > self.token_bank.size:
            self._bank_pos = 0
        out = self.token_bank[self._bank_pos: self._bank_pos + n]
        self._bank_pos += n
        return out

    def _turns(self, n: int) -> List[Turn]:
        p, rng = self.p, self.rng
        secs = stratified(rng, n, p["audio_s"])
        ans = p["answer_tokens"]
        if "per_audio_s" in ans:
            max_toks = np.minimum(np.round(secs * ans["per_audio_s"]), ans["max"])
        else:
            max_toks = np.round(stratified(rng, n, ans))
        tps = float(p.get("transcript_tokens_per_s", 0.0))
        out = []
        for s, mt in zip(secs, max_toks):
            frames = _frames(s)
            off = int(rng.integers(0, self.mel_bank.shape[1] - frames + 1))
            out.append(Turn(float(s), frames, off, int(mt), self._tokens(round(tps * s))))
        return out

    # -- what the load asks --------------------------------------------------

    def next_turn(self, s: Session) -> Optional[Turn]:
        if self.closed:
            with self._lock:
                t = self._pool[self._pool_pos % len(self._pool)]
                self._pool_pos += 1
            return t
        return s.turns[s.done] if s.done < len(s.turns) else None

    def wait_before(self, t: Turn) -> float:
        """Seconds between a session's previous answer and its next turn."""
        if self.closed:
            return 0.0
        return t.audio_s + float(self.p.get("think_s", 0.0))

    def prompt(self, s: Session, t: Turn):
        """(ids, audio start, audio positions, mel (n_mels, frames) f32)."""
        head = ([self.system[s.agent]] if s.agent is not None else []) + s.history
        n_audio = t.frames // 16
        parts = head + [self.before, np.full(n_audio, self.audio_id, np.int64), self.after]
        start = sum(len(x) for x in head) + len(self.before)
        ids = np.concatenate(parts).astype(np.int64)
        return ids, start, n_audio, self.mel(t)

    def mel(self, t: Turn) -> np.ndarray:
        return self.mel_bank[:, t.mel_offset: t.mel_offset + t.frames]

    def history_entry(self, t: Turn, answer: np.ndarray) -> np.ndarray:
        return np.concatenate([self.before, t.transcript, self.after,
                               np.asarray(answer, np.int64)]).astype(np.int64)

    def finished(self, s: Session, t: Turn, answer) -> None:
        s.done += 1
        if self.p.get("history", False):
            s.history.append(self.history_entry(t, answer))
