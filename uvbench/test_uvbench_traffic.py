"""The serving traffic generator: seeded, reproducible, and the same sizes
for every seed in another order."""

import json
from pathlib import Path

import numpy as np
import pytest

from uvbench import traffic

HERE = Path(__file__).resolve().parent


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _summary(plan):
    out = []
    for s in plan.sessions[:50]:
        turns = s.turns or [plan.next_turn(s) for _ in range(3)]
        out.append((round(s.start_s, 9), s.agent, s.done,
                    tuple((t.frames, t.mel_offset, t.max_tokens, t.transcript.tobytes())
                          for t in turns)))
    return out


@pytest.mark.parametrize("mix", ["voice_sessions", "transcribe_batch"])
def test_same_seed_same_traffic(mix):
    a = traffic.Plan(_mix(mix), 131072, 128, 2**31 + 77, 30.0)
    b = traffic.Plan(_mix(mix), 131072, 128, 2**31 + 77, 30.0)
    assert _summary(a) == _summary(b)
    s = a.sessions[0]
    ids_a, start_a, n_a, mel_a = a.prompt(s, a.next_turn(s) if not a.closed else a._pool[0])
    s = b.sessions[0]
    ids_b, start_b, n_b, mel_b = b.prompt(s, b.next_turn(s) if not b.closed else b._pool[0])
    assert (start_a, n_a) == (start_b, n_b)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(mel_a, mel_b)


@pytest.mark.parametrize("mix", ["voice_sessions", "transcribe_batch"])
def test_other_seed_other_order_same_sizes(mix):
    a = traffic.Plan(_mix(mix), 131072, 128, 11, 30.0)
    b = traffic.Plan(_mix(mix), 131072, 128, 12, 30.0)
    assert _summary(a) != _summary(b)

    def turns(p):
        return p._pool if p.closed else [t for s in p.sessions for t in s.turns]

    for key in ("frames", "max_tokens"):
        assert sorted(getattr(t, key) for t in turns(a)) == sorted(getattr(t, key) for t in turns(b))
    if not a.closed:
        for p in (a, b):
            assert len(p.sessions) == len(a.sessions)
        arrivals = [sorted(s.start_s for s in p.sessions if not s.history and s.done == 0)
                    for p in (a, b)]
        assert arrivals[0] != arrivals[1]
        assert sorted(np.diff([0.0] + arrivals[0])) == pytest.approx(
            sorted(np.diff([0.0] + arrivals[1])))


def test_audio_is_whole_positions_and_fits_the_tower():
    p = traffic.Plan(_mix("transcribe_batch"), 131072, 128, 5, 30.0)
    assert all(t.frames % 16 == 0 and 16 <= t.frames <= 3000 for t in p._pool)
    q = traffic.Plan(_mix("voice_sessions"), 131072, 128, 5, 30.0)
    s = next(s for s in q.sessions if s.history)
    ids, start, n_audio, mel = q.prompt(s, q.next_turn(s))
    assert mel.shape == (128, n_audio * 16)
    assert (ids[start:start + n_audio] == q.audio_id).all()
    assert ids[: len(q.system[s.agent])].tolist() == q.system[s.agent].tolist()
