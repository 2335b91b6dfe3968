"""Host-side audio DSP: resampling.

scipy's polyphase ``resample_poly``, with numpy linear interpolation where
scipy is missing. (The JAX package first tries a g++-built C++ resampler
of its own, host code that is not copied here.)
"""

from __future__ import annotations

import math

import numpy as np


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    try:
        from scipy.signal import resample_poly
    except ImportError:
        n_out = int(round(len(audio) * target_sr / orig_sr))
        x_old = np.linspace(0.0, 1.0, num=len(audio), endpoint=False)
        x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
        return np.interp(x_new, x_old, audio).astype(np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(np.asarray(audio, dtype=np.float32), target_sr // g, orig_sr // g)
    return out.astype(np.float32)
