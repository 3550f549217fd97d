"""Speech-like 8 kHz audio made from the seed.

Every seed gets the same durations (the quantiles of the mix's law,
shuffled by the seed), so a seed changes the order and the content of
the work and not its amount.  An utterance is speech with pauses: in
every ``period_s`` a pause of ``pause_s`` (uniform in the range) at a
random offset holds low-energy noise (``pause_rms``); the rest is noise
through a short random filter (a per-utterance spectral envelope) at
``speech_rms``, amplitude-modulated at a syllable rate.  So about 30% of
the frames are unvoiced and the energy VAD and voiced-frame selection
do real work, as they do on telephone speech; white noise at one level
would be all voiced.

The samples are made on the device in a few large calls, from a
`torch.Generator` seeded with the run's seed, and copied to the host
once, where the program takes them as it takes decoded audio.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

FIR_TAPS = 16


def durations(law: Dict, n: int) -> np.ndarray:
    """``n`` durations in seconds: the quantiles (i + 0.5) / n of the law."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(law["min"]), float(law["max"])
    if law["law"] == "log_uniform":
        return lo * (hi / lo) ** q
    if law["law"] == "uniform":
        return lo + (hi - lo) * q
    raise ValueError(f"unknown duration law {law['law']!r}")


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_pool(secs: np.ndarray, audio: Dict, seed: int, device: torch.device) -> List[np.ndarray]:
    """One float32 host array per duration (samples at ``sample_rate``)."""
    sr = int(audio["sample_rate"])
    lens = [int(round(s * sr)) for s in secs]
    total = sum(lens)
    g = generator(seed, device)
    noise = torch.randn(total + FIR_TAPS * len(lens), generator=g, device=device)
    per = torch.rand((len(lens), 2), generator=g, device=device)  # syllable phase, spare
    fir = torch.randn((len(lens), FIR_TAPS), generator=g, device=device)
    fir = fir / fir.norm(dim=1, keepdim=True)
    period = int(round(audio["period_s"] * sr))
    p_lo, p_hi = (int(round(x * sr)) for x in audio["pause_s"])
    n_periods = [-(-n // period) for n in lens]
    draws = torch.rand((sum(n_periods), 2), generator=g, device=device)
    out = torch.empty(total, dtype=torch.float32, device=device)
    off = pos = row = 0
    for u, n in enumerate(lens):
        x = noise[pos:pos + n + FIR_TAPS]
        speech = sum(fir[u, k] * x[FIR_TAPS - k:FIR_TAPS - k + n] for k in range(FIR_TAPS))
        t = torch.arange(n, device=device, dtype=torch.float32)
        env = 0.55 + 0.45 * torch.sin(2 * math.pi * audio["syllable_hz"] / sr * t
                                      + 2 * math.pi * per[u, 0])
        d = draws[row:row + n_periods[u]]
        plen = (p_lo + (p_hi - p_lo) * d[:, 0]).floor()
        pstart = ((period - plen) * d[:, 1]).floor()
        k = (t // period).long()
        q = t - k * period
        in_pause = (q >= pstart[k]) & (q < pstart[k] + plen[k])
        out[off:off + n] = torch.where(in_pause, audio["pause_rms"] * x[FIR_TAPS:],
                                       audio["speech_rms"] * env * speech)
        off, pos, row = off + n, pos + n + FIR_TAPS, row + n_periods[u]
    host = out.cpu().numpy()
    bounds = np.cumsum([0] + lens)
    return [host[bounds[i]:bounds[i + 1]] for i in range(len(lens))]


def shuffled(secs: np.ndarray, seed: int) -> np.ndarray:
    """The durations in the seed's order."""
    return secs[np.random.default_rng(int(seed)).permutation(len(secs))]
