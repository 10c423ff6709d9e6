"""The one traffic generator: it reads a mix's parameters (a file under
``traffic/``) and draws the cell's inputs from the seed. Plain numpy; the
program gets only what it draws.

Token ids follow a Zipf law over the vocabulary (``zipf_a``), the law of
``repro_torch.data.loader.write_token_shards``, drawn here by inverse CDF
from the benchmark's own generator. Every seed gives the same sizes: a
prefill mix's requests come in cycles of the same prompt lengths and the
same gaps between arrivals (fixed quantiles of the mix's laws), in an
order that is the same for every seed, so that a seed changes the tokens
and never the work or the queue: the tail of an open loop's waiting
times hangs on the order in which long prompts and short gaps come.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, NamedTuple, Optional

import numpy as np

#: tokens in a prefill mix's pool, from which each prompt is a slice
POOL = 1 << 22


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream ``stream`` of the run's seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def zipf_tokens(r: np.random.Generator, n: int, vocab: int,
                a: float) -> np.ndarray:
    """``n`` int32 ids in [0, vocab), P(id) proportional to (id + 1)^-a."""
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -a)
    cdf /= cdf[-1]
    ids = np.searchsorted(cdf, r.random(n), side="right")
    return np.minimum(ids, vocab - 1).astype(np.int32)


def train_rows(mix: Dict, vocab: int, seed: int) -> np.ndarray:
    """(shards * rows_per_shard, seq + 1) int32 rows: each gives a
    training row's tokens and its labels shifted by one."""
    n = mix["shards"] * mix["rows_per_shard"]
    toks = zipf_tokens(rng(seed, 1), n * (mix["seq"] + 1), vocab,
                       mix["zipf_a"])
    return toks.reshape(n, mix["seq"] + 1)


class Request(NamedTuple):
    """One prompt: when it arrives (seconds from the window's start), its
    length and its token ids."""
    arrival: float
    length: int
    tokens: np.ndarray


def prompt_lengths(mix: Dict) -> np.ndarray:
    """A cycle's prompt lengths: ``per_cycle`` quantiles, at (i + 1/2) /
    per_cycle, of a log-normal law of median ``length_median`` and spread
    ``length_sigma``, rounded and held to [length_min, length_max]."""
    n = mix["per_cycle"]
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    L = np.exp(np.log(mix["length_median"]) + mix["length_sigma"] * np.array(z))
    return np.clip(np.rint(L), mix["length_min"], mix["length_max"]).astype(int)


def arrival_gaps(mix: Dict, rate: float) -> np.ndarray:
    """A cycle's gaps between arrivals: ``per_cycle`` quantiles of the
    exponential law (Poisson arrivals), scaled so that the cycle lasts
    per_cycle / rate seconds."""
    n = mix["per_cycle"]
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    return g * (n / rate) / g.sum()


class Arrivals:
    """The requests of an open-loop prefill mix, in arrival order. Each
    cycle of ``per_cycle`` requests takes the same lengths and the same
    gaps, each in an order drawn from a stream that is the same for every
    seed (a window as long as a cycle holds one whole cycle); each prompt
    is a slice of a Zipf pool at an offset drawn from the seed."""

    def __init__(self, mix: Dict, vocab: int, seed: int,
                 rate: Optional[float] = None):
        self.rate = float(rate or mix["rate_per_s"])
        self.lengths = prompt_lengths(mix)
        self.gaps = arrival_gaps(mix, self.rate)
        self._order = rng(0, 2)
        self._offsets = rng(seed, 3)
        self.pool = zipf_tokens(rng(seed, 4), POOL, vocab, mix["zipf_a"])
        self._queue: List[Request] = []
        self._t = self._end = 0.0

    def prompts(self, rows: int, length: int) -> np.ndarray:
        offs = self._offsets.integers(0, POOL - length, size=rows)
        return np.stack([self.pool[o:o + length] for o in offs])

    def _cycle(self) -> None:
        """Queue a cycle: its first request arrives at the cycle's start,
        the next after a gap, so that a window of per_cycle / rate
        seconds from a cycle's start holds that cycle exactly."""
        lengths = self._order.permutation(self.lengths)
        gaps = self._order.permutation(self.gaps)
        t = self._t
        for L, g in zip(lengths, gaps):
            self._queue.append(Request(t, int(L), self.prompts(1, int(L))[0]))
            t += float(g)
        self._t += float(self.gaps.sum())

    def until(self, seconds: float) -> List[Request]:
        """The next requests to arrive within ``seconds`` of the last
        call's end, their arrivals counted from that end."""
        start, out = self._end, []
        while True:
            if not self._queue:
                self._cycle()
            if self._queue[0].arrival - start >= seconds:
                break
            r = self._queue.pop(0)
            out.append(r._replace(arrival=r.arrival - start))
        self._end = start + seconds
        return out
