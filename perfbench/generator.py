"""The one traffic generator: it reads a mix's parameters (a
``traffic/<mix>.json`` data file) and makes the requests of a run from
``--seed``.

Lengths, tenants and gaps between arrivals are drawn by stratified
sampling in blocks: within each block of ``block`` requests every seed
gets the same set of values, each at the mid-point of one of ``block``
equal-probability strata. Tenants come in an order the seed permutes.
Lengths and gaps come in an order the seed permutes too, unless the mix
says ``"fixed_order": true``: then every seed sends the same sizes at the
same times, and two seeds differ only in which tenant each request goes
to and in the prompts' token ids (in a closed loop, which request ends
first decides who sends next, so an order the seed permutes changes how
much work falls in the window).
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

from .world import leaf_seed


def _rng(seed: int, *parts) -> np.random.Generator:
    return np.random.default_rng(leaf_seed(seed, *parts))


def quantile_fn(spec: dict, n_values: int = 0):
    """The quantile function ``p -> value`` of a length or tenant
    distribution: ``uniform`` integers in ``[min, max]``, ``lognormal``
    (``median``, ``sigma``) clipped to ``[min, max]``, ``zipf`` over
    ``n_values`` tenants (weight ``1 / (rank + 1) ** s``), or
    ``exponential`` (``mean``) for gaps between arrivals."""
    dist = spec["dist"]
    if dist == "uniform":
        lo, hi = spec["min"], spec["max"]
        return lambda p: lo + min(int(p * (hi - lo + 1)), hi - lo)
    if dist == "lognormal":
        nd = NormalDist(math.log(spec["median"]), spec["sigma"])
        return lambda p: int(min(max(round(math.exp(nd.inv_cdf(p))),
                                     spec["min"]), spec["max"]))
    if dist == "zipf":
        w = np.array([1.0 / (r + 1) ** spec["s"] for r in range(n_values)])
        cdf = np.cumsum(w / w.sum())
        return lambda p: int(min(np.searchsorted(cdf, p, side="right"),
                                 n_values - 1))
    if dist == "exponential":
        return lambda p: -spec["mean"] * math.log(1.0 - p)
    raise ValueError(f"unknown distribution {dist!r}")


class Mix:
    """The requests of one run of a traffic mix. ``request(j)`` is the
    j-th request a driver sends: its tenant, prompt token ids (uniform
    over ``[1, vocab)``) and ``max_new_tokens``."""

    def __init__(self, mix: dict, seed: int, vocab: int, tenants: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.block = int(mix.get("block", 64))
        self._q = {"prompt": quantile_fn(mix["prompt_tokens"]),
                   "output": quantile_fn(mix["output_tokens"]),
                   "tenant": quantile_fn(mix["tenants"], tenants)}
        if "rate_per_s" in mix:
            self._q["gap"] = quantile_fn(
                {"dist": "exponential", "mean": 1.0 / mix["rate_per_s"]})
        self._blocks: Dict[tuple, List[float]] = {}

    def _draw(self, what: str, j: int):
        b, i = divmod(j, self.block)
        key = (what, b)
        if key not in self._blocks:
            fixed = self.mix.get("fixed_order") and what != "tenant"
            order = _rng(0 if fixed else self.seed, "order", what,
                         b).permutation(self.block)
            q = self._q[what]
            self._blocks[key] = [q((k + 0.5) / self.block) for k in order]
        return self._blocks[key][i]

    def request(self, j: int) -> dict:
        n = self._draw("prompt", j)
        ids = _rng(self.seed, "ids", j).integers(1, self.vocab, n)
        return {"index": j, "tenant": self._draw("tenant", j),
                "prompt": ids.tolist(),
                "max_new_tokens": self._draw("output", j)}

    def arrivals(self, horizon_s: float) -> List[float]:
        """Send times of an open loop, seconds from its start, up to
        ``horizon_s``."""
        out, t, j = [], 0.0, 0
        while True:
            t += self._draw("gap", j)
            if t >= horizon_s:
                return out
            out.append(t)
            j += 1
