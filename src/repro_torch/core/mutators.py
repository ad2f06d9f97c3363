"""Trace mutators — the proposal distribution of the evolutionary search.

Each mutator proposes a new trace by perturbing one sampling decision
(paper §4: "proposes a new variant of the trace by mutating the random
variables").  Proposals may leave the support; the validator rejects those.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .schedule import Schedule
from .tir import PrimFunc
from .trace import Trace


class Mutator:
    name = "mutator"

    def apply(self, func: PrimFunc, trace: Trace, rng: np.random.Generator) -> Optional[Trace]:
        raise NotImplementedError


def _divisors(x: int) -> List[int]:
    out = []
    d = 1
    while d * d <= x:
        if x % d == 0:
            out.append(d)
            if d != x // d:
                out.append(x // d)
        d += 1
    return sorted(out)


@dataclass
class MutateTileSize(Mutator):
    """Move a divisor between two positions of a perfect-tile decision —
    preserves the product so the split stays perfect."""

    name = "mutate_tile_size"

    def apply(self, func, trace, rng) -> Optional[Trace]:
        cands = [
            i
            for i, it in enumerate(trace.insts)
            if it.name == "sample_perfect_tile" and it.decision is not None
        ]
        if not cands:
            return None
        idx = int(rng.choice(cands))
        dec = list(trace.insts[idx].decision)
        n = len(dec)
        if n < 2:
            return None
        for _ in range(16):
            a, b = rng.choice(n, size=2, replace=False)
            if dec[a] <= 1:
                continue
            divs = [d for d in _divisors(dec[a]) if d > 1]
            if not divs:
                continue
            d = int(rng.choice(divs))
            new = list(dec)
            new[a] //= d
            new[b] *= d
            maxin = trace.insts[idx].attrs.get("max_innermost_factor", 16)
            if new[-1] > maxin:
                continue
            return trace.with_decision(idx, new)
        return None


@dataclass
class MutateCategorical(Mutator):
    """Resample one categorical decision from its prior."""

    name = "mutate_categorical"

    def apply(self, func, trace, rng) -> Optional[Trace]:
        cands = [
            i
            for i, it in enumerate(trace.insts)
            if it.name == "sample_categorical"
        ]
        if not cands:
            return None
        idx = int(rng.choice(cands))
        it = trace.insts[idx]
        k = len(it.attrs["candidates"])
        if k < 2:
            return None
        choices = [c for c in range(k) if c != it.decision]
        return trace.with_decision(idx, int(rng.choice(choices)))


@dataclass
class MutateComputeLocation(Mutator):
    """Re-draw a compute-at location conditioned on the replayed prefix
    state (the paper's state-dependent sampling distribution)."""

    name = "mutate_compute_location"

    def apply(self, func, trace, rng) -> Optional[Trace]:
        cands = [
            i
            for i, it in enumerate(trace.insts)
            if it.name == "sample_compute_location"
        ]
        if not cands:
            return None
        idx = int(rng.choice(cands))
        # replay prefix to count valid candidate locations in current state
        sch = Schedule(func, seed=None)
        prefix = Trace(trace.insts[:idx])
        try:
            prefix.replay(sch)
            block = trace.insts[idx].inputs[0]
            # remap: block rv is positional; find by replaying — the block
            # name is stable across replays (names derive from block defs)
            n_locs = len(sch.compute_location_candidates(block))
        except Exception:
            n_locs = 0
        options = list(range(-2, n_locs))
        options = [o for o in options if o != trace.insts[idx].decision]
        if not options:
            return None
        return trace.with_decision(idx, int(rng.choice(options)))


DEFAULT_MUTATORS: List[Mutator] = [
    MutateTileSize(),
    MutateTileSize(),  # weighted: tile mutations dominate (as in TVM)
    MutateCategorical(),
    MutateComputeLocation(),
]


def mutate(
    func: PrimFunc,
    trace: Trace,
    rng: np.random.Generator,
    mutators: Optional[List[Mutator]] = None,
) -> Optional[Trace]:
    muts = mutators or DEFAULT_MUTATORS
    order = rng.permutation(len(muts))
    for i in order:
        t = muts[i].apply(func, trace, rng)
        if t is not None:
            return t
    return None
