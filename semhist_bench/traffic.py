"""The one traffic generator: every mix is a data file of parameters under
``traffic/``, read here.

A mix's keys:

  ``loop``            ``"open"`` (arrivals on a schedule, whether or not
                      earlier plans returned) or ``"closed"`` (sessions that
                      each send their next query when their plan returns)
  ``rate_per_s``      open loop: plans offered per second
  ``sessions``        closed loop: concurrent planner sessions
  ``filters``         the filter counts a query takes, drawn uniformly: the
                      counts cycle in blocks shuffled by the seed, so every
                      seed offers the same mix in another order
  ``pool``            where filters come from: ``"predicate_nodes"`` (up to
                      ``max_per_depth`` nodes of every depth, as the
                      recipe's ``Corpus.predicate_nodes``) or ``"leaves"``
                      (leaves whose true selectivity lies under
                      ``max_selectivity``); the pool comes from the tree's
                      shape seed, so every run seed draws from the same
                      predicates, dealt like cards: each pool predicate
                      once before any twice
  ``warmup_queries``  plans run before the window, from their own stream

Every query carries its own text seed, so the predicate cache sees a new
embedding for every filter. Open-loop gaps are the quantiles of an
exponential distribution at the offered rate, shuffled by the seed and
scaled to the window: every seed offers exactly ``rate * seconds`` plans in
the window, at Poisson-like gaps in another order.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from semhist_bench.corpus import Tree, rng_for

QUERY_SEED_LIMIT = 1 << 31


def load_mix(path: pathlib.Path) -> dict:
    mix = json.loads(pathlib.Path(path).read_text())
    if mix.get("loop") not in ("open", "closed"):
        raise ValueError(f"{path}: loop must be 'open' or 'closed'")
    if mix["loop"] == "open" and not mix.get("rate_per_s", 0) > 0:
        raise ValueError(f"{path}: an open loop needs rate_per_s > 0")
    if mix["loop"] == "closed" and not mix.get("sessions", 0) >= 1:
        raise ValueError(f"{path}: a closed loop needs sessions >= 1")
    if not mix.get("filters") or min(mix["filters"]) < 1:
        raise ValueError(f"{path}: filters must list counts >= 1")
    return mix


def predicate_pool(tree: Tree, mix: dict) -> np.ndarray:
    """The node ids the mix draws its filters from."""
    pool = mix.get("pool", "predicate_nodes")
    if pool == "predicate_nodes":
        rng = rng_for(tree.shape_seed, 10)
        per = int(mix.get("max_per_depth", 8))
        out = []
        for d in range(int(tree.depth.max()) + 1):
            nodes = np.flatnonzero(tree.depth == d)
            rng.shuffle(nodes)
            out.extend(nodes[:per].tolist())
        ids = np.asarray(out, np.int64)
    elif pool == "leaves":
        sel = (tree.hi - tree.lo) / tree.n
        cap = float(mix.get("max_selectivity", 1.0))
        ids = np.asarray([leaf for leaf in tree.leaves
                          if 0 < sel[leaf] < cap], np.int64)
    else:
        raise ValueError(f"unknown predicate pool {pool!r}")
    if len(ids) < max(mix["filters"]):
        raise ValueError(f"pool {pool!r} holds {len(ids)} predicates, fewer "
                         f"than a query's {max(mix['filters'])} filters")
    return ids


class QueryStream:
    """An endless, seeded stream of (filters, text seed) queries."""

    def __init__(self, tree: Tree, mix: dict, seed: int, purpose: int = 11):
        self.pool = predicate_pool(tree, mix)
        self.sizes = list(mix["filters"])
        self.rng = rng_for(seed, purpose)
        self._block: list[int] = []
        self._deck: list[int] = []

    def __iter__(self):
        return self

    def __next__(self) -> tuple[tuple[int, ...], int]:
        if not self._block:
            self._block = list(self.rng.permutation(self.sizes))
        size = int(self._block.pop())
        nodes: list[int] = []
        while len(nodes) < size:
            if not self._deck:
                self._deck = [int(x) for x in self.rng.permutation(self.pool)]
            pick = next((i for i, n in enumerate(self._deck)
                         if n not in nodes), None)
            if pick is None:     # the deck's rest is in this query already
                self._deck += [int(x) for x in self.rng.permutation(self.pool)]
                continue
            nodes.append(self._deck.pop(pick))
        qseed = int(self.rng.integers(QUERY_SEED_LIMIT))
        return tuple(nodes), qseed

    def take(self, n: int) -> list[tuple[tuple[int, ...], int]]:
        return [next(self) for _ in range(n)]


def open_schedule(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Due offsets in seconds, from 0, of the plans an open loop offers in
    a window of ``seconds``."""
    rate = float(mix["rate_per_s"])
    m = max(1, int(round(rate * seconds)))
    q = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-q) / rate
    rng_for(seed, 12).shuffle(gaps)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
