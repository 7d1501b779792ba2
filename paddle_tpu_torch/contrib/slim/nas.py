"""Light-NAS: simulated-annealing architecture search (the JAX package's
contrib/slim/nas.py, a copy: it is numpy only; after the reference's
slim/nas/light_nas_strategy.py and slim/searcher/controller.py
SAController).

The reference splits the search between a controller server and client
agents because its trials run in separate GPU processes; here a trial is
one short training run in the calling process, so the whole loop lives
in-process. The controller's Metropolis acceptance over a token range
table is the reference's.

Contract:
  * a SearchSpace gives `init_tokens()`, `range_table()` (tokens[i] in
    [0, range_table[i])), and `eval_tokens(tokens) -> (reward, flops)`;
  * `LightNASStrategy.search()` anneals and returns the best tokens seen,
    honoring `max_flops` through the controller's constraint hook.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["SAController", "LightNASStrategy"]


class SAController:
    """Simulated-annealing evolutionary controller (reference
    slim/searcher/controller.py SAController)."""

    def __init__(self, range_table=None, reduce_rate=0.85,
                 init_temperature=1024.0, max_iter_number=300, seed=None):
        self._range_table = range_table
        self._reduce_rate = float(reduce_rate)
        self._init_temperature = float(init_temperature)
        self._max_iter_number = int(max_iter_number)
        self._reward = -1.0
        self._tokens = None
        self._max_reward = -1.0
        self._best_tokens = None
        self._iter = 0
        self._constrain_func = None
        self._rng = np.random.default_rng(seed)

    def reset(self, range_table, init_tokens, constrain_func=None):
        self._range_table = list(range_table)
        self._tokens = list(init_tokens)
        self._constrain_func = constrain_func
        self._iter = 0

    def update(self, tokens, reward):
        """Metropolis acceptance at geometrically cooling temperature."""
        self._iter += 1
        temperature = self._init_temperature * \
            self._reduce_rate ** self._iter
        if (reward > self._reward) or (self._rng.random() <= math.exp(
                min((reward - self._reward) / max(temperature, 1e-9), 50))):
            self._reward = reward
            self._tokens = list(tokens)
        if reward > self._max_reward:
            self._max_reward = reward
            self._best_tokens = list(tokens)

    def next_tokens(self):
        """Mutate one random position; retry until the constraint admits
        the candidate (reference next_tokens loop)."""
        for _ in range(1000):
            tokens = list(self._tokens)
            pos = int(self._rng.integers(len(tokens)))
            # reference offset-mod formula: the mutation ALWAYS lands on a
            # different value, so no trial evaluates an unchanged
            # architecture (a degenerate range of 1 keeps the value)
            r = self._range_table[pos]
            if r > 1:
                tokens[pos] = (tokens[pos]
                               + int(self._rng.integers(r - 1)) + 1) % r
            if self._constrain_func is None or self._constrain_func(tokens):
                return tokens
        raise RuntimeError("SAController: constraint rejected 1000 "
                           "consecutive candidates")

    @property
    def best_tokens(self):
        return self._best_tokens

    @property
    def max_reward(self):
        return self._max_reward


class LightNASStrategy:
    """The search loop (reference light_nas_strategy.py, in-process).

    search_space must provide:
      init_tokens() -> list[int]
      range_table() -> list[int]
      eval_tokens(tokens) -> (reward: float, flops: float)
    """

    def __init__(self, search_space, max_flops=None, search_steps=50,
                 reduce_rate=0.85, init_temperature=1024.0, seed=None):
        self.space = search_space
        self.max_flops = max_flops
        self.search_steps = int(search_steps)
        self.controller = SAController(
            reduce_rate=reduce_rate, init_temperature=init_temperature,
            max_iter_number=search_steps, seed=seed)
        self._flops_cache: dict = {}

    def _admit(self, tokens):
        if self.max_flops is None:
            return True
        key = tuple(tokens)
        if key not in self._flops_cache:
            self._flops_cache[key] = float(self.space.flops(tokens))
        return self._flops_cache[key] <= self.max_flops

    def search(self):
        """Run the annealed search; returns (best_tokens, best_reward)."""
        init = self.space.init_tokens()
        constrain = self._admit if (self.max_flops is not None
                                    and hasattr(self.space, "flops")) \
            else None
        self.controller.reset(self.space.range_table(), init, constrain)
        reward, _ = self.space.eval_tokens(init)
        self.controller.update(init, reward)
        for _ in range(self.search_steps):
            tokens = self.controller.next_tokens()
            reward, _ = self.space.eval_tokens(tokens)
            self.controller.update(tokens, reward)
        return self.controller.best_tokens, self.controller.max_reward
