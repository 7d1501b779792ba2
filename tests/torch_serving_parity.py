"""Shared plumbing of the port's serving tests on `decoder_tiny`: one JAX
engine's weights carried into every port engine (`load_params`), so the
port's engines, replicas and role-split fleets compute the JAX package's
function, and the JAX engine's own runs are the reference."""
import functools

import numpy as np

from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import decoder_tiny as j_tiny
from paddle_tpu_torch.serving import ServingEngine, decoder_tiny, load_params

# page size 4 and a 64-page pool: prompts of 4-6 tokens cross page and
# bucket boundaries within a few decode steps
ENGINE_KW = dict(page_size=4, pool_pages=64, max_inflight=4, draft_k=0,
                 seed=0)


def prompt(seed: int, n: int) -> list:
    return np.random.default_rng(seed).integers(1, 97, n).tolist()


def fleet_prompts(n: int, seed: int = 7) -> list:
    """The JAX fleet tests' prompts: 4-6 tokens each."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, size=4 + i % 3).tolist() for i in range(n)]


def jax_engine(**kw) -> JEngine:
    return JEngine(j_tiny(), **dict(ENGINE_KW, **kw))


@functools.lru_cache(maxsize=1)
def jax_params() -> dict:
    """decoder_tiny's parameters as the JAX engine initializes them at seed
    0 (every seed-0 JAX engine holds these)."""
    jeng = jax_engine()
    return {p.name: np.asarray(jeng._scope.find_var(p.name))
            for p in jeng._prefill_prog.all_parameters()}


@functools.lru_cache(maxsize=1)
def _jax_oracle_engine() -> JEngine:
    return jax_engine()


def jax_oracle(prompts, max_new) -> list:
    """The JAX engine's greedy tokens for `prompts` (one engine a process:
    greedy decoding is a function of the weights and the prompt, and
    speculative decoding gives the same sequence)."""
    eng = _jax_oracle_engine()
    rids = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_drained()
    out = [eng.result(r) for r in rids]
    eng.prune_finished()
    return out


def port_engine(**kw) -> ServingEngine:
    """A port engine on the CPU holding the JAX engine's weights."""
    eng = ServingEngine(decoder_tiny(), device="cpu", **dict(ENGINE_KW, **kw))
    load_params(eng, jax_params())
    return eng


def drain(eng, prompts, max_new):
    """Submit `prompts` together and drain; returns (outputs, rids)."""
    rids = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_drained()
    return [eng.result(r) for r in rids], rids
