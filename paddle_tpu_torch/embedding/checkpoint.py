"""Streaming delta checkpoints for host-tier embedding shards (the JAX
package's embedding/checkpoint.py, copied).

A giant table makes a save-everything checkpoint untenable: the host
tier is most of the model's bytes and almost none of it changes between two
saves. This provider rides the CheckpointManager state-provider hook
(resilience/checkpoint.py):

  * BASE snapshots — the full host tier, written atomically to the
    checkpoint ROOT (`emb_<table>.base_<step>.npz`) every
    FLAGS_emb_ckpt_base_every saves (and whenever no live base exists). The
    last two bases are kept so every retained step directory's delta stays
    restorable across base rotation.
  * DELTAS — every step-directory save writes only the rows dirtied since
    the current base (`emb_<table>.delta.npz` inside the atomic step dir),
    CUMULATIVE against that base: restore never needs a chain, just
    base + the one delta riding the restored step, and a crash between
    delta saves cannot lose rows.

Restore = load base, apply delta, reset the device cache cold (the host
tier is authoritative; slots refill on first touch), and re-mark the delta's
rows dirty so the next delta stays consistent with the restored base.
"""
from __future__ import annotations

import glob
import os
import re
import tempfile

import numpy as np

__all__ = ["EmbeddingStateProvider"]

_BASE_RE = re.compile(r"\.base_(\d{8})\.npz$")


def _atomic_savez(path: str, **arrays) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".emb_base.", suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class EmbeddingStateProvider:
    """One engine's host-tier state, spliced into CheckpointManager saves."""

    name = "tiered_embedding"

    def __init__(self, engine):
        self._engine = engine
        self._base_step: dict[str, int] = {}   # table -> live base step
        self._saves_since: dict[str, int] = {}

    # -- save -----------------------------------------------------------------
    def _base_path(self, root: str, table: str, step: int) -> str:
        return os.path.join(root, f"emb_{table}.base_{step:08d}.npz")

    def _gc_bases(self, root: str, table: str) -> None:
        paths = sorted(glob.glob(
            os.path.join(root, f"emb_{table}.base_*.npz")))
        for p in paths[:-2]:  # keep the live base + one predecessor
            try:
                os.unlink(p)
            except OSError:
                pass

    def save_state(self, manager, tmp_dir: str, step: int, executor=None,
                   program=None, scope=None) -> dict:
        from .. import flags

        if executor is not None and hasattr(executor, "wait"):
            executor.wait()  # write-backs + cache values must be final
        self._engine.flush_cache(scope)
        base_every = max(1, int(flags.get_flag("emb_ckpt_base_every")))
        frag: dict = {"tables": {}}
        for tname, ts in self._engine.tables.items():
            host = ts.host
            base = self._base_step.get(tname)
            need_base = (base is None
                         or self._saves_since.get(tname, 0) + 1 >= base_every
                         or not os.path.exists(
                             self._base_path(manager.root, tname, base)))
            if need_base:
                arrays = {f"shard_{i}": sh
                          for i, sh in enumerate(host.shards)}
                arrays["bounds"] = host.bounds
                _atomic_savez(self._base_path(manager.root, tname, step),
                              **arrays)
                host.clear_dirty()
                self._base_step[tname] = base = step
                self._saves_since[tname] = 0
                self._gc_bases(manager.root, tname)
            else:
                self._saves_since[tname] = self._saves_since.get(tname, 0) + 1
            rows = host.dirty_rows()
            np.savez(os.path.join(tmp_dir, f"emb_{tname}.delta.npz"),
                     rows=rows, values=host.gather(rows) if rows.size
                     else np.zeros((0, host.dim), host.dtype))
            frag["tables"][tname] = {
                "base_step": int(base),
                "delta_rows": int(rows.size),
                "vocab": host.vocab, "dim": host.dim,
            }
        return frag

    # -- restore --------------------------------------------------------------
    def restore_state(self, manager, step_dir: str, step: int,
                      frag: dict | None, executor=None, program=None,
                      scope=None) -> None:
        if not frag:
            return
        for tname, tfrag in (frag.get("tables") or {}).items():
            ts = self._engine.tables.get(tname)
            if ts is None:
                continue
            host = ts.host
            base_step = int(tfrag["base_step"])
            base_path = self._base_path(manager.root, tname, base_step)
            if not os.path.exists(base_path):
                raise FileNotFoundError(
                    f"tiered table '{tname}': base snapshot for step "
                    f"{base_step} is gone ({base_path}) — this checkpoint's "
                    f"delta is unrestorable")
            with np.load(base_path) as z:
                shards = [z[f"shard_{i}"].astype(host.dtype, copy=True)
                          for i in range(len(z.files) - 1)]
                bounds = z["bounds"].astype(np.int64)
            if sum(len(s) for s in shards) != host.vocab:
                raise ValueError(
                    f"tiered table '{tname}': base snapshot rows "
                    f"!= vocab {host.vocab}")
            # adopt the snapshot's shard layout wholesale — a changed
            # FLAGS_emb_host_shards between runs must not corrupt a restore
            host.shards = shards
            host.bounds = bounds
            host.num_shards = len(shards)
            with np.load(os.path.join(step_dir,
                                      f"emb_{tname}.delta.npz")) as z:
                rows, values = z["rows"], z["values"]
            if rows.size:
                host.scatter(rows, values)
            host.set_dirty(rows)
            self._base_step[tname] = base_step
            self._saves_since[tname] = 0
        self._engine.reset_cache()
