"""CheckpointManager: atomic, versioned, self-describing train checkpoints
(the JAX package's resilience/checkpoint.py).

Layered on io.save_sharded/load_sharded. A checkpoint root looks like:

    root/
      step_00000010/
        manifest.json     step, program hash, RNG run-counter, var names
        state/            one .npy a persistable var (save_vars' files)
      step_00000020/
        ...

Guarantees the bare save_sharded cannot give:

  * atomic visibility — a step directory appears under its final name only
    after every byte (state + manifest) is on disk and fsync'd; a crash
    mid-save leaves a `.tmp-*` orphan that the next GC sweeps, never a
    half-checkpoint that a resume could trust;
  * versioning + GC — per-step directories, keep-last-k pruning;
  * provenance — the manifest records the program hash (the JAX package's
    hash of the same program: both hash `Program.to_dict()`, which the two
    packages build alike) and the scope's RNG run-counter (so
    counter-derived randomness continues, not restarts, after resume);
  * rollback — restore() walks steps newest-first, quarantines unreadable or
    corrupt candidates to `.corrupt-*`, and falls back to the newest good
    one.

State providers splice extra files into the atomic step directory; a
program that carries a tiered-embedding engine gets its host tier's delta
provider without wiring (embedding/checkpoint.py). The port has no global
scope: the manager takes its scope at construction or per call. The
commit is rank 0's, or the only process's when no process group runs.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import warnings

__all__ = ["CheckpointManager"]

_MANIFEST = "manifest.json"
_STATE = "state"
_STEP_PREFIX = "step_"
_GUARD_EVENTS = "guard_events.json"
_FORMAT = 1


def _program_hash(program) -> str:
    blob = json.dumps(program.to_dict(), sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _is_primary() -> bool:
    """Rank 0 of the process group, or the only process when none runs."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # e.g. platforms without O_RDONLY dirs
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, root: str, keep_last_k: int | None = None,
                 main_program=None, scope=None):
        from .. import flags

        self.root = os.path.abspath(root)
        self.keep_last_k = (flags.get_flag("ckpt_keep_last_k")
                            if keep_last_k is None else int(keep_last_k))
        self._program = main_program
        self._scope = scope
        os.makedirs(self.root, exist_ok=True)
        # numeric-guard forensic record (resilience/guardrails.StepGuard):
        # every skip/rewind lands here, is mirrored into each saved manifest, AND
        # persists in root/guard_events.json — so the post-mortem survives a
        # process restart even if no save follows the event.
        # steps()/latest_step() never see this file.
        self._guard_events: list[dict] = self._load_guard_events()
        # auxiliary state providers (e.g. the tiered-embedding host tier,
        # embedding/checkpoint.py): each writes extra files into the atomic
        # step directory at save and re-reads them at restore, with its
        # manifest fragment under manifest["extra"][provider.name]
        self._providers: list = []

    # -- auxiliary state providers -------------------------------------------
    def register_state_provider(self, provider) -> None:
        """provider contract: `.name`, `.save_state(manager, tmp_dir, step,
        executor=, program=, scope=) -> frag`, `.restore_state(manager,
        step_dir, step, frag, executor=, program=, scope=)`."""
        self._providers.append(provider)

    def _providers_for(self, program) -> list:
        """Registered providers, plus auto-discovery: a program carrying a
        tiered-embedding engine (passes.rewrite_tiered_embeddings) gets its
        host-tier delta provider without explicit wiring."""
        engine = getattr(program, "_tiered_engine", None)
        if engine is not None and not any(
                getattr(p, "_engine", None) is engine
                for p in self._providers):
            from ..embedding.checkpoint import EmbeddingStateProvider

            self._providers.append(EmbeddingStateProvider(engine))
        return list(self._providers)

    # -- context defaults ----------------------------------------------------
    def _resolve(self, main_program, scope):
        from ..framework import default_main_program

        scope = scope or self._scope
        if scope is None:
            raise ValueError("CheckpointManager needs a scope (the port has "
                             "no global scope): pass scope= at construction "
                             "or to save/restore")
        return main_program or self._program or default_main_program(), scope

    # -- directory naming ----------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"{_STEP_PREFIX}{step:08d}")

    def steps(self) -> list[int]:
        """Steps with a committed (renamed) directory, ascending. Commit
        atomicity means presence under the final name implies a complete
        write; manifest validity is still re-checked at restore time."""
        out = []
        try:
            entries = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in entries:
            if not name.startswith(_STEP_PREFIX):
                continue
            try:
                out.append(int(name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

    # -- guard events --------------------------------------------------------
    def _events_path(self) -> str:
        return os.path.join(self.root, _GUARD_EVENTS)

    def _load_guard_events(self) -> list[dict]:
        try:
            with open(self._events_path()) as f:
                data = json.load(f)
            return list(data) if isinstance(data, list) else []
        except (OSError, ValueError):
            return []

    def record_guard_event(self, step: int, reason: str, action: str,
                           detail=None) -> dict:
        """Append one numeric-guard event (skip/rewind/surface). Durable
        immediately via an atomic write of guard_events.json; also embedded
        in every later manifest. latest_step() is unaffected."""
        evt = {"step": int(step), "reason": str(reason),
               "action": str(action), "time": time.time()}
        if detail is not None:
            evt["detail"] = detail
        self._guard_events.append(evt)
        tmp = self._events_path() + ".tmp"
        try:
            with open(tmp, "w") as f:
                # default=str: blame reports may carry non-JSON leaves
                json.dump(self._guard_events, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._events_path())
        except OSError:
            # forensics must never take training down with them
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return evt

    def guard_events(self) -> list[dict]:
        return list(self._guard_events)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, executor=None, main_program=None,
             scope=None) -> str:
        """Write the checkpoint for `step`; returns the committed path.

        Every process calls this; the manifest and the commit rename are
        rank 0's (io.save_sharded itself raises past world size 1)."""
        from .. import io

        program, scope = self._resolve(main_program, scope)
        primary = _is_primary()
        step = int(step)
        final = self._step_dir(step)
        tmp = os.path.join(self.root, f".tmp-{step:08d}")
        if primary:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        try:
            io.save_sharded(executor, os.path.join(tmp, _STATE),
                            main_program=program, scope=scope)
            if not primary:
                return final
            extra = {}
            for provider in self._providers_for(program):
                frag = provider.save_state(self, tmp, step,
                                           executor=executor,
                                           program=program, scope=scope)
                if frag is not None:
                    extra[provider.name] = frag
            manifest = {
                "format": _FORMAT,
                "step": step,
                "program_hash": _program_hash(program),
                "rng_counter": scope._run_counter,
                "random_seed": program.random_seed or 0,
                "var_names": sorted(
                    v.name for v in program.list_vars()
                    if getattr(v, "persistable", False)
                    and scope.has_var(v.name)),
                "guard_events": json.loads(
                    json.dumps(self._guard_events, default=str)),
                "time": time.time(),
            }
            if extra:
                manifest["extra"] = extra
            mpath = os.path.join(tmp, _MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            # commit: the final name appears in one rename; re-saving the
            # same step replaces the old directory
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(self.root)
        except BaseException:
            if primary:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        """Prune beyond keep-last-k and sweep crash orphans (runs after a
        successful commit, so any remaining .tmp-* is a dead save)."""
        if self.keep_last_k and self.keep_last_k > 0:
            for step in self.steps()[:-self.keep_last_k]:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        for name in os.listdir(self.root):
            if name.startswith(".tmp-") or name.startswith(".corrupt-"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def _validate(self, step: int, program) -> dict:
        manifest = self.read_manifest(step)
        if manifest.get("format") != _FORMAT:
            raise ValueError(
                f"checkpoint step {step}: unknown manifest format "
                f"{manifest.get('format')!r}")
        if not os.path.isdir(os.path.join(self._step_dir(step), _STATE)):
            raise FileNotFoundError(
                f"checkpoint step {step}: missing state directory")
        want = _program_hash(program)
        got = manifest.get("program_hash")
        if got != want:
            warnings.warn(
                f"checkpoint step {step} was saved from a different program "
                f"(hash {got} != {want}); restoring the intersection of "
                f"persistables", stacklevel=3)
        return manifest

    def _quarantine(self, step: int, reason: Exception) -> None:
        src = self._step_dir(step)
        dst = os.path.join(self.root, f".corrupt-{_STEP_PREFIX}{step:08d}")
        warnings.warn(
            f"checkpoint step {step} is unreadable ({reason}); quarantined "
            f"to {dst} — rolling back to the previous checkpoint",
            stacklevel=3)
        shutil.rmtree(dst, ignore_errors=True)
        try:
            os.replace(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)

    def restore(self, step: int | None = None, executor=None,
                main_program=None, scope=None, shardings=None) -> int | None:
        """Load the newest good checkpoint (or exactly `step` if given).

        Returns the restored step, or None when the root holds no
        checkpoint at all (fresh start). Corrupt candidates are quarantined
        and the next-older one is tried — unless an explicit `step` was
        requested, which fails hard rather than silently substituting.
        `shardings` is the JAX package's mesh placement; the port has no
        mesh, and io.load_sharded raises on a value other than None."""
        from .. import io

        program, scope = self._resolve(main_program, scope)
        explicit = step is not None
        candidates = [int(step)] if explicit else list(reversed(self.steps()))
        if explicit and int(step) not in self.steps():
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.root}")
        for cand in candidates:
            try:
                manifest = self._validate(cand, program)
                io.load_sharded(executor,
                                os.path.join(self._step_dir(cand), _STATE),
                                main_program=program, scope=scope,
                                shardings=shardings)
                extra = manifest.get("extra") or {}
                for provider in self._providers_for(program):
                    # a provider whose files are gone/corrupt raises here,
                    # so the candidate quarantines and the next-older one
                    # is tried — same contract as the state dir itself
                    provider.restore_state(
                        self, self._step_dir(cand), cand,
                        extra.get(provider.name), executor=executor,
                        program=program, scope=scope)
            except Exception as e:
                if explicit:
                    raise
                self._quarantine(cand, e)
                continue
            # resume counter-derived RNG where the save left off, not at 0
            scope._run_counter = int(manifest.get("rng_counter", 0))
            return cand
        return None
