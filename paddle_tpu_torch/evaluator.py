"""In-program metric evaluators with persistent accumulation state (the
JAX package's evaluator.py).

Each evaluator appends its per-batch metric ops and the running-sum
updates of its state vars to the current main program when it is built,
so every `Executor.run` of the program advances the states; `reset()`
zeroes them between passes and `eval()` folds the accumulated counts into
the pass's metric on the host (the states are a few scalars). The port has
no global scope, so `reset()` and `eval()` take the scope the program runs
in, as the optimizer wrappers' `apply` does.
"""
from __future__ import annotations

import numpy as np

from . import layers
from .framework import Program, program_guard
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance"]


class Evaluator:
    """Base evaluator: owns persistable state vars that ops it appended to
    the main program update."""

    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states: list = []
        self.metrics: list = []

    def _create_state(self, suffix, dtype, shape):
        state = self.helper.create_or_get_global_variable(
            f"{self.helper.name}.{suffix}", list(shape), dtype,
            initializer=Constant(0.0))
        self.states.append(state)
        return state

    def reset(self, executor, reset_program=None, *, scope):
        """Zero every accumulation state in `scope`."""
        if reset_program is None:
            reset_program = Program()
        with program_guard(reset_program):
            for state in self.states:
                layers.fill_constant(shape=state.shape, dtype=state.dtype.value,
                                     value=0.0, out=state)
        executor.run(reset_program, scope=scope)

    def eval(self, executor, eval_program=None, *, scope):
        raise NotImplementedError()

    def _state_value(self, state, scope) -> float:
        v = scope.find_var(state.name)
        if v is None:
            raise RuntimeError(
                f"evaluator state '{state.name}' not initialized: run the "
                f"startup program (or reset()) in this scope first")
        return float(v.reshape(-1)[0])


class ChunkEvaluator(Evaluator):
    """Chunk counts accumulated across batches, reported as the pass's
    precision, recall and F1 (over chunk_eval)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("chunk_eval")
        (precision, recall, f1, num_infer, num_label,
         num_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        # accumulated in float32: the counts run as int32, and float32
        # holds them exactly up to 2^24 a pass
        self.num_infer_chunks = self._create_state(
            "num_infer_chunks", "float32", [1])
        self.num_label_chunks = self._create_state(
            "num_label_chunks", "float32", [1])
        self.num_correct_chunks = self._create_state(
            "num_correct_chunks", "float32", [1])
        for state, batch in ((self.num_infer_chunks, num_infer),
                             (self.num_label_chunks, num_label),
                             (self.num_correct_chunks, num_correct)):
            inc = layers.cast(batch, "float32")
            self.helper.append_op("elementwise_add", {"X": [state], "Y": [inc]},
                                  {"Out": [state]}, {})
        self.metrics = [precision, recall, f1]

    def eval(self, executor, eval_program=None, *, scope):
        infer = self._state_value(self.num_infer_chunks, scope)
        label = self._state_value(self.num_label_chunks, scope)
        correct = self._state_value(self.num_correct_chunks, scope)
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return (np.array([precision], np.float32),
                np.array([recall], np.float32),
                np.array([f1], np.float32))


class EditDistance(Evaluator):
    """Edit distances accumulated across batches: eval() returns the mean
    distance and the share of sequences with at least one error."""

    def __init__(self, input, label, ignored_tokens=None):
        super().__init__("edit_distance")
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        self.total_distance = self._create_state(
            "total_distance", "float32", [1])
        self.seq_num = self._create_state("seq_num", "float32", [1])
        self.instance_error = self._create_state(
            "instance_error", "float32", [1])
        batch_dist = layers.reduce_sum(distances)
        # distances are >= 0, so sign() is a sequence's error indicator
        batch_err = layers.reduce_sum(layers.sign(distances))
        for state, inc in ((self.total_distance, batch_dist),
                           (self.seq_num, layers.cast(seq_num, "float32")),
                           (self.instance_error, batch_err)):
            self.helper.append_op("elementwise_add", {"X": [state], "Y": [inc]},
                                  {"Out": [state]}, {})
        self.metrics = [distances, seq_num]

    def eval(self, executor, eval_program=None, *, scope):
        total = self._state_value(self.total_distance, scope)
        n = self._state_value(self.seq_num, scope)
        err = self._state_value(self.instance_error, scope)
        avg = total / n if n else 0.0
        rate = err / n if n else 0.0
        return (np.array([avg], np.float32), np.array([rate], np.float32))
