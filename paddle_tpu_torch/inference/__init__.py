"""Inference Predictor API (the JAX package's inference/__init__.py):
`create_paddle_predictor(NativeConfig(model_dir=...))` loads a model that
`io.save_inference_model` wrote, by either package, and runs it on the
device the config names (CUDA unless it names another; with no CUDA and
none named, a raise).

  * PaddlePredictor / NativeConfig (reference inference/api/paddle_api.h:219
    Run contract, :287 NativeConfig; api_impl.h:34 NativePaddlePredictor)
  * AnalysisPredictor + AnalysisConfig (analysis_predictor.h:46,
    paddle_analysis_config.h). The reference's analysis passes have no
    counterpart here: the program runs op by op as saved, each kernel-backed
    op on its hand kernel. `enable_bf16` casts the parameters and the
    program's float vars to bfloat16 (the reference's float16 inference
    mode, paddle/contrib/float16/, in the H100's bf16), so the kernels run
    their bf16 instantiations.

Contract: predictor.run([PaddleTensor]) -> [PaddleTensor] named by the
fetches, and run_dict({name: array}) -> [numpy arrays].
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "PaddleTensor",
    "NativeConfig",
    "AnalysisConfig",
    "create_paddle_predictor",
    "Predictor",
]


@dataclass
class PaddleTensor:
    """reference paddle_api.h:145: a named array (LoD collapses to padding
    as in the rest of the framework)."""

    name: str
    data: Any = None

    @property
    def shape(self):
        return list(np.asarray(self.data).shape)


@dataclass
class NativeConfig:
    """reference paddle_api.h:287: the model's paths and the device.
    `model_dir` holds the save_inference_model layout; `device` is a torch
    device spelling, None for the current CUDA device."""

    model_dir: str = ""
    prog_file: str = ""
    params_file: str = ""
    device: str | None = None


@dataclass
class AnalysisConfig(NativeConfig):
    """reference paddle_analysis_config.h, the knobs that mean something
    here. enable_bf16: cast the parameters and the program's float vars to
    bfloat16 after loading (`Predictor._to_bf16`)."""

    enable_bf16: bool = False
    # kept for API parity: the program runs as saved
    ir_optim: bool = True
    memory_optim: bool = True
    _extra: dict = field(default_factory=dict)

    def switch_ir_optim(self, flag: bool = True):
        self.ir_optim = flag

    def enable_memory_optim(self, flag: bool = True):
        self.memory_optim = flag


class Predictor:
    """Runs a saved inference model (reference api_impl.h:34 /
    analysis_predictor.h:46) with an executor and a scope of its own."""

    def __init__(self, config: NativeConfig):
        from .. import io
        from ..executor import Executor, Scope

        self._config = config
        self._exe = Executor(place=config.device)
        self._scope = Scope()
        if config.model_dir:
            prog, feeds, fetches = io.load_inference_model(
                config.model_dir, self._exe, scope=self._scope)
        else:
            prog, feeds, fetches = io.load_inference_model(
                os.path.dirname(config.prog_file) or ".", self._exe,
                model_filename=os.path.basename(config.prog_file),
                params_filename=(os.path.basename(config.params_file)
                                 or None), scope=self._scope)
        self._program = prog
        self._feed_names = list(feeds)
        self._fetch_names = [v if isinstance(v, str) else v.name
                             for v in fetches]
        if getattr(config, "enable_bf16", False):
            self._to_bf16()

    # -- reference Run() contract -------------------------------------------
    def run(self, inputs: Sequence[PaddleTensor]) -> list[PaddleTensor]:
        feed = {t.name: t.data for t in inputs}
        outs = self.run_dict(feed)
        return [PaddleTensor(name=n, data=o)
                for n, o in zip(self._fetch_names, outs)]

    def run_dict(self, feed: dict, return_numpy: bool = True) -> list:
        """The fetches for `feed` ({feed name: numpy array or tensor}), as
        numpy arrays (a bfloat16 fetch as float32, which holds its values)
        or, with return_numpy=False, as device tensors."""
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"predictor missing feeds: {missing}")
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names,
                             scope=self._scope, return_numpy=return_numpy)

    def get_input_names(self) -> list[str]:
        return list(self._feed_names)

    def get_output_names(self) -> list[str]:
        return list(self._fetch_names)

    def clone(self) -> "Predictor":
        """reference PaddlePredictor::Clone: a second handle on the same
        loaded model, sharing the program, the parameter scope and the
        executor. An inference program writes no state but its ops'
        unchanged outputs, and the scope's run counter moves under a lock,
        so the parent and its clones may run from several threads."""
        new = object.__new__(Predictor)
        new._config = self._config
        new._exe = self._exe
        new._scope = self._scope
        new._program = self._program
        new._feed_names = list(self._feed_names)
        new._fetch_names = list(self._fetch_names)
        return new

    # -- bf16 inference mode -------------------------------------------------
    def _to_bf16(self):
        """Cast the fp32 scope tensors, the program's fp32 vars and the
        fp32 `dtype` attrs of its ops to bfloat16. A floating feed of a
        var now bf16 is cast on the device by the executor."""
        from ..core.types import DType

        for name in self._scope.var_names():
            v = self._scope.find_var(name)
            if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
                self._scope.set_var(name, v.to(torch.bfloat16))
        for block in self._program.blocks:
            for var in block.vars.values():
                if var.dtype is DType.FP32:
                    var.dtype = DType.BF16
            for op in block.ops:
                if ("dtype" in op.attrs
                        and DType.parse(op.attrs["dtype"]) is DType.FP32):
                    op.attrs["dtype"] = DType.BF16.value


def create_paddle_predictor(config: NativeConfig) -> Predictor:
    """reference paddle_api.h CreatePaddlePredictor<ConfigT>."""
    return Predictor(config)
