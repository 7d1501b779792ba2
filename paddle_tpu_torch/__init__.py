"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

Same Fluid-style surface as the JAX package (Program IR, layers, op
registry with gradients, backward, optimizer, executor), run eagerly by
PyTorch on an explicit device. Ported paths: serving (`serving/`) and the
BERT pretrain step (`models.transformer.bert_pretrain` + `optimizer.Adam`).
The TPU kernels on those paths are hand-written Hopper kernels
(`ops/cuda_kernels/`). Entry points run on CUDA unless the caller passes
`device="cpu"` / `place="cpu"`; with no device named and no CUDA present
they raise. This package imports neither jax nor paddle_tpu.
"""
from . import flags, models, optimizer, unique_name
from .backward import append_backward, gradients
from .executor import Executor, Scope
from .framework import (Program, default_main_program,
                        default_startup_program, program_guard)
from .param_attr import ParamAttr

__all__ = ["flags", "models", "optimizer", "unique_name", "append_backward",
           "gradients", "Executor", "Scope", "Program",
           "default_main_program", "default_startup_program",
           "program_guard", "ParamAttr"]
