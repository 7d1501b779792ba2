"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

Same Fluid-style surface as the JAX package (Program IR, layers, op
registry with gradients, backward, optimizer, executor), run eagerly by
PyTorch on an explicit device. Ported paths: serving (`serving/`), the
BERT pretrain step (`models.transformer.bert_pretrain` + `optimizer.Adam`)
and the ResNet training step (`models.resnet` + `optimizer.Momentum`), in
fp32 or under bf16 mixed precision (`contrib.mixed_precision.decorate`),
under any optimizer of `optimizer` and schedule of
`layers.learning_rate_scheduler`; models saved and loaded through `io` and
served by `inference.create_paddle_predictor`; DeepFM and word2vec with
sparse (SelectedRows) embedding gradients, fed from MultiSlot files by
`DatasetFactory` datasets through `Executor.train_from_dataset`, or by
`PyReader` / `DataLoader` and the `reader` decorators; tables past
FLAGS_emb_hbm_budget_mb tiered into host memory behind a device cache
(`embedding`), checkpointed by `resilience.CheckpointManager`, with the
`observability` registry and the `resilience` fault plans and watchdog.
The TPU kernels on those paths are hand-written Hopper kernels
(`ops/cuda_kernels/`). Entry points run on CUDA unless the caller passes
`device="cpu"` / `place="cpu"`; with no device named and no CUDA present
they raise. This package imports neither jax nor paddle_tpu.
"""
from . import (contrib, embedding, flags, inference, io, models, nets,
               observability, optimizer, profiler, reader, resilience,
               unique_name)
from .backward import append_backward, gradients
from .data_feeder import DataFeeder
from .executor import Executor, Scope
from .fluid_dataset import DatasetFactory
from .framework import (Program, default_main_program,
                        default_startup_program, program_guard)
from .param_attr import ParamAttr
from .pyreader import DataLoader, PyReader

__all__ = ["contrib", "embedding", "flags", "inference", "io", "models",
           "nets", "observability", "optimizer", "profiler", "reader",
           "resilience", "unique_name", "DataFeeder",
           "DatasetFactory", "DataLoader", "PyReader",
           "append_backward",
           "gradients", "Executor", "Scope", "Program",
           "default_main_program", "default_startup_program",
           "program_guard", "ParamAttr"]
