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
`PyReader` / `DataLoader` and the `reader` decorators, or by the
`dataset` readers through `batch` and `DataFeeder`; tables past
FLAGS_emb_hbm_budget_mb tiered into host memory behind a device cache
(`embedding`), checkpointed by `resilience.CheckpointManager`, with the
`observability` registry and the `resilience` fault plans and watchdog;
training guarded by the numeric health sentinel and `StepGuard`
(FLAGS_guard_numerics) or driven by `resilience.CheckpointedRunner`;
sequence labelling with the crf ops and recognition with the ctc ops,
scored by `evaluator` (ChunkEvaluator, EditDistance) or `metrics`, and
quantization-aware training through `contrib.slim`; per-shape decisions
(the attention route among them) resolved by the autotuner (`tuning`);
data-parallel training over `torch.distributed` ranks (`parallel`,
`distributed`, `incubate.fleet`, `CompiledProgram`).
The TPU kernels on those paths are hand-written Hopper kernels
(`ops/cuda_kernels/`). Entry points run on CUDA unless the caller passes
`device="cpu"` / `place="cpu"`; with no device named and no CUDA present
they raise. This package imports neither jax nor paddle_tpu.
"""
from . import (average, contrib, dataset, debugger, distributed, embedding,
               evaluator, flags, incubate, inference, initializer,
               install_check, io, metrics, models, net_drawer, nets,
               observability, optimizer, parallel, passes, pipeline,
               profiler, reader, resilience, serving, tuning, unique_name)
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .backward import append_backward, gradients
from .data_feeder import DataFeeder
from .executor import CPUPlace, CUDAPlace, Executor, Scope
from .fluid_dataset import DatasetFactory, InMemoryDataset, QueueDataset
from .framework import (Block, OpError, Operator, Parameter, Program,
                        Variable, default_main_program,
                        default_startup_program, name_scope, program_guard)
from .param_attr import ParamAttr
from .pipeline import DeviceLoader
from .pyreader import DataLoader, PyReader

batch = reader.batch  # paddle.batch

__all__ = ["average", "contrib", "dataset", "debugger", "distributed",
           "embedding", "evaluator", "flags", "incubate", "inference",
           "initializer", "install_check", "io", "metrics", "models",
           "net_drawer", "nets", "observability", "optimizer", "parallel",
           "passes", "pipeline", "profiler", "reader", "BuildStrategy",
           "CompiledProgram", "ExecutionStrategy",
           "resilience", "serving", "tuning", "unique_name", "batch",
           "DataFeeder", "DatasetFactory", "InMemoryDataset", "QueueDataset",
           "DataLoader", "PyReader", "DeviceLoader", "append_backward",
           "gradients", "Executor", "Scope", "CPUPlace", "CUDAPlace",
           "Block", "OpError", "Operator", "Parameter", "Program", "Variable",
           "default_main_program", "default_startup_program", "name_scope",
           "program_guard", "ParamAttr"]
