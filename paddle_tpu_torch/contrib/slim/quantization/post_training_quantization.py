"""Post-training quantization: calibrate activation scales on sample data,
then insert static quantize-dequantize ops, with no retraining (the JAX
package's post_training_quantization.py).

Where QAT learns moving-average scales during training, PTQ measures
abs-max statistics by running the trained inference program over a
calibration set, then rewrites the program with fixed-scale q/dq ops.
`QuantizationFreezePass` and `save_inference_model` afterwards give the
deployable quantized model (`ConvertToInt8Pass` for 1-byte weights).
"""
from __future__ import annotations

import numpy as np

from ....framework import Program

__all__ = ["PostTrainingQuantization"]

_DEFAULT_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")


class PostTrainingQuantization:
    """Usage::

        ptq = PostTrainingQuantization(
            executor=exe, program=inference_program,
            sample_feeds=[{...}, ...],          # calibration batches
            scope=scope)                         # holds trained params
        quant_program = ptq.quantize()           # static-scale q/dq inserted
        QuantizationFreezePass(scope).apply(quant_program)
        io.save_inference_model(..., scope=scope)
    """

    def __init__(self, executor, program: Program, sample_feeds, scope,
                 quantizable_op_type=_DEFAULT_QUANTIZABLE, weight_bits=8,
                 activation_bits=8, algo="abs_max"):
        if algo != "abs_max":
            raise NotImplementedError(
                f"calibration algo '{algo}': only abs_max is implemented")
        if not sample_feeds:
            raise ValueError("PTQ needs at least one calibration batch")
        if scope is None:
            raise ValueError("PostTrainingQuantization needs the scope that "
                             "holds the trained parameters")
        self._exe = executor
        self._program = program
        self._feeds = list(sample_feeds)
        self._scope = scope
        self._types = tuple(quantizable_op_type)
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits

    def quantize(self) -> Program:
        from .... import unique_name

        block = self._program.global_block
        params = {p.name for p in self._program.all_parameters()}

        # 1. the tensors feeding quantizable ops
        act_names, weight_names = [], []
        for op in block.ops:
            if op.type not in self._types:
                continue
            for names in op.inputs.values():
                for n in names:
                    if not n or not block.has_var(n):
                        continue
                    if n in params:
                        if n not in weight_names:
                            weight_names.append(n)
                    elif n not in act_names:
                        act_names.append(n)

        # 2. calibrate: the abs-max of each activation over the batches
        act_scales = {n: 0.0 for n in act_names}
        for feed in self._feeds:
            outs = self._exe.run(self._program, feed=feed, fetch_list=act_names,
                                 scope=self._scope)
            for n, v in zip(act_names, outs):
                act_scales[n] = max(act_scales[n],
                                    float(np.abs(np.asarray(v)).max()))

        # 3. the weight scales straight from the trained values
        weight_scales = {n: float(self._scope.find_var(n).abs().max())
                         for n in weight_names}

        # 4. rewrite: a static q/dq in front of every quantizable op
        quantized: dict[str, str] = {}
        for op in list(block.ops):
            if op.type not in self._types:
                continue
            for names in op.inputs.values():
                for i, n in enumerate(names):
                    if n in quantized:
                        names[i] = quantized[n]
                        continue
                    scale = weight_scales.get(n, act_scales.get(n))
                    if scale is None:
                        continue
                    bits = (self._weight_bits if n in weight_scales
                            else self._activation_bits)
                    var = block.var(n)
                    out = block.create_var(
                        name=unique_name.generate(n + ".ptq"),
                        shape=var.shape, dtype=var.dtype)
                    block._insert_op(
                        block.ops.index(op), "fake_quantize_dequantize_static",
                        {"X": [n]}, {"Out": [out.name]},
                        {"scale": max(scale, 1e-8), "bit_length": bits})
                    quantized[n] = out.name
                    names[i] = out.name
        return self._program
