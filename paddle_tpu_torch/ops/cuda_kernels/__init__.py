"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a), one module
each with its wrapper, its plain PyTorch version and its launch count:

  serving path
  * `paged_attention.paged_decode_attention`     (K1, csrc/paged_attention.cu)
  * `prefill_attention.causal_prefill_attention` (K2, csrc/prefill_attention.cu)
  * `layer_norm.layer_norm_act`                  (K3, csrc/layer_norm.cu)
  training path (K2 and K3 forward, and)
  * `attention_bwd.attention_backward`           (K4, csrc/attention_backward.cu)
  * `layer_norm_bwd.layer_norm_act_backward`     (K5, csrc/layer_norm_backward.cu)
  * `xent_fwd.softmax_xent_fwd`                  (K6, csrc/softmax_xent_fwd.cu)
  * `xent_bwd.softmax_xent_bwd`                  (K7, csrc/softmax_xent_bwd.cu)
  long-context training path, S > 512 (K3, K5-K7, and)
  * `flash_attention.flash_attention_fwd`        (K10, csrc/flash_attention.cu)
  * `flash_attention_bwd.flash_attention_backward`
                                       (K11, csrc/flash_attention_backward.cu)
  ResNet training path (K6 and K7, and)
  * `bn_apply.bn_apply_act`                      (K8, csrc/bn_apply.cu)
  * `bn_apply_bwd.bn_apply_act_backward`         (K9, csrc/bn_apply_backward.cu)
    and its split mode for a batch norm synced over ranks,
    `bn_apply_act_backward_sums` then `bn_apply_act_backward_chain`
  the fused bottleneck tool (its A/B, no model path)
  * `bottleneck.bottleneck_block`                (#15, csrc/bottleneck_block.cu)
  the attention probes (their tool entry points, no model path)
  * `attn_probe.attention_probe`                 (K12, csrc/attn_probe.cu)
  * `dma_probe.dma_copy`                         (K13, csrc/dma_probe.cu)

K1-K11 take fp32 or bf16 (bf16 serving and the AMP training steps), each
source holding one instantiation per dtype; #15, K12 and K13 are bf16. A wrapper
launches its kernel for CUDA tensors (and raises on anything the kernel does
not take), runs the plain version for CPU tensors, and counts its launches
in the plain integer attribute `<wrapper>.launches` and by dtype in
`<wrapper>.launches_by_dtype` (#15 also by kernel, wgmma or mma.sync, in
`bottleneck_block.launches_by_route`).
"""
from .attention_bwd import (attention_backward, attention_backward_pair,
                            attention_backward_plain)
from .attn_probe import attention_probe, attention_probe_plain
from .bn_apply import bn_apply_act, bn_apply_act_plain
from .bn_apply_bwd import (bn_apply_act_backward, bn_apply_act_backward_chain,
                           bn_apply_act_backward_chain_plain,
                           bn_apply_act_backward_plain,
                           bn_apply_act_backward_sums,
                           bn_apply_act_backward_sums_plain, bn_fold,
                           bn_param_grads, stat_cotangents)
from .bottleneck import bottleneck_block, bottleneck_block_plain
from .dma_probe import dma_copy, dma_copy_plain
from .flash_attention import flash_attention_fwd, flash_attention_fwd_plain
from .flash_attention_bwd import (flash_attention_backward,
                                  flash_attention_backward_plain)
from .layer_norm import layer_norm_act, layer_norm_act_plain
from .layer_norm_bwd import (layer_norm_act_backward,
                                  layer_norm_act_backward_plain)
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_plain)
from .prefill_attention import (causal_prefill_attention,
                                causal_prefill_attention_plain)
from .xent_bwd import softmax_xent_bwd, softmax_xent_bwd_plain
from .xent_fwd import softmax_xent_fwd, softmax_xent_fwd_plain

WRAPPERS = (paged_decode_attention, causal_prefill_attention, layer_norm_act,
            attention_backward, layer_norm_act_backward, softmax_xent_fwd,
            softmax_xent_bwd, bn_apply_act, bn_apply_act_backward,
            bn_apply_act_backward_sums, bn_apply_act_backward_chain,
            bottleneck_block, flash_attention_fwd, flash_attention_backward,
            attention_probe, dma_copy)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
        w.launches_by_dtype = {}
    bottleneck_block.launches_by_route = {}


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def launch_counts_by_dtype() -> dict[str, dict[str, int]]:
    """{wrapper: {dtype name: launches}}, dtypes with no launch left out."""
    return {w.__name__: dict(w.launches_by_dtype) for w in WRAPPERS}
