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

A wrapper launches its kernel for CUDA tensors (and raises on anything the
kernel does not take), runs the plain version for CPU tensors, and counts
its launches in the plain integer attribute `<wrapper>.launches`.
"""
from .attention_bwd import attention_backward, attention_backward_plain
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
            softmax_xent_bwd)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}
