"""The port's two attention probes held against the tools they replace:
K12 (tools/_attn_probe.py, seven attention stage bodies) and K13
(tools/_attn_dma.py, o = 2 x over two layouts and three block shapes).

The tools run their benchmark at import (no `__main__` guard), so the tests
take their imports and function definitions out with `ast`, run them in a
namespace whose module constants are cut (B = 2 or 4; the tools' nh, S, dh
and head group kept), and call the tools' own `make` / `copy4` / `copy3`
under `pltpu.force_tpu_interpret_mode()`, as the JAX package's tests run
Pallas kernels on the CPU. On the CPU the port's wrappers run their plain
versions; tests/test_torch_cuda.py and chip_smoke.py hold the kernels
against those on the card.

Tolerances: copy, and o = 2 x, exactly (one bf16 rounding of an exact or
one-operation result). The other bodies end in one bf16 rounding of fp32
values whose sums run in another order: two units of bf16's last place
(2^-7 relative) plus 1e-2 of the output's max-abs, and nine elements in ten
equal (measured: at most 4.1e-3 of the max-abs, full_bf16sm, whose exp of
a bf16 value rounds again; 96.9% to 99.998% of the elements equal).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops.cuda_kernels import attn_probe as K12
from paddle_tpu_torch.ops.cuda_kernels import dma_probe as K13

REPO = Path(__file__).resolve().parents[1]


def _tool(path, **consts):
    """The imports and functions of tools/<path>, in a namespace holding
    `consts` in place of the module constants the tool computes."""
    tree = ast.parse((REPO / path).read_text())
    body = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = dict(consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _bf16_pair(rng, shape):
    """One standard normal draw as a bf16 jax array and the same values as
    a bf16 torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


def test_the_tools_are_cut_to_their_functions():
    """The namespace holds the tools' kernels, not their benchmark loops
    (which would run at the full shape)."""
    ns = _tool("tools/_attn_probe.py")
    assert {"make", "k_qk", "k_full_perhead", "bench"} <= set(ns)
    assert "iters" not in ns and "q" not in ns
    assert [n for n in K12.VARIANTS] == [
        "copy", "qk", "qk_max", "softmax", "full", "full_bf16sm",
        "full_perhead"]
    ns = _tool("tools/_attn_dma.py")
    assert {"copy4", "copy3", "xla_copy"} <= set(ns) and "x4" not in ns


@pytest.fixture(scope="module", params=[K12.S, 256], ids=lambda S: f"S{S}")
def probe(request):
    """The tool's namespace at B = 2 (its nh = 12, dh = 64, gh = 12; its S =
    128, and S = 256, where the port's kernel takes two passes over the
    key tiles), and q, k, v drawn as the tool draws them."""
    Bt, S = 2, request.param
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (Bt, K12.NH, S, K12.DH))
                                    for _ in range(3))
    ns = _tool("tools/_attn_probe.py", B=Bt, nh=K12.NH, S=S, dh=K12.DH,
               gh=K12.GH, sm=K12.DH ** -0.5, q=jq)
    return ns, (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("variant", list(K12.VARIANTS))
def test_attention_probe_plain_matches_the_tools_body(probe, variant):
    ns, jargs, targs = probe
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ns["make"](ns[f"k_{variant}"])(*jargs)
                          .astype(jnp.float32))
    got = K12.attention_probe(variant, *targs, K12.DH ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == targs[0].shape
    got = got.float().numpy()
    if variant == "copy":
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 1e-2 * np.abs(want).max()).all(), float(err.max())
    assert (err == 0).mean() > 0.9


@pytest.mark.parametrize("layout", ["copy4", "copy3"])
@pytest.mark.parametrize("bb", [1, 2, 4])
def test_dma_copy_plain_matches_the_tools_copy_exactly(layout, bb):
    Bt, nh, S, dh = 4, K13.NH, K13.S, K13.DH
    ns = _tool("tools/_attn_dma.py", B=Bt, nh=nh, S=S, dh=dh)
    shape = (Bt, nh, S, dh) if layout == "copy4" else (Bt, S, nh * dh)
    jx, tx = _bf16_pair(np.random.default_rng(bb), shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ns[layout](bb)(jx).astype(jnp.float32))
    got = K13.dma_copy(tx, bb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(want, 2 * np.asarray(jx, np.float32))


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 12, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no variant"):
        K12.attention_probe("qk_min", x, x, x, 0.125)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="dma_copy takes"):
        K13.dma_copy(meta[0, 0], 1)
