"""The Fluid book's recognize_digits models and the composite nets of the
port (models/mlp.py, nets.py) held against the JAX package's on the CPU.

* mnist_mlp and mnist_conv (BASELINE.json's first configuration) under
  Adam: the main and startup programs equal through to_dict(), then 2
  steps from the JAX startup's weights whose losses and accuracies agree
  (losses rtol 1e-5; fp32 sums in another order) and whose parameters
  agree within 2 lr a step (Adam moves a weight by about lr whatever its
  gradient's size).
* simple_img_conv_pool, img_conv_group (with batch norm), glu and
  scaled_dot_product_attention (one and two heads): programs equal, one
  forward within 1e-5.
"""
import numpy as np
import pytest

from torch_parity import J, T, build, close, run_both

LR = 1e-3


def _mnist(which):
    def fn(pkg):
        from importlib import import_module

        mlp = import_module(pkg["pt"].__name__ + ".models.mlp")
        loss, acc, _ = getattr(mlp, which)()
        pkg["pt"].optimizer.Adam(LR).minimize(loss)
        return [loss, acc]
    return fn


@pytest.mark.parametrize("which", ["mnist_mlp", "mnist_conv"])
def test_mnist_matches_jax_over_two_adam_steps(which):
    jm, js, jf = build(J, _mnist(which))
    tm, ts, tf = build(T, _mnist(which))
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    rng = np.random.default_rng(0)
    shape = (16, 784) if which == "mnist_mlp" else (16, 1, 28, 28)
    feeds = [{"img": rng.random(shape).astype(np.float32),
              "label": rng.integers(0, 10, (16, 1)).astype(np.int64)}
             for _ in range(2)]
    jout, tout, jscope, tscope = run_both((jm, js), (tm, ts), feeds, jf, tf)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-5)
        assert float(t[1]) == float(j[1])
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-4, atol=2 * 2 * LR, err_msg=p.name)


NETS = {
    "simple_img_conv_pool": (
        lambda L, nets, x: nets.simple_img_conv_pool(
            x, num_filters=4, filter_size=3, pool_size=2, pool_stride=2,
            act="relu"), (2, 3, 8, 8)),
    "img_conv_group": (
        lambda L, nets, x: nets.img_conv_group(
            x, conv_num_filter=[4, 4], pool_size=2, conv_act="relu",
            conv_with_batchnorm=[True, False], pool_stride=2), (2, 3, 8, 8)),
    "glu": (lambda L, nets, x: nets.glu(x, dim=-1), (2, 3, 8)),
    "sdpa_1head": (lambda L, nets, x: nets.scaled_dot_product_attention(
        x, x, x), (2, 5, 8)),
    "sdpa_2heads": (lambda L, nets, x: nets.scaled_dot_product_attention(
        L.fc(x, size=8, num_flatten_dims=2), x, x, num_heads=2), (2, 5, 8)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_match_jax(name):
    build_net, shape = NETS[name]

    def fn(pkg):
        from importlib import import_module

        nets = import_module(pkg["pt"].__name__ + ".nets")
        x = pkg["L"].data(name="x", shape=list(shape[1:]), dtype="float32")
        return [build_net(pkg["L"], nets, x)]

    jm, js, jf = build(J, fn)
    tm, ts, tf = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    (jo,), (to,), _, _ = run_both((jm, js), (tm, ts), [{"x": x}], jf, tf)
    close(to, jo)
