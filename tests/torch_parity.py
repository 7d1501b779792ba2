"""Shared plumbing of the port's parity tests: build one program through
both packages' layers, run it through both executors on the CPU, and carry
the JAX package's startup weights into the port's scope."""
import importlib

import numpy as np

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import paddle_tpu as jpt
from paddle_tpu import backward as jbw
from paddle_tpu import unique_name as jun
import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbw
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.weights import load_params

J = dict(name="jax", pt=jpt, un=jun, bw=jbw,
         L=importlib.import_module("paddle_tpu.layers"),
         exe=lambda: jpt.Executor(), scope=jpt.Scope)
T = dict(name="torch", pt=tpt, un=tun, bw=tbw,
         L=importlib.import_module("paddle_tpu_torch.layers"),
         exe=lambda: tpt.Executor(place="cpu"), scope=tpt.Scope)


def build(pkg, fn, seed=0):
    """(main, startup, fn(pkg)'s result) with fn's layers in fresh
    programs and fresh unique names."""
    main, startup = pkg["pt"].Program(), pkg["pt"].Program()
    main.random_seed = startup.random_seed = seed
    with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
        out = fn(pkg)
    return main, startup, out


def names(fetch):
    return [getattr(v, "name", v) for v in fetch]


def run_both(jprog, tprog, feeds, fetch_j, fetch_t=None, params_of=None):
    """Run each (main, startup) pair from the JAX startup's weights (the
    port's loaded through `load_params`) over `feeds` in turn; the weights
    are those of `params_of`'s (JAX, port) programs where given. Returns
    ([per-feed JAX fetches], [per-feed port fetches], jax scope, port
    scope)."""
    fetch_t = fetch_j if fetch_t is None else fetch_t
    (jm, js), (tm, ts) = jprog, tprog
    jp, tp = params_of or (jm, tm)
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    params = {p.name: np.asarray(jscope.find_var(p.name))
              for p in jp.all_parameters()}
    if params:
        load_params(tscope, tp, params)
    jout, tout = [], []
    for feed in feeds:
        jout.append([np.asarray(a) for a in jexe.run(
            jm, feed=feed, fetch_list=names(fetch_j), scope=jscope)])
        tout.append(texe.run(tm, feed=feed, fetch_list=names(fetch_t),
                             scope=tscope))
    return jout, tout, jscope, tscope


def close(got, want, rtol=1e-5, atol=1e-5, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol, err_msg=f"{what} [{i}]")


def op_outputs_and_grads(pkg, op_type, ins, outs, attrs, cots, nograd=(),
                         scope=None):
    """Build `op_type` over vars named as `ins` ({slot: {name: array}}) in
    a fresh program, differentiate the outputs named in `cots` ({name:
    cotangent array}) by the package's `gradients`, run it, and return
    ({output name: value} for every output in `outs` ({slot: [name]}),
    {input name: grad} for the floating inputs not in `nograd` (those are
    stop_gradient vars, as a layer makes its state), the program). The run
    uses `scope` where given."""
    main = pkg["pt"].Program()
    with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
        block = main.global_block
        diff = []
        for d in ins.values():
            for n, a in d.items():
                grad = a.dtype.kind == "f" and n not in nograd
                v = block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                     stop_gradient=not grad)
                if grad:
                    diff.append(v)
        block.append_op(op_type, {s: list(d) for s, d in ins.items()}, outs,
                        attrs)
        gvars = []
        if cots:
            targets = [block.var(n) for n in cots]
            tgs = [block.create_var(name=n + "_cot", shape=cots[n].shape,
                                    dtype="float32") for n in cots]
            gvars = pkg["bw"].gradients(targets, diff, tgs)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": a for n, a in cots.items()})
    out_names = [n for ns in outs.values() for n in ns]
    fetch = out_names + [g.name for g in gvars if g is not None]
    vals = pkg["exe"]().run(main, feed=feed, fetch_list=fetch,
                            scope=pkg["scope"]() if scope is None else scope)
    got_out = {n: np.asarray(v) for n, v in zip(out_names, vals)}
    got_grad = {}
    rest = iter(vals[len(out_names):])
    for v, g in zip(diff, gvars):
        if g is not None:
            got_grad[v.name] = np.asarray(next(rest))
    return got_out, got_grad, main
