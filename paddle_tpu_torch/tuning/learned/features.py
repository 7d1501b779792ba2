"""Hand features over canonical shape keys — the arXiv:2008.01040 framing.

The port keeps this module as the JAX package has it, so that a key, a
measurement store record and a trained model featurize identically in both
packages: the tile-fill fractions quantize against the TPU's 128-lane
width on any device (card-specific features are ROADMAP Queue 1,
"tuning, the rest"), and `analytic_decision` is the JAX package's
baseline.

The learned tier does not parse graphs; it parses the SAME canonical shape
spellings the tuning DB keys on (db.py conv_key/attention_key/...), so a
measurement store record and a trace-time decide() query featurize
identically by construction. Features are the quantities the analytic
models already reason in — log FLOPs, log bytes moved, arithmetic
intensity, MXU/VPU tile-fill fractions, arity/layout flags — which is what
makes a regressor over a few dozen measured shapes generalize to unseen
ones instead of memorizing keys.

Only op families whose arms are timed alternatives of one categorical
decision are featurizable (conv2d lowering, attention backend, epilogue
backend, xent backend). Integer-valued levers (bucket boundaries, embedding
geometry, collective bucket sizing) and shapeless ones (AMP lists) stay on
their analytic priors — a ranking model has nothing to rank there.
"""
from __future__ import annotations

import math

__all__ = ["FAMILIES", "decision_field", "featurize", "feature_names",
           "analytic_decision", "parse_shape_key"]

# op family -> the decision dict's field (arm name == decision value)
FAMILIES = {
    "conv2d": "lowering",
    "attention": "backend",
    "epilogue": "backend",
    "xent": "backend",
    # serving control: the "shape" is a traffic regime and the
    # "arm" is a canonical knob-config spelling — the same store rows and
    # ridge fit rank serving configs the way they rank conv lowerings
    "serving.control": "knobs",
}

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "int32": 4, "int8": 1,
}

_LANE = 128  # MXU/VPU lane width the tile-fill fractions quantize against


def _itemsize(dtype: str) -> float:
    return float(_DTYPE_BYTES.get(str(dtype).strip().lower(), 4))


def _fill(x: int, tile: int = _LANE) -> float:
    """Occupied fraction of the tile-padded extent: 1.0 = perfectly packed,
    small = the hardware pads most of the tile (the conv cost model's
    fill(k) term, exact instead of clamped)."""
    x = max(1, int(x))
    return x / (tile * math.ceil(x / tile))


def _log(x: float) -> float:
    return math.log(max(float(x), 1e-30))


def parse_shape_key(op: str, shape_key: str) -> dict | None:
    """Tokenize one db.py shape spelling into {field: int/str}. Bare tokens
    (the conv layout suffix) land under 'fmt'. None = not parseable."""
    out: dict = {}
    try:
        for tok in str(shape_key).split():
            if "=" in tok:
                k, v = tok.split("=", 1)
                if "x" in v and k in ("out", "k", "s", "d"):
                    a, b = v.split("x", 1)
                    out[k] = (int(a), int(b))
                else:
                    try:
                        out[k] = int(v)
                    except ValueError:
                        out[k] = v
            else:
                out["fmt"] = tok
    except ValueError:
        return None
    return out if out else None


# fixed, versioned feature orders — a trained artifact stores the names it
# was fitted on, and predict refuses a mismatch (feature drift must retrain)
_CONV_FEATURES = (
    "log_m", "log_k", "log_n", "log_flops", "log_bytes", "intensity",
    "fill_m", "fill_k", "fill_n", "kernel_area", "stride", "is_1x1",
    "nhwc", "itemsize")
_ATTN_FEATURES = (
    "log_rows", "log_sq", "log_sk", "log_dh", "log_flops", "log_bytes",
    "intensity", "fill_sk", "fill_dh", "causal", "decode", "itemsize")
_EPI_FEATURES = (
    "log_rows", "log_c", "log_elems", "fill_c", "ch_last", "has_res",
    "act_identity", "kind_bn", "itemsize")
_XENT_FEATURES = ("log_rows", "log_v", "log_elems", "fill_v", "itemsize")
# serving.control regime keys (serving/control/regime.py spells them):
# arrival rate, prompt-length percentiles, output budget, prefix-hit rate,
# pool occupancy, queue depth, TTFT/SLO headroom — ratios arrive as percent
# ints so the spelling stays canonical-integer like every other shape key
_CTRL_FEATURES = (
    "log_rate", "log_p50", "log_p95", "log_out", "hit", "occ", "log_q",
    "headroom")


def feature_names(op: str) -> tuple | None:
    return {"conv2d": _CONV_FEATURES, "attention": _ATTN_FEATURES,
            "epilogue": _EPI_FEATURES, "xent": _XENT_FEATURES,
            "serving.control": _CTRL_FEATURES}.get(op)


def featurize(op: str, shape_key: str, dtype: str) -> list | None:
    """The feature vector for one (op, shape_key, dtype) — order matches
    feature_names(op). None = this key is outside the learned tier."""
    if op not in FAMILIES:
        return None
    kv = parse_shape_key(op, shape_key)
    if kv is None:
        return None
    it = _itemsize(dtype)
    try:
        if op == "conv2d":
            n = kv["n"]
            hout, wout = kv["out"]
            cin, cout = kv["cin"], kv["cout"]
            kh, kw = kv["k"]
            sh, _sw = kv.get("s", (1, 1))
            m = n * hout * wout            # GEMM M (output pixels)
            k = cin * kh * kw              # GEMM K (patch extent)
            flops = 2.0 * m * k * cout
            bytes_ = it * (m * k + k * cout + m * cout)
            return [
                _log(m), _log(k), _log(cout), _log(flops), _log(bytes_),
                _log(flops) - _log(bytes_), _fill(m, 8), _fill(k),
                _fill(cout), float(kh * kw), float(sh),
                float(kh == 1 and kw == 1),
                float(kv.get("fmt") == "NHWC"), it,
            ]
        if op == "attention":
            b, nh = kv["b"], kv["nh"]
            sq, sk, dh = kv["sq"], kv["sk"], kv["dh"]
            rows = b * nh * sq
            flops = 4.0 * b * nh * sq * sk * dh
            bytes_ = it * b * nh * (2 * sq * dh + 2 * sk * dh + sq * sk)
            return [
                _log(rows), _log(sq), _log(sk), _log(dh), _log(flops),
                _log(bytes_), _log(flops) - _log(bytes_), _fill(sk),
                _fill(dh), float(kv.get("causal", 0)), float(sq == 1), it,
            ]
        if op == "epilogue":
            rows, c = kv["rows"], kv["c"]
            return [
                _log(rows), _log(c), _log(rows * c), _fill(c),
                float(kv.get("ch") == "last"), float(kv.get("res", 0)),
                float(kv.get("act", "identity") == "identity"),
                float(kv.get("kind") == "bn"), it,
            ]
        if op == "xent":
            rows, v = kv["rows"], kv["v"]
            return [_log(rows), _log(v), _log(rows * v), _fill(v), it]
        if op == "serving.control":
            return [
                _log(float(kv["rate"])), _log(float(kv["p50"])),
                _log(float(kv["p95"])), _log(float(kv["out"])),
                float(kv["hit"]) / 100.0, float(kv["occ"]) / 100.0,
                _log(float(kv["q"]) + 1.0),
                float(kv.get("hr", 100)) / 100.0,
            ]
    except (KeyError, TypeError, ValueError):
        return None
    return None


def decision_field(op: str) -> str | None:
    return FAMILIES.get(op)


# The JAX package's implicit-GEMM cost model (its ops/nn_ops.py
# `_igemm_predict_win`), kept here as the conv baseline of
# `analytic_decision`: constants calibrated on its TPU (a matmul roofline,
# an HBM rate, a conv efficiency), not on any card of the port. The port's
# conv has one route (F.conv2d) and never consults this.
_IGEMM_MXU_FLOPS = 157e12
_IGEMM_HBM_BPS = 450e9
_IGEMM_MXU_EFF = 0.75
_IGEMM_WIN_MARGIN = 0.9


def _igemm_predict_win(n, hout, wout, cin, cout, kh, kw, itemsize) -> bool:
    m = n * hout * wout
    k_fold = cin * kh * kw
    flops = 2.0 * m * k_fold * cout

    def fill(k):
        return min(1.0, k / 128.0)

    t_direct = flops / (_IGEMM_MXU_FLOPS * fill(cin) * _IGEMM_MXU_EFF)
    patch_bytes = 2.0 * m * k_fold * itemsize
    t_igemm = (flops / (_IGEMM_MXU_FLOPS * fill(k_fold) * _IGEMM_MXU_EFF)
               + patch_bytes / _IGEMM_HBM_BPS)
    return t_igemm < _IGEMM_WIN_MARGIN * t_direct


def analytic_decision(op: str, shape_key: str, dtype: str) -> str | None:
    """The arm the analytic tier would pick for this key — the baseline a
    trained model's holdout ranking accuracy is judged against
    (tools/costmodel.py eval, gate.py --costmodel). Mirrors the registered
    priors: the tile-fill-vs-HBM model for convs, the measured
    dispatch rule for attention, XLA for epilogues, Pallas for xent."""
    kv = parse_shape_key(op, shape_key)
    if kv is None:
        return None
    try:
        if op == "conv2d":
            hout, wout = kv["out"]
            kh, kw = kv["k"]
            return "igemm" if _igemm_predict_win(
                kv["n"], hout, wout, kv["cin"], kv["cout"], kh, kw,
                int(_itemsize(dtype))) else "direct"
        if op == "attention":
            # the attention_ops prior sans platform probes: XLA at the
            # train sizes, the bundled flash kernel past S=1024
            return "flash_bundled" if (kv["sq"] > 1024
                                       and kv["sq"] == kv["sk"]) else "xla"
        if op == "epilogue":
            return "xla"
        if op == "xent":
            return "pallas"
    except (KeyError, TypeError, ValueError):
        return None
    return None
