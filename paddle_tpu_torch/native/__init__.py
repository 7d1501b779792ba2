"""The native MultiSlot parser (C, built at first use, bound with ctypes):
the port's copy of the JAX package's native/__init__.py.

`multislot_parser.c` compiles with the system compiler (`$CC`, else `cc`)
into `build/` beside it, under a name that carries the source's hash, so an
edited source builds anew. Several processes may build at once (the test
runner's workers): each compiles to a name of its own and `os.replace`s it
into place. A failed build raises with the compiler's output; there is no
quiet fall back. `_parse_multislot_py`, the plain version of the same
semantics, is reached only by `parse_multislot_file(..., native=False)`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["parse_multislot_file", "library_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "multislot_parser.c")
_BUILD = os.path.join(_DIR, "build")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the parser's shared library is (or will be) built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"multislot-{digest}.so")


def _load():
    """Compile the parser unless built, load it once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            cc = os.environ.get("CC", "cc")
            proc = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the MultiSlot parser failed ({cc} exited "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.multislot_count.restype = ctypes.c_longlong
        lib.multislot_count.argtypes = [ctypes.c_char_p]
        lib.multislot_parse.restype = ctypes.c_longlong
        lib.multislot_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
        ]
        _lib = lib
        return lib


def parse_multislot_file(path: str, widths: list[int],
                         native: bool = True) -> np.ndarray:
    """Parse one MultiSlot text file -> [n_samples, sum(widths)] float64.
    A malformed line raises ValueError, an unreadable file OSError.
    native=False runs the plain Python parser instead of the C one."""
    if not native:
        return _parse_multislot_py(path, widths)
    lib = _load()
    n = lib.multislot_count(path.encode())
    if n < 0:
        raise OSError(f"cannot read '{path}'")
    out = np.zeros((n, int(sum(widths))), dtype=np.float64)
    w = (ctypes.c_longlong * len(widths))(*widths)
    got = lib.multislot_parse(
        path.encode(), len(widths), w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got == -2:
        raise ValueError(f"malformed MultiSlot line in '{path}'")
    if got < 0:
        raise OSError(f"cannot read '{path}'")
    return out[:got]


def _parse_multislot_py(path: str, widths: list[int]) -> np.ndarray:
    """The plain version: the same semantics in Python."""
    rows = []
    row_width = int(sum(widths))
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            row = np.zeros(row_width, dtype=np.float64)
            i, off = 0, 0
            for w in widths:
                if i >= len(toks):
                    raise ValueError(f"malformed MultiSlot line in '{path}'")
                cnt = int(toks[i])
                i += 1
                vals = toks[i:i + cnt]
                if len(vals) != cnt:
                    raise ValueError(f"malformed MultiSlot line in '{path}'")
                i += cnt
                for j, v in enumerate(vals[:w]):
                    row[off + j] = float(v)
                off += w
            rows.append(row)
    if not rows:
        return np.zeros((0, row_width), dtype=np.float64)
    return np.stack(rows)
