"""ctypes binding for the native CPU serving lookup
(``native/kmls_serve.cpp``) — counterpart of
``kmlserver_tpu/serving/native_serve.py``.

The engine serves through it when it runs on the CPU (and
``KMLS_NATIVE_SERVE`` allows it): the same gather + max-merge + top-k as
``ops/serve.recommend_batch``, with its exact tie order (conf desc, id
asc), as a straight C++ loop over the (B, L, K) updates instead of a
(B, V) scatter and a full sort per row. On a card the lookups stay on the
card. Built by ``utils/nativelib.py`` at first use; ``KMLS_NATIVE=0``
turns it off.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import nativelib

# must match kAbiVersion in native/kmls_serve.cpp
_ABI_VERSION = 1

# batches looked up through the library (host calls, not kernel launches)
CALLS = {"serve_topk": 0}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.kmls_serve_abi_version.restype = ctypes.c_int32
    lib.kmls_serve_abi_version.argtypes = []
    got = lib.kmls_serve_abi_version()
    if got != _ABI_VERSION:
        raise OSError(f"native serve ABI {got} != expected {_ABI_VERSION}")
    lib.kmls_serve_topk.restype = None
    lib.kmls_serve_topk.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # rule_ids (V, K)
        ctypes.POINTER(ctypes.c_float),   # rule_confs (V, K)
        ctypes.POINTER(ctypes.c_int32),   # seed_ids (B, L)
        ctypes.c_int32,                   # v
        ctypes.c_int32,                   # kmax
        ctypes.c_int32,                   # b
        ctypes.c_int32,                   # l
        ctypes.c_int32,                   # k_best
        ctypes.POINTER(ctypes.c_int32),   # out_ids (B, k_best)
        ctypes.POINTER(ctypes.c_float),   # out_confs (B, k_best)
    ]
    return lib


_LIB = nativelib.NativeLib("kmls_serve", _bind)


def available() -> bool:
    return _LIB.available()


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def host_rule_rows(rule_ids: np.ndarray, rule_confs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Contiguous int32 / float32 copies of the rule tensors in the
    library's layout: each row's live ids (>= 0) first, in their order,
    then the -1 padding — the kernel stops a row at its first -1. Emission
    writes rows that way already; a row with a hole (an id dropped as out
    of range) is compacted, which changes no answer: the merge is a max."""
    ids = np.ascontiguousarray(rule_ids, dtype=np.int32)
    confs = np.ascontiguousarray(rule_confs, dtype=np.float32)
    if ids.shape[1] > 1 and ((ids[:, :-1] < 0) & (ids[:, 1:] >= 0)).any():
        order = np.argsort(ids < 0, axis=1, kind="stable")
        ids = np.ascontiguousarray(np.take_along_axis(ids, order, axis=1))
        confs = np.ascontiguousarray(np.take_along_axis(confs, order, axis=1))
    return ids, confs


def serve_topk(
    rule_ids: np.ndarray,   # (V, K) int32, -1 padded (trailing)
    rule_confs: np.ndarray,  # (V, K) float32
    seed_ids: np.ndarray,   # (B, L) int32, -1 padded
    k_best: int,
) -> tuple[np.ndarray, np.ndarray]:
    """→ ``(top_ids (B, k_best) int32 with -1 padding, top_confs f32)`` —
    the contract of :func:`~..ops.serve.recommend_batch`, on host arrays
    (the rule rows as :func:`host_rule_rows` lays them out). The ctypes
    call releases the GIL for the whole batch."""
    lib = _LIB.load()
    if lib is None:
        raise RuntimeError("native serve kernel unavailable")
    # no copy when the arrays are in the library's layout already
    rule_ids = np.ascontiguousarray(rule_ids, dtype=np.int32)
    rule_confs = np.ascontiguousarray(rule_confs, dtype=np.float32)
    v, kmax = rule_ids.shape
    seeds = np.ascontiguousarray(seed_ids, dtype=np.int32)
    b, l = seeds.shape
    out_ids = np.empty((b, k_best), dtype=np.int32)
    out_confs = np.empty((b, k_best), dtype=np.float32)
    CALLS["serve_topk"] += 1
    lib.kmls_serve_topk(
        _ptr(rule_ids, ctypes.c_int32),
        _ptr(rule_confs, ctypes.c_float),
        _ptr(seeds, ctypes.c_int32),
        v, kmax, b, l, int(k_best),
        _ptr(out_ids, ctypes.c_int32),
        _ptr(out_confs, ctypes.c_float),
    )
    return out_ids, out_confs
