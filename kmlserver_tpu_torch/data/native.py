"""ctypes bindings for the native CSV loader (``native/kmls_csv.cpp``) —
counterpart of ``kmlserver_tpu/data/native.py``.

The library goes mmap → dictionary-encoded columns in one C++ pass: int64
pids plus, per string column, int32 codes and a first-occurrence
vocabulary (blob + offsets). ``DictColumn.materialize`` gives numpy object
arrays where the host-side aux builders need strings; ``data/csv.py``
adapts a :class:`NativeTable` into its ``TrackTable``.

Built by ``utils/nativelib.py`` at first use; callers check
:func:`available` and use the stdlib parser otherwise. ``KMLS_NATIVE=0``
turns it off. :data:`LOADS` counts which reader served each
``read_tracks`` call.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from ..utils import nativelib

# must match KMLS_ABI_VERSION in native/kmls_csv.cpp
_ABI_VERSION = 2

# read_tracks calls served by each reader: "native" (this library) or
# "stdlib" (data/csv.py's parser: the library is off or refused the file)
LOADS = {"native": 0, "stdlib": 0}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    try:
        lib.kmls_abi_version.restype = ctypes.c_int32
        lib.kmls_abi_version.argtypes = []
        got = lib.kmls_abi_version()
    except AttributeError:  # pre-versioning build
        raise OSError("native CSV loader library predates ABI versioning")
    if got != _ABI_VERSION:
        raise OSError(f"native CSV loader ABI {got} != expected {_ABI_VERSION}")
    lib.kmls_read_csv.restype = ctypes.c_void_p
    lib.kmls_read_csv.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.kmls_table_error.restype = ctypes.c_char_p
    lib.kmls_table_error.argtypes = [ctypes.c_void_p]
    lib.kmls_table_nrows.restype = ctypes.c_int64
    lib.kmls_table_nrows.argtypes = [ctypes.c_void_p]
    lib.kmls_table_pids.restype = ctypes.POINTER(ctypes.c_int64)
    lib.kmls_table_pids.argtypes = [ctypes.c_void_p]
    lib.kmls_table_ncols.restype = ctypes.c_int32
    lib.kmls_table_ncols.argtypes = [ctypes.c_void_p]
    lib.kmls_table_col_name.restype = ctypes.c_char_p
    lib.kmls_table_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.kmls_table_col_codes.restype = ctypes.POINTER(ctypes.c_int32)
    lib.kmls_table_col_codes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.kmls_table_col_vocab_size.restype = ctypes.c_int32
    lib.kmls_table_col_vocab_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.kmls_table_col_vocab_blob.restype = ctypes.POINTER(ctypes.c_char)
    lib.kmls_table_col_vocab_blob.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.kmls_table_col_vocab_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.kmls_table_col_vocab_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.kmls_table_free.restype = None
    lib.kmls_table_free.argtypes = [ctypes.c_void_p]
    return lib


_loader = nativelib.NativeLib("kmls_csv", _bind)


def available() -> bool:
    return _loader.available()


@dataclasses.dataclass
class DictColumn:
    """Dictionary-encoded string column: ``values = vocab[codes]``."""

    codes: np.ndarray  # int32 (N,)
    vocab: list[str]

    def materialize(self) -> np.ndarray:
        return np.asarray(self.vocab, dtype=object)[self.codes]


@dataclasses.dataclass
class NativeTable:
    pids: np.ndarray  # int64 (N,)
    columns: dict[str, DictColumn]

    def __len__(self) -> int:
        return len(self.pids)


def read_csv_native(path: str, skip_columns: tuple[str, ...] = ()) -> NativeTable:
    """Load ``path``; ``skip_columns`` are scanned but never interned or
    returned. Raises ``ValueError`` where the strict parser refuses the
    file (field counts, pids), ``RuntimeError`` when the library is off."""
    lib = _loader.load()
    if lib is None:
        raise RuntimeError("native CSV loader unavailable")
    handle = lib.kmls_read_csv(path.encode(), ",".join(skip_columns).encode())
    if not handle:
        raise MemoryError("kmls_read_csv allocation failed")
    try:
        err = lib.kmls_table_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n = lib.kmls_table_nrows(handle)
        # an empty vector hands back a null data(): as_array refuses it
        pids = (
            np.ctypeslib.as_array(lib.kmls_table_pids(handle), shape=(n,)).copy()
            if n else np.empty(0, dtype=np.int64)
        )
        columns: dict[str, DictColumn] = {}
        for i in range(lib.kmls_table_ncols(handle)):
            name = lib.kmls_table_col_name(handle, i).decode()
            codes = (
                np.ctypeslib.as_array(lib.kmls_table_col_codes(handle, i), shape=(n,)).copy()
                if n else np.empty(0, dtype=np.int32)
            )
            vsize = lib.kmls_table_col_vocab_size(handle, i)
            nbytes = ctypes.c_int64()
            blob_ptr = lib.kmls_table_col_vocab_blob(handle, i, ctypes.byref(nbytes))
            blob = ctypes.string_at(blob_ptr, nbytes.value) if nbytes.value else b""
            offsets = np.ctypeslib.as_array(
                lib.kmls_table_col_vocab_offsets(handle, i), shape=(vsize + 1,)
            ).copy()
            vocab = [
                blob[offsets[j]: offsets[j + 1]].decode("utf-8", "replace")
                for j in range(vsize)
            ]
            columns[name] = DictColumn(codes=codes, vocab=vocab)
        return NativeTable(pids=pids, columns=columns)
    finally:
        lib.kmls_table_free(handle)
