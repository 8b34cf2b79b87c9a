"""The native CSV reader: ``csrc/csv_loader.cpp`` bound through ctypes.

Counterpart of ``multimodalautoencoder_tpu/data/fast_csv.py``, the
engine behind ``DataLoader(engine="native")`` and the CLI's ``--engine
native``.  The C++ source is a byte-for-byte copy of the JAX package's
``native/csv_loader.cpp`` that ships inside the port, so an installed
wheel has it too: a memory-mapped, multithreaded parser whose numbers
are correctly rounded.
The port's default reader (``loader.read_csv``) reproduces pandas' parser
instead, which is not always correctly rounded: on a CSV whose values
carry 17 significant digits (as pandas writes them) the two engines can
differ by many units in the last place (180 for 0.002544689905312978);
on values that pandas itself wrote back from its own reading they agree.

The library is built with ``g++`` at first use into the port's build
directory (``cuda_library.build_dir()``, not the JAX package's
``native/build/``), and rebuilt when the source is newer.  It is built for the generic x86-64 (or whatever the compiler
targets by default), not for the building host's CPU, so a library
carried to another machine still runs there; the parser rounds correctly
whatever the instruction set.  Where it cannot be built or loaded, reading raises, naming the
failed build: there is no silent fallback to the default reader.
"""

from __future__ import annotations

import csv
import ctypes
import os

import numpy as np

from multimodalautoencoder_tpu_torch.data import preprocess as pp
from multimodalautoencoder_tpu_torch.data.loader import Frame
from multimodalautoencoder_tpu_torch.ops.cuda_library import (CSRC_DIR,
                                                              NvccLibrary)

SOURCE = os.path.join(CSRC_DIR, "csv_loader.cpp")
LIBRARY = "libcsvloader.so"  # in cuda_library.build_dir()
# native/Makefile's flags without -march=native
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


class CsvLibrary(NvccLibrary):
    """``csrc/csv_loader.cpp`` built with g++ and bound; ``launches``
    stays 0 (nothing runs on a device)."""

    def __init__(self, source: str = SOURCE, library: str = LIBRARY):
        super().__init__(source, library)

    def command(self, out: str) -> list:
        return [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", out,
                self.source]

    def load(self) -> ctypes.CDLL:
        try:
            return super().load()
        except (RuntimeError, OSError) as e:
            raise RuntimeError(
                f"engine='native': building {self.source} failed: {e}"
            ) from e

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.csv_open.restype = ctypes.c_void_p
        lib.csv_open.argtypes = [ctypes.c_char_p]
        for name in ("csv_num_rows", "csv_num_cols"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.csv_header.restype = ctypes.c_char_p
        lib.csv_header.argtypes = [ctypes.c_void_p]
        lib.csv_read.restype = None
        lib.csv_read.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_int32]
        lib.csv_read_text_column.restype = ctypes.c_void_p
        lib.csv_read_text_column.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_free_string.restype = None
        lib.csv_free_string.argtypes = [ctypes.c_void_p]
        lib.csv_close.restype = None
        lib.csv_close.argtypes = [ctypes.c_void_p]


LIB = CsvLibrary()


def _text_column(lib, handle, col: int, rows: int) -> np.ndarray:
    ptr = lib.csv_read_text_column(handle, col)
    if not ptr:
        raise ValueError(f"column {col} unreadable")
    try:
        text = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    finally:
        lib.csv_free_string(ptr)
    cells = text.split("\n") if rows else []
    return np.array(cells, dtype=object)


def read_csv(path: str, n_threads: int = 0) -> Frame:
    """``loader.read_csv`` through the native parser: the same columns and
    rows, feature columns as float64 (correctly rounded, NaN for missing or
    text cells), every other column as its text."""
    lib = LIB.load()
    with open(path, newline="") as f:
        first = next(csv.reader(f), None)
    if not first:
        raise ValueError(f"{path} is empty")
    handle = lib.csv_open(path.encode())
    if not handle:
        raise IOError(f"cannot open {path}")
    try:
        rows = lib.csv_num_rows(handle)
        cols = lib.csv_num_cols(handle)
        header = lib.csv_header(handle).decode().split("\n") if cols else []
        values = np.empty((rows, cols), dtype=np.float64)
        index = np.full(rows, np.nan)
        lib.csv_read(handle,
                     values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     index.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     n_threads)
        # the parser takes a first column with an empty name (pandas'
        # to_csv) as the index; any other first column is a column to it
        has_index = first[0] == ""
        start = 0 if has_index else 1
        feats = set(pp.get_wanted_feats_from_df(header[start:]))
        columns = {}
        for j in range(start, cols):
            name = header[j]
            columns[name] = (values[:, j].copy() if name in feats
                             else _text_column(lib, handle, j, rows))
        if has_index:
            labels = np.where(np.isnan(index), np.arange(rows), index)
            idx = labels.astype(np.int64).astype(str).astype(object)
            return Frame("", idx, columns)
        return Frame(header[0], _text_column(lib, handle, 0, rows), columns)
    finally:
        lib.csv_close(handle)
