"""On-demand build of the native oracle (g++ → shared lib, ctypes).

No pybind11 in this image (see environment notes); the C ABI + ctypes
keeps the binding dependency-free.  The library is rebuilt whenever the
source hash changes.  It is built for the generic x86-64 target (no
``-march=native``), so a library built on one host loads on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sysconfig
import tempfile
import threading
from typing import Optional

_HERE = pathlib.Path(__file__).parent
_BUILD = _HERE / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_PYLIB: Optional[ctypes.PyDLL] = None
_PYLIB_FAILED = False

SOURCES = ["sgd_exact.cpp", "gfa_parser.cpp", "py_assemble.cpp", "graph_algos.cpp"]
# -ffp-contract=off: forbid FMA contraction so every f64 op rounds like
# the Rust reference (and the Python oracle); GCC's default
# -ffp-contract=fast breaks bit parity.
CXXFLAGS = [
    "-O3", "-ffp-contract=off",
    "-fPIC", "-shared", "-std=c++17", "-Wall",
    f"-I{sysconfig.get_paths()['include']}",
]


def _source_hash() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((_HERE / s).read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    tag = _source_hash()
    lib_path = _BUILD / f"libgfasort_torch_native_{tag}.so"
    if lib_path.exists():
        return lib_path
    _BUILD.mkdir(exist_ok=True)
    srcs = [str(_HERE / s) for s in SOURCES]
    # build under a temporary name, then rename: a concurrent loader
    # (another test worker) never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", *CXXFLAGS, "-o", tmp, *srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except BaseException:
        os.unlink(tmp)
        raise
    os.replace(tmp, lib_path)
    # clean stale builds
    for old in _BUILD.glob("libgfasort_torch_native_*.so"):
        if old != lib_path:
            try:
                old.unlink()
            except OSError:
                pass
    return lib_path


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; returns None if no
    C++ toolchain is available (callers fall back to the Python oracle)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            _LIB = ctypes.CDLL(str(build()))
        except (subprocess.CalledProcessError, OSError, FileNotFoundError):
            return None
        _declare(_LIB)
        return _LIB


def load_py() -> Optional[ctypes.PyDLL]:
    """Load the same library through PyDLL (GIL held) for the
    CPython-API assembly helpers in py_assemble.cpp.  Returns None if
    the native build is unavailable."""
    global _PYLIB, _PYLIB_FAILED
    if load() is None:
        return None
    with _LOCK:
        if _PYLIB is not None or _PYLIB_FAILED:
            return _PYLIB
        try:
            pylib = ctypes.PyDLL(str(build()))
            i64 = ctypes.c_int64
            pi64 = ctypes.POINTER(ctypes.c_int64)
            pylib.gfa_build_nodes.restype = ctypes.py_object
            pylib.gfa_build_nodes.argtypes = [i64, pi64, pi64, ctypes.c_void_p]
            pylib.gfa_build_edges.restype = ctypes.py_object
            pylib.gfa_build_edges.argtypes = [i64, pi64, pi64]
            pylib.remap_edge_set.restype = ctypes.py_object
            pylib.remap_edge_set.argtypes = [
                ctypes.py_object, pi64, i64, ctypes.c_int,
            ]
            pu8 = ctypes.POINTER(ctypes.c_uint8)
            pylib.node_len_fill.restype = i64
            pylib.node_len_fill.argtypes = [ctypes.py_object, pi64]
            pylib.edge_set_to_arrays.restype = i64
            pylib.edge_set_to_arrays.argtypes = [ctypes.py_object, pi64, pi64]
            pylib.flip_edge_set.restype = ctypes.py_object
            pylib.flip_edge_set.argtypes = [ctypes.py_object, pu8, i64]
            pylib.rc_nodes_inplace.restype = i64
            pylib.rc_nodes_inplace.argtypes = [ctypes.py_object, pi64, i64]
            pylib.format_s_lines.restype = ctypes.py_object
            pylib.format_s_lines.argtypes = [ctypes.py_object]
            pylib.format_l_lines.restype = ctypes.py_object
            pylib.format_l_lines.argtypes = [i64, pi64, pi64, ctypes.c_int]
            pylib.format_steps.restype = ctypes.py_object
            pylib.format_steps.argtypes = [i64, pi64]
            _PYLIB = pylib
        except (OSError, AttributeError):
            _PYLIB_FAILED = True
            return None
        return _PYLIB


def _declare(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    f64 = ctypes.c_double
    pi64 = ctypes.POINTER(ctypes.c_int64)
    pf64 = ctypes.POINTER(ctypes.c_double)
    void_p = ctypes.c_void_p
    char_p = ctypes.c_char_p

    lib.gfa_parse_file.restype = void_p
    lib.gfa_parse_file.argtypes = [char_p]
    lib.gfa_parse_buffer.restype = void_p
    lib.gfa_parse_buffer.argtypes = [char_p, i64]
    lib.gfa_error.restype = char_p
    lib.gfa_error.argtypes = [void_p]
    for name in ("gfa_n_segs", "gfa_n_links", "gfa_n_paths", "gfa_n_steps",
                 "gfa_seq_blob_len", "gfa_path_names_len"):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [void_p]
    for name in ("gfa_seg_ids", "gfa_seq_offsets", "gfa_link_from",
                 "gfa_link_to", "gfa_step_handles", "gfa_path_offsets"):
        fn = getattr(lib, name)
        fn.restype = pi64
        fn.argtypes = [void_p]
    for name in ("gfa_seq_blob", "gfa_path_names"):
        fn = getattr(lib, name)
        fn.restype = void_p  # raw pointer; read via ctypes.string_at
        fn.argtypes = [void_p]
    lib.gfa_free.restype = None
    lib.gfa_free.argtypes = [void_p]

    lib.sgd1d_exact.restype = i64
    lib.sgd1d_exact.argtypes = [
        i64, pi64, pi64, pi64, pi64,        # steps
        pi64, pi64,                          # paths
        i64, pf64,                           # nodes, x
        i64, i64, f64, u64, u64, u64,        # iter_max, mtu, theta, space*
        i64, u64,                            # fci, seed
        pf64, pf64, i64,                     # etas, zetas, zetas_len
    ]

    lib.sgd_nd_exact.restype = i64
    lib.sgd_nd_exact.argtypes = [
        i64, pi64, pi64, pi64, pi64, pi64,   # steps (+rev)
        pi64, pi64, pi64,                    # paths, node_len
        i64, i64, pf64,                      # num_nodes, dims, coords
        i64, i64, f64, u64, u64, u64,
        i64, u64,
        pf64, pf64, i64,
    ]

    lib.sgd1d_bench.restype = i64
    lib.sgd1d_bench.argtypes = [
        i64, pi64, pi64, pi64, pi64,
        pi64, pi64,
        pf64, i64, f64, f64,
        u64, u64, u64, u64,
        pf64, i64,
    ]

    i32 = ctypes.c_int32
    lib.topo_exact_order.restype = i64
    lib.topo_exact_order.argtypes = [
        i64, pi64, pi64,          # edges
        i64, pi64, i64,           # live ids, max_id
        i64, pi64, i64, pi64,     # steps, path offsets
        i32, i32,                 # use_heads, use_tails
        pi64,                     # out
    ]
    lib.priority_topo_order.restype = i64
    lib.priority_topo_order.argtypes = [
        i64, pi64, pi64,
        i64, pi64, i64,
        i64, pi64, i64, pi64,
        i64, pi64,                # priority
        i32, i32,                 # use_heads, reverse_edges
        pi64,
    ]
    lib.find_simple_components_native.restype = i64
    lib.find_simple_components_native.argtypes = [
        i64, pi64, pi64,
        i64, pi64, i64,
        i64, pi64, i64, pi64,
        pi64, pi64,               # out_chains, out_off
    ]
    lib.groom_order.restype = i64
    lib.groom_order.argtypes = [
        i64, pi64, pi64,
        i64, pi64, i64,
        i64, pi64, i64, pi64,
        i32,                      # use_bfs
        pi64,
    ]

    lib.layout_stress_2d.restype = f64
    lib.layout_stress_2d.argtypes = [
        i64, pi64, pi64, pi64, pi64,         # steps
        pi64, pi64,                          # paths
        pf64, pf64,                          # xs, ys
        ctypes.POINTER(ctypes.c_uint8),      # present
        i64, u64,                            # sample_count, seed
    ]
