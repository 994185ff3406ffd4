"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` file (one ``nvcc`` per source, all
started together) and links the objects into one shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``), bound
with ``ctypes``.  The library is built at first use into ``_build/``
(git-ignored) and rebuilt whenever a source or a flag changes.  Nothing
here runs at import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["NVCC_FLAGS", "nvcc_path", "build", "library", "bucket_apply_cuda",
           "dense_apply_nd_cuda", "sweep_apply_cuda", "shift_sum_cuda"]

_HERE = pathlib.Path(__file__).parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"

# --fmad=false and the default IEEE division (no --use_fast_math) keep
# every f32 op rounded the way the plain PyTorch version rounds it.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the kernels if the library for the current sources is
    missing.  Returns (library path, compiler log; empty when the
    library was already built)."""
    lib_path = _BUILD / f"libgfasort_torch_kernels_{_tag()}.so"
    if lib_path.exists():
        return lib_path, ""
    _BUILD.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # wait for every compiler before judging any: none outlives build()
        log = [proc.communicate()[0] for proc in procs]
        for src, proc, out in zip(_sources(), procs, log):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
        # link under a temporary name, then rename: a concurrent loader
        # never sees a half-written library
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, lib_path)
    for old in _BUILD.glob("libgfasort_torch_kernels_*.so"):
        if old != lib_path:
            old.unlink(missing_ok=True)
    return lib_path, "".join(log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()[0]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gfasort_bucket_apply.argtypes = [
        ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float,
        ctypes.POINTER(ci), ctypes.POINTER(ci), ci, vp, vp, vp,
    ]
    lib.gfasort_bucket_apply.restype = ci
    lib.gfasort_dense_apply_nd.argtypes = [
        ci, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float,
        ctypes.POINTER(ci), ctypes.POINTER(ci), ci, vp, vp, vp,
    ]
    lib.gfasort_dense_apply_nd.restype = ci
    lib.gfasort_sweep_apply.argtypes = [
        ci, vp, vp, vp, vp, vp, ci, ci, ctypes.c_float, ctypes.POINTER(ci),
        ci, vp, vp,
    ]
    lib.gfasort_sweep_apply.restype = ci
    lib.gfasort_shift_sum.argtypes = [ci, vp, vp, ci, ci, ci, vp]
    lib.gfasort_shift_sum.restype = ci
    return lib


def bucket_apply_cuda(xs, pos, words, eta: float, buckets, proposals: int):
    """Launch the bucket-apply kernel on the current stream.  Inputs are
    validated by the caller (``ops/sweep_dense.bucket_apply``)."""
    lib = library()
    S = xs.shape[0]
    dsum = torch.empty_like(xs)
    csum = torch.empty_like(xs)
    nb = len(buckets)
    ks = (ctypes.c_int * nb)(*[k for k, _ in buckets])
    kis = (ctypes.c_int * nb)(*[ki for _, ki in buckets])
    wptr = [w.data_ptr() for w in words] + [None] * (4 - len(words))
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.gfasort_bucket_apply(
        xs.device.index, xs.data_ptr(), pos.data_ptr(), *wptr, len(words),
        proposals, S, float(eta), ks, kis, nb, dsum.data_ptr(),
        csum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bucket_apply kernel launch failed: CUDA error {err}")
    return dsum, csum


def dense_apply_nd_cuda(my_pos, words, my_c, eta: float, buckets,
                        proposals: int):
    """Launch the nD bucket-apply kernel on the current stream.  Inputs
    are validated by the caller (``ops/sweep_dense.dense_apply_nd``)."""
    lib = library()
    D, S = my_c.shape
    acc = torch.empty_like(my_c)
    wacc = torch.empty_like(my_pos)
    nb = len(buckets)
    ks = (ctypes.c_int * nb)(*[k for k, _ in buckets])
    kis = (ctypes.c_int * nb)(*[ki for _, ki in buckets])
    wptr = [w.data_ptr() for w in words] + [None] * (4 - len(words))
    stream = torch.cuda.current_stream(my_pos.device).cuda_stream
    err = lib.gfasort_dense_apply_nd(
        my_pos.device.index, my_pos.data_ptr(), my_c.data_ptr(), D, *wptr,
        len(words), proposals, S, float(eta), ks, kis, nb, acc.data_ptr(),
        wacc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense_apply_nd kernel launch failed: CUDA error {err}")
    return acc, wacc


def sweep_apply_cuda(xs_pad, pos_pad, sidx_pad, rank, cnt, eta: float, offs,
                     H: int):
    """Launch the fused sweep-apply kernel on the current stream.  Inputs
    are validated by the caller (``ops/sweep_fused.sweep_apply``)."""
    lib = library()
    S_pad = rank.shape[0]
    out = torch.empty(S_pad, dtype=torch.float32, device=xs_pad.device)
    ks = (ctypes.c_int * len(offs))(*offs)
    stream = torch.cuda.current_stream(xs_pad.device).cuda_stream
    err = lib.gfasort_sweep_apply(
        xs_pad.device.index, xs_pad.data_ptr(), pos_pad.data_ptr(),
        sidx_pad.data_ptr(), rank.data_ptr(), cnt.data_ptr(), S_pad, H,
        float(eta), ks, len(offs), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sweep_apply kernel launch failed: CUDA error {err}")
    return out


def shift_sum_cuda(x, halo: int, variant: str):
    """Launch a shift-sum kernel (``variant`` "global" or "smem") on the
    current stream.  Inputs are validated by the caller
    (``ops/shift_sum.shift_sum``)."""
    lib = library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gfasort_shift_sum(
        x.device.index, x.data_ptr(), out.data_ptr(), x.shape[0], halo,
        1 if variant == "smem" else 0, stream)
    if err != 0:
        raise RuntimeError(f"shift_sum kernel launch failed: CUDA error {err}")
    return out
