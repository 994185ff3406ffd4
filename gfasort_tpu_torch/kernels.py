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
import re
import shutil
import subprocess
import tempfile
import time

import torch

__all__ = ["NVCC_FLAGS", "nvcc_path", "build", "source_seconds",
           "ptxas_report", "library",
           "bind_entry",
           "bucket_apply_cuda", "dense_apply_nd_cuda", "sweep_apply_cuda",
           "shift_sum_cuda", "sweep_sampler_cuda", "roll_apply_cuda",
           "roll_apply_nd_cuda"]

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
    library was already built).  The log ends with one line per source,
    ``nvcc <source> <seconds> s``, the seconds from the start of the
    build to that compiler's exit (:func:`source_seconds`)."""
    lib_path = _BUILD / f"libgfasort_torch_kernels_{_tag()}.so"
    if lib_path.exists():
        return lib_path, ""
    _BUILD.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
        objs, procs, outs = [], [], []
        t0 = time.perf_counter()
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            outs.append(open(os.path.join(tmpdir, src.stem + ".log"), "w+"))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=outs[-1], stderr=subprocess.STDOUT, text=True))
        # wait for every compiler before judging any: none outlives build()
        seconds = {}
        while len(seconds) < len(procs):
            for src, proc in zip(_sources(), procs):
                if src.name not in seconds and proc.poll() is not None:
                    seconds[src.name] = time.perf_counter() - t0
            time.sleep(0.02)
        log = []
        for out in outs:
            out.seek(0)
            log.append(out.read())
            out.close()
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
    times = "".join(f"nvcc {name} {secs:.2f} s\n"
                    for name, secs in seconds.items())
    return lib_path, "".join(log) + times


def source_seconds(log: str) -> dict:
    """{source: seconds from the build's start to its compiler's exit}
    from a :func:`build` log."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^nvcc (\S+) ([0-9.]+) s$", log, re.M)}


def ptxas_report(log: str) -> list:
    """One dict per compiled kernel from the ``-Xptxas -v`` lines of a
    build log: its name (demangled by the toolkit's ``cu++filt`` where
    there is one), registers, shared memory and spill bytes."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rows.append({"kernel": m.group(1)})
        elif rows and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            rows[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif rows and "Used" in line and "registers" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(m.group(1)) if m else 0
    try:
        cufilt = pathlib.Path(nvcc_path()).with_name("cu++filt")
        out = subprocess.run([str(cufilt)] + [r["kernel"] for r in rows],
                             capture_output=True, text=True, check=True)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                r["kernel"] = name.replace("(anonymous namespace)::", "")
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        pass   # keep the mangled names
    return rows


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CD = ctypes.c_double
_IP = ctypes.POINTER(_CI)
_UP = ctypes.POINTER(ctypes.c_uint)
# the C entry points of csrc/*.cu and their ctypes argument types
_ARGTYPES = {
    "gfasort_bucket_apply": [_CI, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI,
                             _CF, _IP, _IP, _CI, _VP, _VP, _VP],
    "gfasort_dense_apply_nd": [_CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _CI, _CI,
                               _CI, _CF, _IP, _IP, _CI, _VP, _VP, _VP],
    "gfasort_sweep_apply": [_CI, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CF, _IP,
                            _CI, _VP, _VP],
    "gfasort_shift_sum": [_CI, _VP, _VP, _CI, _CI, _CI, _VP],
    "gfasort_shift_sum_outputs_per_pass": [_CI],
    "gfasort_sweep_sampler": [_CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _VP,
                              _CI, _CI, _CI, _CI, _CI, _CI, _UP, _UP,
                              _VP, _VP, _VP, _VP, _VP, _VP],
    "gfasort_sweep_sampler_tf": [_CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _VP,
                                 _CI, _CI, _CI, _CI, _CI, _CI, _CI, _UP,
                                 _VP, _VP, _VP, _VP, _VP, _VP],
    "gfasort_roll_apply": [_CI, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI,
                           _CF, _IP, _IP, _CI, _VP, _VP, _VP, _VP],
    "gfasort_roll_apply_nd": [_CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _VP,
                              _VP, _CI, _CI, _CI, _CF, _IP, _IP, _CI, _VP,
                              _VP, _VP, _VP],
    "gfasort_roll_apply_f64": [_CI, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI,
                               _CI, _CD, _IP, _IP, _CI, _VP, _VP, _VP, _VP],
    "gfasort_roll_apply_nd_f64": [_CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP,
                                  _VP, _VP, _CI, _CI, _CI, _CD, _IP, _IP, _CI,
                                  _VP, _VP, _VP, _VP],
}


def bind_entry(lib: ctypes.CDLL, name: str, suffix: str = ""):
    """Set the ctypes signature of the C entry point ``name`` +
    ``suffix`` in ``lib`` (``tools/kernel_ab`` loads earlier builds with
    renamed entry points) and return it."""
    fn = getattr(lib, name + suffix)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _CI
    return fn


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name in _ARGTYPES:
        bind_entry(lib, name)
    return lib


def _word_ptrs(words):
    """The choice words' device pointers, NULL-padded to four."""
    return [w.data_ptr() for w in words] + [None] * (4 - len(words))


def _bucket_arrays(buckets):
    """(ks, kis, n) of a bucket list, as the C entry points take them."""
    nb = len(buckets)
    return ((ctypes.c_int * nb)(*[k for k, _ in buckets]),
            (ctypes.c_int * nb)(*[ki for _, ki in buckets]), nb)


def bucket_apply_cuda(xs, pos, words, eta: float, buckets, proposals: int,
                      entry=None):
    """Launch the bucket-apply kernel on the current stream.  Inputs are
    validated by the caller (``ops/sweep_dense.bucket_apply``).
    ``entry``: the C entry point to launch (default: this library's;
    ``tools/kernel_ab`` passes an earlier build's)."""
    entry = entry or library().gfasort_bucket_apply
    S = xs.shape[0]
    dsum = torch.empty_like(xs)
    csum = torch.empty_like(xs)
    ks, kis, nb = _bucket_arrays(buckets)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = entry(
        xs.device.index, xs.data_ptr(), pos.data_ptr(), *_word_ptrs(words),
        len(words), proposals, S, float(eta), ks, kis, nb, dsum.data_ptr(),
        csum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bucket_apply kernel launch failed: CUDA error {err}")
    return dsum, csum


def dense_apply_nd_cuda(my_pos, words, my_c, eta: float, buckets,
                        proposals: int, entry=None):
    """Launch the nD bucket-apply kernel on the current stream.  Inputs
    are validated by the caller (``ops/sweep_dense.dense_apply_nd``);
    ``entry`` as in :func:`bucket_apply_cuda`."""
    entry = entry or library().gfasort_dense_apply_nd
    D, S = my_c.shape
    acc = torch.empty_like(my_c)
    wacc = torch.empty_like(my_pos)
    ks, kis, nb = _bucket_arrays(buckets)
    stream = torch.cuda.current_stream(my_pos.device).cuda_stream
    err = entry(
        my_pos.device.index, my_pos.data_ptr(), my_c.data_ptr(), D,
        *_word_ptrs(words), len(words), proposals, S, float(eta), ks, kis, nb,
        acc.data_ptr(), wacc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense_apply_nd kernel launch failed: CUDA error {err}")
    return acc, wacc


def sweep_apply_cuda(xs_pad, pos_pad, sidx_pad, rank, cnt, eta: float, offs,
                     H: int, entry=None):
    """Launch the fused sweep-apply kernel on the current stream.  Inputs
    are validated by the caller (``ops/sweep_fused.sweep_apply``);
    ``entry`` as in :func:`bucket_apply_cuda`."""
    entry = entry or library().gfasort_sweep_apply
    S_pad = rank.shape[0]
    out = torch.empty(S_pad, dtype=torch.float32, device=xs_pad.device)
    ks = (ctypes.c_int * len(offs))(*offs)
    stream = torch.cuda.current_stream(xs_pad.device).cuda_stream
    err = entry(
        xs_pad.device.index, xs_pad.data_ptr(), pos_pad.data_ptr(),
        sidx_pad.data_ptr(), rank.data_ptr(), cnt.data_ptr(), S_pad, H,
        float(eta), ks, len(offs), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sweep_apply kernel launch failed: CUDA error {err}")
    return out


def shift_sum_cuda(x, halo: int, variant: str, entry=None):
    """Launch a shift-sum kernel (``variant`` "global" or "smem") on the
    current stream.  Inputs are validated by the caller
    (``ops/shift_sum.shift_sum``); ``x`` may start at any element of its
    storage, the output is a new (aligned) tensor.  ``entry`` as in
    :func:`bucket_apply_cuda`."""
    entry = entry or library().gfasort_shift_sum
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = entry(x.device.index, x.data_ptr(), out.data_ptr(), x.shape[0],
                halo, 1 if variant == "smem" else 0, stream)
    if err != 0:
        raise RuntimeError(f"shift_sum kernel launch failed: CUDA error {err}")
    return out


def sweep_sampler_cuda(consts, key_words, cooling: bool, rank, cnt,
                       active_frac: float, snap: str, coin: bool,
                       entry=None, threefry: bool = False):
    """Launch the per-sweep sampler kernel on the current stream: (the
    choice words, the end coin or None).  Inputs are validated by the
    caller (``ops/sweep_common.sample_words``); ``consts`` is the
    phase's ``SamplerConsts`` on the same device (f32, or f64 with
    ``threefry``); ``key_words`` the sweep's u32 key rows: ``(b2, b1)``
    words per proposal for the hash kernel, ``(k1, k2)`` keys per
    proposal [P, 2, 2] for the threefry kernel (``threefry``).  ``entry``
    as in :func:`bucket_apply_cuda`."""
    lib = library() if entry is None else None
    S = rank.shape[0]
    P = len(key_words)
    n_words = 1 if P == 1 else -(-P // 4)
    words = [torch.empty(S, dtype=torch.int32, device=rank.device)
             for _ in range(n_words)]
    end_coin = (torch.empty(S, dtype=torch.bool, device=rank.device)
                if coin else None)
    # the activity coin as sample_blocks draws it; -1: every proposal on
    thresh = int(active_frac * (1 << 20)) if active_frac < 1.0 else -1
    stream = torch.cuda.current_stream(rank.device).cuda_stream
    common = (rank.device.index, rank.data_ptr(), cnt.data_ptr(), S,
              consts.offs.data_ptr(), consts.zeta.data_ptr(),
              consts.eta_z.data_ptr(), consts.zeta2theta.data_ptr(),
              consts.alpha.data_ptr(), consts.offs.shape[0],
              int(consts.space), int(bool(cooling)), thresh,
              int(snap == "down"), P)
    tail = (*_word_ptrs(words),
            end_coin.data_ptr() if end_coin is not None else None, stream)
    if threefry:
        entry = entry or lib.gfasort_sweep_sampler_tf
        keys = [int(w) for row in key_words for k in row for w in k]
        err = entry(*common, int(consts.zeta.dtype == torch.float64),
                    (ctypes.c_uint * len(keys))(*keys), *tail)
    else:
        entry = entry or lib.gfasort_sweep_sampler
        b2 = (ctypes.c_uint * P)(*[int(w[0]) for w in key_words])
        b1 = (ctypes.c_uint * P)(*[int(w[1]) for w in key_words])
        err = entry(*common, b2, b1, *tail)
    if err != 0:
        raise RuntimeError(f"sweep_sampler kernel launch failed: CUDA error {err}")
    return words, end_coin


def roll_apply_cuda(xs, pos, words, eta: float, buckets, proposals: int,
                    dsum, csum, entry=None):
    """Launch the 1D roll-pass-and-combine kernel on the current stream:
    the new xs (f32, or f64 through the f64 entry point).  Inputs are
    validated by the caller (``ops/roll_apply.roll_apply``);
    ``dsum``/``csum`` may be None (+0); ``entry`` as in
    :func:`bucket_apply_cuda`."""
    f64 = xs.dtype == torch.float64
    entry = entry or (library().gfasort_roll_apply_f64 if f64
                      else library().gfasort_roll_apply)
    out = torch.empty_like(xs)
    ks, kis, nb = _bucket_arrays(buckets)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = entry(
        xs.device.index, xs.data_ptr(), pos.data_ptr(), *_word_ptrs(words),
        len(words), proposals, xs.shape[0], float(eta), ks, kis, nb,
        dsum.data_ptr() if dsum is not None else None,
        csum.data_ptr() if csum is not None else None, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roll_apply kernel launch failed: CUDA error {err}")
    return out


def roll_apply_nd_cuda(my_pos, my_c, lane0, cs, words, eta: float, buckets,
                       proposals: int, acc, wacc, entry=None):
    """Launch the nD roll-pass-and-combine kernel on the current stream:
    the new cs [2D, S] (f32, or f64 through the f64 entry point).
    Inputs are validated by the caller
    (``ops/roll_apply.roll_apply_nd``); ``acc``/``wacc`` may be None
    (+0); ``entry`` as in :func:`bucket_apply_cuda`."""
    f64 = my_pos.dtype == torch.float64
    entry = entry or (library().gfasort_roll_apply_nd_f64 if f64
                      else library().gfasort_roll_apply_nd)
    D, S = my_c.shape
    out = torch.empty_like(cs)
    ks, kis, nb = _bucket_arrays(buckets)
    stream = torch.cuda.current_stream(my_pos.device).cuda_stream
    err = entry(
        my_pos.device.index, my_pos.data_ptr(), my_c.data_ptr(), D,
        lane0.data_ptr(), cs.data_ptr(), *_word_ptrs(words), len(words),
        proposals, S, float(eta), ks, kis, nb,
        acc.data_ptr() if acc is not None else None,
        wacc.data_ptr() if wacc is not None else None, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roll_apply_nd kernel launch failed: CUDA error {err}")
    return out
