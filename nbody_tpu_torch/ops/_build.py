"""Build and bind the package's CUDA kernels.

All sources under ``nbody_tpu_torch/csrc/*.cu`` are compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and linked into ONE shared library with a plain C interface,
loaded with ``ctypes``. The build runs on first use, from the sources in
this checkout only, into ``build/nbody_tpu_torch/`` at the repository
root; the library's file name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.

Every C entry point of ``SIGNATURES`` takes device pointers, sizes and a
CUDA stream, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; ``launch`` raises if that is not 0. Those of
``QUERIES`` launch nothing and return a size the caller needs. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from nbody_tpu_torch.utils.profiling import host_span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nbody_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_LL = ctypes.c_longlong
# C signature of every entry point (each returns int = cudaError_t).
SIGNATURES = {
    # tgt, nt, src_pos, src_mass, ns, range (rows), G, eps2, acc, scratch,
    # scratch floats, stream
    "nbt_direct_forces": (_P, _I, _P, _P, _I, _I, _F, _F, _P, _P,
                          ctypes.c_longlong, _P),
    # psort, cell_start, lo, cell, tiles, moments, d, k, stream
    "nbt_tile_scatter": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # psort, extra, cell_start, lo, cell, tiles, moments, cov, ext, d, k,
    # stream
    "nbt_tile_scatter_ext": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # src, dest, m, lo, cell, tiles, cov, ext, live, slot_row, idx_ext, d,
    # k, stream
    "nbt_tile_place": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _P),
    # pos, vel, acc, cov, lo, cell, inv_cell, bin, d, k, dt, c2, hdt,
    # pos_d, vel_h, mover, n_stale, stream
    "nbt_table_drift": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _F, _F, _F,
                        _P, _P, _P, _P, _P),
    # acc (raw in), cov, vel (vel_h in), G, hdt, d, k, stream
    "nbt_table_kick": (_P, _P, _P, _F, _F, _I, _I, _P),
    # mom, taps, out, p, ws, stream
    "nbt_far_taps": (_P, _P, _P, _I, _I, _P),
    # outs (host array of device pointers, one a level), levels, cell,
    # plane, stream
    "nbt_far_down": (_P, _I, _P, _P, _P),
    # tiles, far, n_far, counts, lo, cell, out, d, k, ws, eps2,
    # cutoff2, use_cutoff, stream
    "nbt_tile_near": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                      _P),
    # tiles, counts, out, nx, x0, planes, d, k, ws, eps2, cutoff2,
    # use_cutoff, stream
    "nbt_tile_near_slab": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                           _P),
    # psort, csort, cell_start, n, d, offsets, n_off, z_hw, window, eps2,
    # cutoff2, use_cutoff, acc, overflow, block, stream
    "nbt_window_sweep": (_P, _P, _P, _I, _I, _P, _I, _I, _I, _F, _F, _I, _P,
                         _P, _I, _P),
    # pos, mass, n, eps2, partial, partials (nbt_pair_potential_partials),
    # stream
    "nbt_pair_potential": (_P, _P, _I, _F, _P, ctypes.c_longlong, _P),
    # tpos, tmass, nt, spos, smass, ns, eps2, partial, partials, stream
    "nbt_pair_potential_cross": (_P, _P, _I, _P, _P, _I, _F, _P,
                                 ctypes.c_longlong, _P),
    # vals, C, n, dest, num_dest, buffer (out, then partials),
    # capacity (floats), stream
    "nbt_segment_sum": (_P, _I, _I, _P, _I, _P, ctypes.c_longlong, _P),
    # keys_in, vals_in, n, m, plan (host), n_launches, work, keys_out,
    # vals_out, stream
    "nbt_bitonic_sort": (_P, _P, _I, _I, _P, _I, _P, _P, _P, _P),
    # pos, vel, n, mats (host), half_near, ps30, mode, width, height,
    # chunks, img, u8, pts, key, rgb, rec, meta, list, tmp, stream
    "nbt_render_points": (_P, _P, _I, _P, _D, _D, _I, _I, _I, _I, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P),
    # order, n, pos, pos row stride, mass, mass stride, ids, d, extra, extra
    # row stride, e, psort, ids_out, csort, extra_out, stream
    "nbt_payload_gather": (_P, _LL, _P, _LL, _P, _LL, _P, _I, _P, _LL, _I,
                           _P, _P, _P, _P, _P),
    # phase (an index of utils.profiling.PHASES), edge (0 entry, 1 exit),
    # stream
    "nbt_phase_mark": (_I, _I, _P),
}

# Entry points that launch nothing: name -> (argument types, result type).
QUERIES = {
    # device, nt, ns -> rows of each source range of nbt_direct_forces
    # (-1 on a CUDA error)
    "nbt_direct_forces_range": ((_I, _I, _I), _I),
    # d, k, ws, field -> nbt_tile_near's plan: cells a brick (field 0),
    # rows a staged chunk (1), halo columns a group (2), dynamic shared
    # memory bytes (3); -1 for another field or a bad shape
    "nbt_tile_near_plan": ((_I, _I, _I, _I), _I),
    # field -> nbt_tile_scatter's plan: rows a staged chunk (field 0), the
    # longest run a thread sums alone (1); -1 for another field
    "nbt_tile_scatter_plan": ((_I,), _I),
    # C, n, num_dest -> floats of nbt_segment_sum's buffer
    "nbt_segment_sum_buffer_floats": ((_I, _I, _I), ctypes.c_longlong),
    # -> rows per chunk of nbt_segment_sum
    "nbt_segment_sum_chunk_rows": ((), _I),
    # device, nt, ns, cross -> float64 partials of a nbt_pair_potential
    # (cross 0) or nbt_pair_potential_cross call (-1 on a CUDA error)
    "nbt_pair_potential_partials": ((_I, _I, _I, _I), ctypes.c_longlong),
    # chunks, n_tiles, field -> nbt_render_points' scratch: list entries
    # a sprite makes at most (field 0), meta ints (1); -1 for chunks
    # outside 1-64 or another field
    "nbt_render_scratch": ((_I, _I, _I), _I),
    # phases -> 0 once the marks of the first `phases` phases are loaded
    # in the current context, else a CUDA error (nbt_phase_mark's marks)
    "nbt_phase_mark_load": ((_I,), _I),
}

# Every kernel wrapper, registered by ``counted``. A wrapper adds one to
# its ``launches`` where it launches its kernel; a replay of a captured
# step (``ops/step_graph.py``) calls no wrapper, so the graph adds the
# launches its capture recorded once per replay.
COUNTED: list = []


def counted(fn):
    """Register the kernel wrapper ``fn``, its launch counter
    ``fn.launches`` set to 0 (a decorator)."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


_lock = threading.Lock()
_lib = None
last_build = {"seconds": 0.0, "path": None, "built": False, "log": ""}


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the nbody_tpu_torch CUDA "
        "kernels are built from source on first use"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for the current sources is not
    built yet; return its path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libnbody_kernels_{_digest(srcs)}.so"
    if out.exists():
        last_build.update(path=str(out), built=False, seconds=0.0)
        return out
    nvcc, pid = _nvcc(), os.getpid()
    tmp = out.with_suffix(f".{pid}.tmp")
    objs = [BUILD_DIR / f"{s.stem}.{pid}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for s, o in zip(srcs, objs)
    ]
    log, failed = "", []
    for s, p in zip(srcs, procs):
        log += f"== {s.name}\n{p.communicate()[0]}"
        if p.returncode != 0:
            failed.append(s.name)
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed.append("link")
    for o in objs:
        o.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, out)
    last_build.update(path=str(out), built=True, seconds=secs, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the build and load
    in the span ``kernels.build``)."""
    global _lib
    with _lock:
        if _lib is None:
            with host_span("kernels.build"):
                lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in QUERIES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            lib.nbt_error_string.argtypes = [ctypes.c_int]
            lib.nbt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise if
    the launch reports a CUDA error. The device is made current only when
    it is not already (a context switch costs the host microseconds)."""
    lib = library()
    fn = getattr(lib, name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # torch's raw stream handle: a tenth of a microsecond, against several
    # for current_stream(...).cuda_stream, which builds a Stream object
    raw_stream = torch._C._cuda_getCurrentRawStream
    if index == current:
        err = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, raw_stream(index))
    if err != 0:
        msg = lib.nbt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, shape: tuple, device: torch.device,
          dtype=torch.float32, *, strided_rows: bool = False) -> int:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — the kernels take nothing else; with ``strided_rows`` its
    rows may lie at any stride, each row contiguous. Returns the row
    stride (0 for a 0-d tensor)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if strided_rows:
        if t.dim() == 2 and t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: columns must be contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.stride(0) if t.dim() else 0


def require_cuda(t: torch.Tensor, what: str) -> None:
    """A wrapper's plain version runs only for CPU tensors; any other
    device must be CUDA, where the kernel runs or the call raises."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device} are not supported")
