"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all of
them started together) into a shared library with a plain C interface,
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, and
loaded with ``ctypes``.  The hash covers the source and every header, so
an edited source is rebuilt and a stale library is never loaded.  Nothing
is built at import time: the first kernel launch (or ``build_all``) does
it.

Every C entry point returns the first failed launch's error, or
``cudaGetLastError()`` after its launches; ``call`` raises on a non-zero
code.  ``LAUNCHES`` counts, per kernel, the wrapper calls that launched it
on the card; ``CALLS`` counts them per (entry point, shape) where the
wrapper names its shape.  ``launch_log`` reads what the library itself
launched: its CUDA launches and the cluster dimension of each
(``csrc/launch_log.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNELS = ("ntt", "bconv", "fused_ip", "modup")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
CALLS: dict[tuple, int] = {}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str, defines: tuple[str, ...]) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{h.hexdigest()[:16]}.so"


def compile_libs(names, defines: tuple[str, ...] = ()) -> tuple[dict, dict]:
    """Compile (in parallel) the sources ``names`` not built yet, with
    each of ``defines`` as a ``-D`` flag.

    Returns ``({name: library path}, {name: {"seconds": s, "ptxas":
    text}})``, the second for the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n, defines) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    report = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        tmp.replace(out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": (stdout + stderr).strip()}
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return todo, report


def build_all() -> dict:
    """Compile (in parallel) and load every kernel not loaded yet.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the sources
    compiled by this call."""
    paths, report = compile_libs([n for n in KERNELS if n not in _libs])
    for name, path in paths.items():
        _libs[name] = ctypes.CDLL(str(path))
    return report


def launch_log(kernel: str) -> tuple[int, list[int]]:
    """The CUDA launches ``kernel``'s library made since the previous
    read (or ``reset_counts``), and the cluster dimension of each of the
    first eight, in launch order; read from the library itself."""
    buf = (ctypes.c_longlong * 9)()
    f = lib(kernel).he2_launch_log
    f.restype = None
    f(buf)
    return buf[0], list(buf[1:1 + min(buf[0], 8)])


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        if name in _libs:
            launch_log(name)
    CALLS.clear()


def invoke(library: ctypes.CDLL, fn: str, *args) -> None:
    """Call C entry point ``fn`` of ``library``; raise on a non-zero code.

    ``args`` are Python ints: device pointers (``tensor.data_ptr()``) and
    sizes.  Every argument is passed as a 64-bit value; the C side takes
    pointers and ``long long`` sizes, and the current stream last."""
    f = getattr(library, fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * (len(args) + 1)
    stream = torch.cuda.current_stream().cuda_stream
    rc = f(*[ctypes.c_void_p(int(a)) for a in args], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def lib(kernel: str) -> ctypes.CDLL:
    """``kernel``'s library, built and loaded at first use."""
    if kernel not in _libs:
        build_all()
    return _libs[kernel]


def call(kernel: str, fn: str, *args, shape: tuple | None = None) -> None:
    """Call C entry point ``fn`` of ``kernel``'s library (``invoke``) and
    count it.  ``shape``, when given, keys the call in ``CALLS``."""
    invoke(lib(kernel), fn, *args)
    LAUNCHES[kernel] += 1
    if shape is not None:
        CALLS[shape] = CALLS.get(shape, 0) + 1


def ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def check_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: operand on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operand is not contiguous")
