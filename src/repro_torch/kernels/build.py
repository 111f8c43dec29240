"""Build and load the port's hand-written CUDA kernels.

Each ``.cu`` source under ``src/repro_torch/csrc/`` is compiled on first use by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries are cached under ``build/kernels/<hash>/``, keyed by a
hash of every file in ``csrc/`` (the shared ``quant.cuh`` header included)
and the flags, so a fresh checkout builds everything at
first launch and later processes reuse the result. All sources are compiled
in parallel, one ``nvcc`` each.

Nothing here runs at import time: a host without ``nvcc`` imports the
package and runs the plain PyTorch versions on CPU tensors. On a CUDA
device, a kernel that fails to build or load raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
#: one shared library per source; the C entry points each one exports
SOURCES = ("mpmm", "wdqmm", "paged_attn", "paged_mla_attn", "flash_mha", "paged_scatter",
           "paged_gather", "paged_copy", "qntpack", "conv2d", "qkv_decode", "rowinv_bmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}
#: seconds the last :func:`ensure_built` spent compiling (0.0 on a cache hit)
BUILD_SECONDS = 0.0
#: seconds from the start of that build until each source's nvcc ended
SOURCE_SECONDS: dict[str, float] = {}
#: kernel launches per kernel name, counted by each wrapper right after its
#: launch succeeds (never by the plain versions): the proof that a run went
#: through the kernels
LAUNCHES: collections.Counter = collections.Counter()
#: counts that tell apart launches already counted under their kernel's
#: name (mpmm's batched expert products, also counted as ``mpmm``)
SUBCOUNTS = ("mpmm_experts",)


def reset_launches() -> None:
    LAUNCHES.clear()


def total_launches() -> int:
    """Kernel launches so far, each once (``SUBCOUNTS`` left out)."""
    return sum(n for k, n in LAUNCHES.items() if k not in SUBCOUNTS)


def build_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(pathlib.Path(os.environ[var]) / "bin" / "nvcc")
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def ensure_built() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library. Returns the
    loaded libraries by source name. Raises on any build or load error."""
    global BUILD_SECONDS
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return _LIBS
        out = build_root() / _digest()
        out.mkdir(parents=True, exist_ok=True)
        todo = [s for s in SOURCES if not (out / f"lib{s}.so").is_file()]
        t0 = time.perf_counter()
        if todo:
            nvcc = nvcc_path()
            procs = []
            for s in todo:
                tmp = out / f"lib{s}.{os.getpid()}.tmp.so"
                log = out / f"{s}.{os.getpid()}.log"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")]
                with open(log, "w") as f:
                    procs.append((s, tmp, log, subprocess.Popen(cmd, stdout=f,
                                                                stderr=subprocess.STDOUT)))
            SOURCE_SECONDS.clear()
            while len(SOURCE_SECONDS) < len(procs):
                for s, _, _, proc in procs:
                    if s not in SOURCE_SECONDS and proc.poll() is not None:
                        SOURCE_SECONDS[s] = time.perf_counter() - t0
                time.sleep(0.05)
            errors = []
            for s, tmp, log, proc in procs:
                os.replace(log, out / f"{s}.log")
                if proc.returncode != 0:
                    errors.append(f"{s}.cu (exit {proc.returncode}):\n"
                                  f"{(out / f'{s}.log').read_text()}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out / f"lib{s}.so")  # atomic publish
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        BUILD_SECONDS = time.perf_counter() - t0
        for s in SOURCES:
            _LIBS[s] = ctypes.CDLL(str(out / f"lib{s}.so"))
        return _LIBS


def build_logs() -> dict[str, str]:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the current build, by source name."""
    out = build_root() / _digest()
    return {s: (out / f"{s}.log").read_text()
            for s in SOURCES if (out / f"{s}.log").is_file()}


def lib(name: str) -> ctypes.CDLL:
    return ensure_built()[name]


def entry(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of source ``source``, its ``argtypes`` set
    (and an int ``restype``, the ``cudaError_t``) once, at its first call."""
    fn = _ENTRIES.get((source, symbol))
    if fn is None:
        fn = getattr(lib(source), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[source, symbol] = fn
    return fn


def library_path(name: str) -> pathlib.Path:
    """Where source ``name``'s shared library is built (for inspection)."""
    return build_root() / _digest() / f"lib{name}.so"


def check_tensor(t, name: str, dtype, device, shape=None) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
