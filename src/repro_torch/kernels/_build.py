"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
of them at once, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. Nothing builds at
import: :func:`load_library` builds on first use into ``_build/`` beside
this file (listed in ``.gitignore``). The library's file name carries a
hash of the sources and flags, so an edited source rebuilds, and an
unchanged one loads the library already built.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "suprasnn_fused_step": (_P,) * 4 + (_I,) + (_P,) * 3 + (_I,) * 7 + (_P,),
    "suprasnn_lif_update_int": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "suprasnn_lif_update": (_P, _P, _P, _P, _L, _F, _F, _F, _P),
    "suprasnn_spike_accum": (_P, _P, _P, _I, _I, _I, _I, _P),
    "suprasnn_wkv6": (_P,) * 8 + (_I,) * 5 + (_P,),
    "suprasnn_ssd": (_P,) * 8 + (_I,) * 6 + (_P,),
}

_lock = threading.Lock()
_loaded: list[ctypes.CDLL] = []        # the process's library, once loaded


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from csrc/ at first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsuprasnn_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile every source in parallel and link them; returns the
    library path and the compilers' output (``-Xptxas -v`` register and
    shared-memory report). Raises ``RuntimeError`` on any failure."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name}:\n{log}" for src, p, log
                  in zip(sources(), procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-gencode",
                               "arch=compute_90a,code=sm_90a", "-o",
                               str(tmp_lib), *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)        # atomic: a reader never sees half
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    return out, log


def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if no library matches the
    sources. Loaded once per process: every launch calls this, so the
    sources are hashed only on the first call."""
    if _loaded:
        return _loaded[0]
    with _lock:
        if not _loaded:
            path = library_path()
            if not path.is_file():
                build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded.append(lib)
    return _loaded[0]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    making a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` unless it is already current."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
