"""Build and load the CUDA kernels of this package.

``load()`` compiles ``lbm_tpu_torch/csrc/*.cu`` with nvcc, one process per
source, all started together, links the objects into one shared library
with a plain C interface and opens it with ctypes (no PyTorch headers, so a
build takes seconds).  The library lands in
``build/lbm_tpu_torch/<hash>/liblbm_kernels.so`` at the root of the checkout,
keyed by a hash of the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the last build.  A file lock serialises concurrent
builds (parallel test workers) and the library is written under a
temporary name and renamed into place.

Flags: ``--fmad=false`` keeps every ``a*b+c`` as a multiply and an add
(FMA contraction would break bitwise equality with the torch step),
``-prec-div=true -prec-sqrt=true`` keep ``/`` and ``sqrt`` correctly
rounded; ``--use_fast_math`` is never used.

Nothing here runs at import.  A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "lbm_tpu_torch"
LIB_NAME = "liblbm_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-prec-div=true",
    "-prec-sqrt=true",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name -> argtypes; every entry point returns int (a cudaError_t, or a count).
_SIGNATURES = {
    "lbm_step_blocks": [_I, _I],
    "lbm_step_run": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P, _I, _I, _P, _I],
    "lbm_slab_step": [_P, _L, _P, _L, _P, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                      _I, _P, _P, _I],
    "lbm_ghosted_grid": [_I, _I, _I],
    "lbm_ghosted_chunk": [_P, _P, _P, _L, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                          _I, _I, _P, _I],
    "lbm_resident_grid": [_I, _I, _I],
    "lbm_resident_chunk": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P, _I],
    "lbm_blocked_grid": [_I, _I, _I, _I],
    "lbm_blocked_chunk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P,
                          _I],
    "lbm_inplace_grid": [_I, _I, _I, _I],
    "lbm_trapezoid_slab": [_P, _L, _P, _L, _P, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _F,
                           _F, _F, _I, _P, _I, _I, _I, _P, _I],
    "lbm_ca_resident_grid": [_I, _I, _I],
    "lbm_ca_resident": [_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                        _I, _F, _F, _F, _I, _P, _I],
    "lbm_ca_inplace_grid": [_I, _I, _I, _I],
    "lbm_ca_inplace": [_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                       _I, _F, _F, _F, _I, _P, _I, _P, _I],
    "lbm_hbm_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P, _I],
    "lbm_inplace_chunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P, _I, _I, _I,
                          _I, _I, _P, _I],
}
# The sweep kernels K4 and K5 share one signature per entry point.
for _kind in ("trapezoid", "skew"):
    _SIGNATURES[f"lbm_{_kind}_blocks"] = [_I, _I, _I, _I, _I]
    _SIGNATURES[f"lbm_{_kind}_smem"] = [_I, _I, _I]
    _SIGNATURES[f"lbm_{_kind}_run"] = ([_P] * 5 + [_I] * 3 + [_F] * 3 + [_I, _P] + [_I] * 5
                                       + [_P, _I])

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library if this tree has not been built yet; returns its
    path.  The compiler's report (registers, spills) is kept beside it in
    ``nvcc.log``."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock_fp:
        fcntl.flock(lock_fp, fcntl.LOCK_EX)
        try:
            if lib_path.exists():  # another process built it meanwhile
                return lib_path
            tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
            nvcc = nvcc_path()
            cmds, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = out_dir / f".{src.stem}.{os.getpid()}.o"
                cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                procs.append(subprocess.Popen(cmds[-1], cwd=CSRC, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
            outs = [proc.communicate()[0] for proc in procs]  # waits for every one
            objs = [cmd[-2] for cmd in cmds]
            cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs])
            failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
            if not failed:
                link = subprocess.run(cmds[-1], cwd=CSRC, capture_output=True, text=True)
                outs.append(link.stdout + link.stderr)
                if link.returncode != 0:
                    failed.append((cmds[-1], outs[-1]))
            (out_dir / "nvcc.log").write_text(
                "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
            )
            for obj in objs:
                pathlib.Path(obj).unlink(missing_ok=True)
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("nvcc failed:\n" + "".join(
                    " ".join(c) + "\n" + o for c, o in failed))
            os.replace(tmp, lib_path)
        finally:
            fcntl.flock(lock_fp, fcntl.LOCK_UN)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (first use) and open the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.lbm_error_string.argtypes = [ctypes.c_int]
            lib.lbm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if rc != 0:
        text = load().lbm_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({text})")
