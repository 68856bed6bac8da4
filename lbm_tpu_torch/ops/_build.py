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

Every launch of a solver kernel goes through :func:`launch` (or a launcher
:func:`bind` made), which checks the entry point's return code and counts
the launch in :data:`LAUNCHES` under the kernel's form, one of
:data:`KERNEL_FORMS`.

Nothing here runs at import.  A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import collections
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

# The 22 kernel forms of PERF.md's kernel table, in its order: the names
# LAUNCHES counts under (and tools/verify_device.py's probes).
KERNEL_FORMS = ("K1", "K1-i16", "K1-slab", "K1-slab-i16", "K2", "K3", "K3-i16", "K4", "K4-i16",
                "K4-slab", "K4-slab-i16", "K5", "K5-i16", "K6", "K7", "K8", "K8-i16", "K9", "K10",
                "K1-batch", "K2-batch", "K11")
_FORMS = frozenset(KERNEL_FORMS)
# Kernel launches made so far in this process, by form; raised only by launch().
LAUNCHES: collections.Counter = collections.Counter()

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
    "lbm_step_batch_run": [_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I],
    "lbm_resident_batch_blocks": [_I],
    "lbm_resident_batch_chunk": [_P, _P, _P, _L, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P,
                                 _I],
    "lbm_cluster_batch_max_clusters": [_I, _I, _I, _I],
    "lbm_cluster_batch_chunk": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                _I],
    "lbm_smem_copy_grid": [_I, _I],
    "lbm_smem_copy": [_P, _I, _I, _I, _P, _I],
    "lbm_ghosted_grid": [_I, _I, _I],
    "lbm_ghosted_chunk": [_P, _P, _P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I,
                          _I, _P, _I],
    "lbm_resident_grid": [_I, _I, _I],
    "lbm_resident_chunk": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P, _I],
    "lbm_blocked_grid": [_I, _I, _I, _I],
    "lbm_blocked_chunk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P,
                          _I],
    "lbm_inplace_grid": [_I, _I, _I, _I],
    "lbm_trapezoid_slab": [_P, _L, _P, _L, _P, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _F,
                           _F, _F, _I, _P, _I, _I, _I, _P, _I],
    "lbm_trapezoid_grid": [_I, _I, _I, _I],
    "lbm_ca_resident_grid": [_I, _I, _I],
    "lbm_ca_resident": [_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                        _I, _F, _F, _F, _I, _P, _I],
    "lbm_ca_inplace_grid": [_I, _I, _I, _I],
    "lbm_ca_inplace": [_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                       _I, _F, _F, _F, _I, _P, _I, _P, _I],
    "lbm_hbm_grid": [_I, _I, _I],
    "lbm_hbm_run": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P, _I],
    "lbm_inplace_chunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P, _I, _I, _I,
                          _I, _I, _P, _I],
    "lbm_skew_grid": [_I, _I, _I],
    "lbm_l2_copy_grid": [_I],
    "lbm_l2_copy": [_P, _L, _I, _I, _I, _P, _I],
}
# The sweep kernels K4 and K5 share one signature per entry point.
for _kind in ("trapezoid", "skew"):
    _SIGNATURES[f"lbm_{_kind}_blocks"] = [_I, _I, _I, _I, _I]
    _SIGNATURES[f"lbm_{_kind}_smem"] = [_I, _I, _I]
    _SIGNATURES[f"lbm_{_kind}_run"] = ([_P] * 5 + [_I] * 3 + [_F] * 3 + [_I, _P] + [_I] * 5
                                       + [_P, _I])

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources(src: pathlib.Path = CSRC) -> list[pathlib.Path]:
    return sorted(src.glob("*.cu")) + sorted(src.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def build_dir(src: pathlib.Path = CSRC) -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources(src):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(src: pathlib.Path = CSRC) -> pathlib.Path:
    """Compile the library of the sources in ``src`` (the package's own by
    default) if they have not been built yet; returns its path.  The
    compiler's report (registers, spills) is kept beside it in
    ``nvcc.log``."""
    out_dir = build_dir(src)
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
            for cu in sorted(src.glob("*.cu")):
                obj = out_dir / f".{cu.stem}.{os.getpid()}.o"
                cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)])
                procs.append(subprocess.Popen(cmds[-1], cwd=src, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
            outs = [proc.communicate()[0] for proc in procs]  # waits for every one
            objs = [cmd[-2] for cmd in cmds]
            cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs])
            failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
            if not failed:
                link = subprocess.run(cmds[-1], cwd=src, capture_output=True, text=True)
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


def _open(path: pathlib.Path, strict: bool = True) -> ctypes.CDLL:
    """Open a built library and declare its entry points; ``strict=False``
    skips those it lacks (an earlier version of a kernel)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if not strict and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """Build (first use) and open the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _open(build())
        return _lib


def load_variant(replace: dict[str, pathlib.Path]) -> ctypes.CDLL:
    """Build and open a second library: the package's sources with the files
    named in ``replace`` (e.g. ``{"temporal.cu": path}``) taken from
    elsewhere, such as an earlier commit's kernel, so that two versions of a
    kernel can be timed in one process.  The sources are copied to
    ``BUILD_ROOT/src-<hash>/`` and built beside the package's own build."""
    h = hashlib.sha256()
    for name, path in sorted(replace.items()):
        h.update(name.encode())
        h.update(pathlib.Path(path).read_bytes())
    src = BUILD_ROOT / f"src-{h.hexdigest()[:16]}"
    if not src.exists():
        tmp = BUILD_ROOT / f".{src.name}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        for f in sources():
            shutil.copy(replace.get(f.name, f), tmp / f.name)
        os.replace(tmp, src)
    return _open(build(src), strict=False)


def check(rc: int, what: str, lib: ctypes.CDLL | None = None) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point of ``lib``
    (the package's library by default), with that library's text for it."""
    if rc != 0:
        text = (lib or load()).lbm_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({text})")


def _check_form(kernel: str) -> None:
    if kernel not in _FORMS:
        raise ValueError(f"unknown kernel form {kernel!r}; the table's are {KERNEL_FORMS}")


def launch(lib: ctypes.CDLL, entry: str, kernel: str, *args, n: int = 1) -> None:
    """Call ``lib``'s entry point ``entry`` with ``args``, raise on the error
    it returns, and count ``n`` launches of ``kernel`` (a name of
    :data:`KERNEL_FORMS`) in :data:`LAUNCHES`: the kernel launches the call
    made (steps for K1 and K1-batch, sweeps for K4, K5 and K9, chunks for
    the persistent kernels)."""
    _check_form(kernel)
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        check(rc, f"{kernel} ({entry})", lib)
    LAUNCHES[kernel] += n


def bind(lib: ctypes.CDLL, entry: str, kernel: str, head: tuple, tots, steps: int,
         tail: tuple, keep: tuple):
    """A slab or sweep binder's ``launch(t0)``: :func:`launch` of ``entry``
    with ``head``, the address of ``tots[t0]`` (a 1-D float32 tensor) and
    ``tail``, the call's ``steps`` sums landing in ``tots[t0 : t0 + steps]``,
    one launch of ``kernel`` a call.  Its arguments are fixed here, so that
    a launch costs one Python call: a sharded step makes one a shard, and
    the host paces it.  ``keep`` holds what the call reads and writes by
    address, alive while the launcher is."""
    _check_form(kernel)
    fn = getattr(lib, entry)
    tot0, tot_n = tots.data_ptr(), tots.shape[0]

    def launch(t0):
        if not 0 <= t0 <= tot_n - steps:
            raise IndexError(f"steps {t0}..{t0 + steps} outside tots of {tot_n}")
        rc = fn(*head, tot0 + 4 * t0, *tail)
        if rc != 0:
            check(rc, f"{kernel} ({entry})", lib)
        LAUNCHES[kernel] += 1

    launch.keep = keep
    return launch
