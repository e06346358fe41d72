"""Build and load the port's CUDA kernels.

Each `llama_cu_awq_torch/csrc/<name>.cu` compiles with nvcc into its own
shared library with a plain C interface,
`build/llama_cu_awq_torch/lib<name>-<hash>.so` at the repository root, and
is loaded with ctypes. The hash covers the source, the shared headers and
the flags, so an edited source rebuilds. `build_all()` starts one nvcc per
source at once; `function()` builds a missing library on first use. Nothing
is loaded from outside the repository; nvcc comes from CUDA_HOME,
/usr/local/cuda or the PATH.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "llama_cu_awq_torch")
SOURCES = ("int4_gemv", "int4_gemm", "dense_gemm", "attention_step",
           "prefill_attention", "batched_attention", "down_qkv",
           "int4_chain")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
PTXAS_INFO: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, "
                       "PATH): the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build_all(names=SOURCES, ptxas_verbose: bool = False) -> float:
    """Compile every missing library, one nvcc per source, all started
    together. Returns the wall seconds; raises with nvcc's output when a
    build fails. With ptxas_verbose the register and shared-memory report
    of each kernel lands in PTXAS_INFO."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *flags, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        PTXAS_INFO[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.time() - t0


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        lib.llama_error_string.argtypes = [ctypes.c_int]
        lib.llama_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes):
    """The C launcher `fn_name` of lib<lib_name>, with its argtypes set
    (c_void_p for every pointer and the stream, or ctypes would pass a
    pointer as a 32-bit int); it returns a cudaError_t as int. Looked up
    once and kept: the wrappers call this on every launch."""
    fn = _FUNCS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(_load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(lib_name, fn_name)] = fn
    return fn


def check(rc: int, lib_name: str, fn_name: str) -> None:
    if rc != 0:
        msg = _load(lib_name).llama_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed: cudaError {rc} ({msg})")
