"""Build and bind the port's CUDA kernels (csrc/*.cu) on first use.

Mirrors how ``dvda_tpu/host`` builds its native library: the sources are
compiled on demand with plain ``nvcc`` into one shared library with a C
interface, rebuilt when a source is newer, and loaded with ``ctypes``.
Each source compiles in its own ``nvcc`` process, all started together,
then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <obj> dvda_tpu_torch/csrc/<kernel>.cu  # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/dvda_tpu_torch/libdvda_kernels.so <obj>...

Nothing here includes PyTorch's headers, so a build takes seconds.  A
failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

__all__ = ["kernel_library", "build_kernels", "LIB_PATH", "CU_SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
CU_SOURCES = [os.path.join(_CSRC, f) for f in ("c2_decrypt.cu",
                                               "chunk_filter.cu",
                                               "chunk_lanes.cu",
                                               "frame_remix.cu",
                                               "general_gather.cu",
                                               "huffman_decode.cu",
                                               "mlp_filter.cu",
                                               "output_stage.cu",
                                               "pcm_unpack.cu")]
_HEADERS = [os.path.join(_CSRC, f) for f in ("c2_decrypt.cuh",
                                             "chunk_filter.cuh",
                                             "chunk_lanes.cuh",
                                             "dvda_hd.cuh",
                                             "frame_remix.cuh",
                                             "general_gather.cuh",
                                             "huffman_decode.cuh",
                                             "mlp_filter.cuh",
                                             "output_stage.cuh",
                                             "pcm_unpack.cuh")]
LIB_PATH = os.path.join(os.path.dirname(_PKG), "build", "dvda_tpu_torch",
                        "libdvda_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_m = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > lib_m for s in CU_SOURCES + _HEADERS)


def build_kernels(verbose: bool = False) -> tuple[float, str]:
    """Compile the kernels into :data:`LIB_PATH` (always, even when the
    library is current); returns (seconds, compiler output).  ``verbose``
    adds ``-Xptxas -v`` (registers, shared memory and spills per kernel)."""
    out_dir = os.path.dirname(LIB_PATH)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, os.path.basename(src)[:-3] + f".{tag}.o")
            for src in CU_SOURCES]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        + ["-I", _CSRC, "-c", "-o", obj, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(CU_SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(CU_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode})")
    try:
        if not failed:
            link = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp]
                                  + objs, capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(f"link ({link.returncode})")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees half
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.remove(f)
    return time.perf_counter() - t0, log


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build_kernels()
    lib = ctypes.CDLL(LIB_PATH)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.dvda_c2_decrypt.restype = i
    lib.dvda_c2_decrypt.argtypes = [p, i64, ctypes.c_uint64, i, p, p, p]
    lib.dvda_chunk_lanes.restype = i
    lib.dvda_chunk_lanes.argtypes = [p, i64] + [p] * 4 + [p]
    lib.dvda_chunk_filter.restype = i
    lib.dvda_chunk_filter.argtypes = ([p, i64] + [p] * 3 + [i64] * 3
                                      + [p] * 2 + [i] * 3 + [p])
    lib.dvda_frame_remix.restype = i
    lib.dvda_frame_remix.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_uint, p]
    lib.dvda_lane_pack.restype = i
    lib.dvda_lane_pack.argtypes = [p] * 20 + [i] * 4 + [p]
    lib.dvda_series_remix.restype = i
    lib.dvda_series_remix.argtypes = ([p, p, i, p, p, i] + [p] * 11
                                      + [i64, i, i, p])
    lib.dvda_huffman_decode.restype = i
    lib.dvda_huffman_decode.argtypes = ([p, i64, p, i64] + [p] * 11
                                        + [i] * 7 + [i64, i64, p])
    lib.dvda_mlp_filter.restype = i
    lib.dvda_mlp_filter.argtypes = [p] * 13 + [i, i, i, p]
    lib.dvda_output_stage.restype = i
    lib.dvda_output_stage.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.dvda_output_stage_narrow.restype = i
    lib.dvda_output_stage_narrow.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.dvda_pcm_unpack.restype = i
    lib.dvda_pcm_unpack.argtypes = [p, i64, i, i, i, i, p, p, p]
    _lib = lib
    return lib
