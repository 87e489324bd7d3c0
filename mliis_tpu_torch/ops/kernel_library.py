"""The hand-written kernels' build, binding, launch and launch count.

A kernel is a source csrc/<name>.cu with a plain C interface: each entry
point `<function>_launch` takes its arguments, then the cudaStream_t to
launch on, and returns the launch's cudaError_t. `build` compiles each
source by `nvcc` for sm_90a into BUILD_DIR, one shared library per source,
named by a digest of the source, the headers it includes and the flags;
`bind` loads an entry point with ctypes under the C signature its caller
declares; `launch` calls it on a device's current stream, raises on an
error and counts it in `launches`.

A kernel's module (ops/<name>.py) declares its signatures beside its
launches: a new kernel is a source and its module, and edits nothing here.
"""
import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

PTR, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)

# {kernel wrapper: launches}, counted by `launch`.
launches: collections.Counter = collections.Counter()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def sources() -> List[str]:
    """The kernel sources: the stems of csrc/*.cu."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_files(name: str) -> List[str]:
    """csrc/<name>.cu and every csrc/ header it includes (`#include "x"`),
    followed through the headers' own includes."""
    files = [name + ".cu"]
    for fname in files:   # the list grows as the headers are read
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            for header in _INCLUDE.findall(f.read()):
                if header.decode() not in files:
                    files.append(header.decode())
    return files


def library_path(name: str) -> str:
    """BUILD_DIR/<name>_<digest>.so, the digest over the flags and
    `source_files(name)`."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fname in source_files(name):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "{}_{}.so".format(name, h.hexdigest()[
        :12]))


def build(names: Optional[Sequence[str]] = None, verbose: bool = False
          ) -> Dict[str, Tuple[str, float, str]]:
    """Compile csrc/<name>.cu (every source by default) for sm_90a into
    BUILD_DIR, one `nvcc` per source, all started together (once per
    digest). Returns {name: (library path, build seconds, compiler
    output)}; 0 seconds for a library that was already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    jobs, out = {}, {}
    for name in sources() if names is None else names:
        lib = library_path(name)
        if os.path.exists(lib):
            out[name] = (lib, 0.0, "")
            continue
        tmp = "{}.{}.tmp".format(lib, os.getpid())
        cmd = [nvcc(), *(("-Xptxas", "-v") if verbose else ()),
               *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        jobs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (lib, tmp, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append("{}:\n{}".format(name, log))
            continue
        os.replace(tmp, lib)
        out[name] = (lib, time.time() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


_BOUND: Dict[Tuple[str, str], Callable] = {}


def bind(source: str, function: str, argtypes: Sequence) -> Callable:
    """The C entry point `<function>_launch` of csrc/<source>.cu, built at
    first use, taking `argtypes` and then the stream and returning an int
    (the cudaError_t)."""
    fn = _BOUND.get((source, function))
    if fn is None:
        lib = ctypes.CDLL(build((source,))[source][0])
        fn = getattr(lib, function + "_launch")
        fn.argtypes = list(argtypes) + [PTR]
        fn.restype = I32
        _BOUND[(source, function)] = fn
    return fn


def stream(device: torch.device) -> int:
    """The cudaStream_t of `device`'s current stream (`device` a tensor's,
    so indexed): `torch.cuda.current_stream(device).cuda_stream` without
    building a Stream object, which takes about 5 us on an H100 host."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(kernel: str, fn: Callable, device: torch.device, *args):
    """fn(*args, stream) on `device` and its current stream; raises on an
    error, and on success counts one launch under `kernel`."""
    with torch.cuda.device(device):
        err = fn(*args, stream(device))
    if err != 0:
        raise RuntimeError("{} kernel launch failed: cudaError {}".format(
            kernel, err))
    launches[kernel] += 1


def f32(v: float) -> float:
    """v rounded to float32, as a kernel's float argument holds it."""
    return float(torch.tensor(v, dtype=torch.float32))


def channels_last(t: torch.Tensor) -> bool:
    """True for a channels-last tensor that is not also contiguous."""
    return (not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
