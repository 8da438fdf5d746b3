"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>.so`` (a git-ignored directory inside
the package) the first time a kernel of it is launched, then loaded with
``ctypes``.  A library is rebuilt when its source is newer than it.  No
``--use_fast_math``: the kernels' ``expf``/``tanhf``/``logf`` must be the
accurate ones, the same that PyTorch's own CUDA ops call.
"""
import ctypes
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}

#: name -> (seconds, ptxas report) of the builds made in this process
BUILD_LOG = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build(name):
    """Compile ``csrc/<name>.cu`` if its library is missing or stale;
    returns the library's path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    lib = os.path.join(BUILD_DIR, "lib{}.so".format(name))
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(lib, os.getpid())
    t0 = time.time()
    proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}{}".format(
            src, proc.stdout, proc.stderr))
    os.replace(tmp, lib)        # atomic: no reader sees half a file
    BUILD_LOG[name] = (time.time() - t0, proc.stderr.strip())
    return lib


def load(name, functions):
    """Load (building if needed) ``lib<name>.so`` and declare its C entry
    points.

    :param functions: {function name: argtypes}; every entry returns the
        ``cudaError_t`` of its launch as an int
    """
    if name in _LIBS:
        return _LIBS[name]
    lib = ctypes.CDLL(build(name))
    for fn, argtypes in functions.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err, what):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError("{} kernel launch failed: cudaError {}".format(
            what, err))


def check_tensor(t, shape, dtype, device, name):
    """Raise unless ``t`` is a contiguous CUDA tensor of the given shape,
    dtype and device."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError("{} must be {} {}, got {} {}".format(
            name, tuple(shape), dtype, tuple(t.shape), t.dtype))
    if not t.is_cuda or t.device != device or not t.is_contiguous():
        raise ValueError("{} must be a contiguous tensor on {}".format(
            name, device))
