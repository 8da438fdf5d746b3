"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>.so`` (a git-ignored directory inside
the package) the first time a kernel of it is launched, then loaded with
``ctypes``.  A library is rebuilt when its source, or a shared header
``csrc/*.cuh``, is newer than it.  No
``--use_fast_math``: the kernels' ``expf``/``tanhf``/``logf`` must be the
accurate ones, the same that PyTorch's own CUDA ops call.
"""
import ctypes
import glob
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


def build_all(names):
    """Compile each ``csrc/<name>.cu`` whose library is missing or stale,
    one ``nvcc`` per source, all started together; returns the libraries'
    paths.  Raises (after every compiler has finished) if one failed."""
    libs, running = [], []
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    for name in names:
        src = os.path.join(CSRC_DIR, name + ".cu")
        lib = os.path.join(BUILD_DIR, "lib{}.so".format(name))
        libs.append(lib)
        if (os.path.exists(lib) and os.path.getmtime(lib)
                >= max(os.path.getmtime(f) for f in [src] + headers)):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "{}.{}.tmp".format(lib, os.getpid())
        proc = subprocess.Popen([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, src, lib, tmp, proc, time.time()))
    errors = []
    for name, src, lib, tmp, proc, t0 in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append("nvcc failed on {}:\n{}{}".format(src, out, err))
            continue
        os.replace(tmp, lib)        # atomic: no reader sees half a file
        BUILD_LOG[name] = (time.time() - t0, err.strip())
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build(name):
    """Compile ``csrc/<name>.cu`` if its library is missing or stale;
    returns the library's path."""
    return build_all([name])[0]


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


def storage_end(t):
    """The address one past the last byte of ``t``'s storage: a kernel's
    bulk copy of a row's aligned superset must not pass it."""
    return (t.data_ptr() + t.untyped_storage().nbytes()
            - t.storage_offset() * t.element_size())


def check_tensor(t, shape, dtype, device, name):
    """Raise unless ``t`` is a contiguous CUDA tensor of the given shape,
    dtype and device."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError("{} must be {} {}, got {} {}".format(
            name, tuple(shape), dtype, tuple(t.shape), t.dtype))
    if not t.is_cuda or t.device != device or not t.is_contiguous():
        raise ValueError("{} must be a contiguous tensor on {}".format(
            name, device))
