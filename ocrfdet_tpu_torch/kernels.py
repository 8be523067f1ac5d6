"""Build, load and launch the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled at first use by `nvcc` for
`sm_90a` into a shared library with a plain C interface, placed under
`build/` at the root of the checkout (git-ignored), and loaded with
`ctypes`. The library's file name carries a hash of its source and of
the compiler flags, so an edited source is rebuilt and a built one is
reused. `build()` compiles several sources at once, one `nvcc` process
each. A source may hold several entry points (a forward and a
backward); each is its own `Kernel`, with its own launch count, and the
source is compiled once for all of them. A `Kernel` with `defines` is
a variant of its source compiled with those macros (`-D`), into a
library of its own.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.launch` raises if that is not 0 and
otherwise adds one to the kernel's `launches` count. Nothing here runs
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class Kernel:
    """One CUDA source file, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str,
                 defines: Sequence[str] = ()):
        self.name = name
        self.source = source          # file name under csrc/
        self.symbol = symbol          # extern "C" entry point
        self.argtypes = list(argtypes)
        self.replaces = replaces      # the Pallas kernel it stands for
        self.defines = tuple(defines)  # macros of this build of the source
        self.launches = 0
        self._lib = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def flags(self) -> list:
        return [*NVCC_FLAGS, *(f"-D{d}" for d in self.defines)]

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source_path.read_bytes())
        h.update(" ".join(self.flags()).encode())
        return BUILD_DIR / f"lib{self.source_path.stem}-{h.hexdigest()[:12]}.so"

    def _open(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source_path.stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib = (lib, fn, err)

    def function(self, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
        """Another extern "C" function of this kernel's library (built
        and loaded if need be)."""
        if self._lib is None:
            build([self])
        fn = getattr(self._lib[0], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches the kernel) and count
        the launch; raise on a CUDA error."""
        if self._lib is None:
            build([self])
        _, fn, err = self._lib
        code = fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {code} "
                f"({err(code).decode()})")
        self.launches += 1


def build(kernels: Iterable[Kernel]) -> None:
    """Compile every kernel whose library is missing, all `nvcc`
    processes at once, then load them all."""
    kernels = [k for k in kernels if k._lib is None]
    todo = list({k.library_path(): k for k in kernels
                 if not k.library_path().exists()}.values())
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        jobs = []
        for k in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *k.flags(), "-o", tmp, str(k.source_path)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((k, tmp, proc))
        failed = []
        for k, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, k.library_path())
            else:
                os.unlink(tmp)
                failed.append(f"{k.source}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for k in kernels:
        k._open(k.library_path())


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream on `t`'s device."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
