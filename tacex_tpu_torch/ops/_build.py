"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``build/kernels/`` at the repository root,
and the file name carries a hash of the sources and flags, so an edited
source rebuilds. A missing ``nvcc`` or a failed build raises: there is no
fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the default
    toolkit location. Raises ``RuntimeError`` when none has it."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtacex_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Returns the library path; the compiler's report (registers, shared
    memory, spills) is kept beside it as ``<name>.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(work / f"{s.stem}.o"), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s in cu
        ]
        reports = []
        for src, proc in zip(cu, procs):
            text, _ = proc.communicate()
            reports.append((src.name, text, proc.returncode))
        log = "".join(f"== {name}\n{text}" for name, text, _ in reports)
        lib.with_suffix(".log").write_text(log)
        failed = [name for name, _, rc in reports if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = work / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{s.stem}.o") for s in cu)],
            capture_output=True, text=True, check=False,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tacex_deformation_pyramid.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.tacex_deformation_pyramid.restype = i32
    lib.tacex_deformation_pyramid_global.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.tacex_deformation_pyramid_global.restype = i32
    lib.tacex_deformation_pyramid_backward.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.tacex_deformation_pyramid_backward.restype = i32
    lib.tacex_deformation_pyramid_plan.argtypes = [i32, i32, ptr, ptr, ptr, i32]
    lib.tacex_deformation_pyramid_plan.restype = i32
    lib.tacex_lut_shade.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.tacex_lut_shade.restype = i32
    lib.tacex_lut_shade_bf16.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.tacex_lut_shade_bf16.restype = i32
    return lib
