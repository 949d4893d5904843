"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` (the kernels' sources here, and the seeded
faults of ``repro_torch/analysis/csrc``) exposes a plain C interface and is
compiled by ``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/lib<name>-<hash>.so`` at the root of the checkout, then loaded with
``ctypes``.  The hash covers the source, every ``csrc`` header it includes
(directly or through another header) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing is built
when the module is imported.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

CSRC = Path(__file__).resolve().parent / "csrc"
#: the linter's seeded-fault kernels, looked up after :data:`CSRC`
ANALYSIS_CSRC = Path(__file__).resolve().parents[1] / "analysis" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How a launcher launches its kernel: the grid (x, y, z), the threads
    of a block, the blocks of a cluster and the dynamic shared memory in
    bytes.  Each kernel module computes it with a pure function of the
    shapes (``launch_geometry``), the mirror of its C++ launcher, for the
    linter's ``launch-resource`` rule."""
    grid: tuple
    threads: int
    cluster: int = 1
    smem: int = 0


@dataclasses.dataclass(frozen=True)
class Cost:
    """The work of one call of a kernel op, from its shapes and types
    alone, whatever runs it (the kernel or its plain version): ``flops``
    (a multiply-add is two), ``bytes`` (each input the function needs read
    once, each output written once) and whether the kernel runs its
    products on the tensor cores (``tensor_cores``) or on the CUDA cores.
    Each kernel module computes it with a pure function (``cost``), which
    the census of :mod:`repro_torch.launch.hlo` reads."""
    flops: int
    bytes: int
    tensor_cores: bool = False


#: the package's operator library: each kernel is one op,
#: ``torch.ops.repro_torch.<name>``, defined by :func:`define_op`
OPS = torch.library.Library("repro_torch", "DEF")
#: ``repro_torch.<name>`` -> its op's arguments -> :class:`Cost`
COSTS: Dict[str, Callable[..., Cost]] = {}


def define_op(schema: str, cpu, cuda, fake, cost: Callable[..., Cost]):
    """Register ``repro_torch::<schema>`` with its CPU body (the plain
    version), its CUDA body (the kernel's launch), its fake (the output's
    shape and type, for fake-tensor tracing, where it is one graph node)
    and its cost (the op's arguments -> :class:`Cost`, also registered as
    its ``torch.utils.flop_counter`` formula); returns the op.  The bodies
    are registered per device key, so an eager call reaches its body
    through the dispatcher alone (``torch.library.custom_op`` also wraps
    every call in Python)."""
    name = schema.split("(", 1)[0]
    OPS.define(schema)
    OPS.impl(name, cpu, "CPU")
    OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=OPS)
    COSTS[f"repro_torch.{name}"] = cost
    register_flop_formula(getattr(torch.ops.repro_torch, name),
                          get_raw=True)(
        lambda *args, out_val=None, **kwargs: cost(*args, **kwargs).flops)
    return getattr(torch.ops.repro_torch, name).default


def source(name: str) -> Path:
    """``<name>.cu`` in :data:`CSRC`, else in :data:`ANALYSIS_CSRC`."""
    for d in (CSRC, ANALYSIS_CSRC):
        if (d / f"{name}.cu").is_file():
            return d / f"{name}.cu"
    raise FileNotFoundError(f"no CUDA source {name}.cu in {CSRC} or "
                            f"{ANALYSIS_CSRC}")


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled library: where it is, how long ``nvcc`` took (0.0 when
    an earlier build of the same source was found) and what it printed
    (with ``-Xptxas=-v``: each kernel's registers and shared memory)."""
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def build_key(name: str) -> str:
    """The hash that names ``csrc/<name>.cu``'s library: the source, each
    header it includes with quotes that lies beside it (followed through
    headers too), and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [source(name)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        digest.update(path.name.encode() + b"\0" + text)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(text)
                 if (path.parent / inc.decode()).is_file()]
    return digest.hexdigest()[:12]


@functools.cache
def build(name: str) -> Build:
    """Compile ``<name>.cu`` (once per process and source version)."""
    src = source(name)
    out = BUILD_DIR / f"lib{name}-{build_key(name)}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    # rename last: a concurrent process never loads a half-written library
    os.replace(tmp, out)
    return Build(out, seconds, proc.stderr + proc.stdout)


def build_all(names) -> dict:
    """Build several sources at once, one ``nvcc`` process each, all
    started together; returns {name: Build}."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``<name>.cu``'s library."""
    return ctypes.CDLL(str(build(name).path))


def run_launch(lib: ctypes.CDLL, name: str, device: torch.device, *args):
    """Call ``lib.<name>_launch(*args, stream)`` on ``device``'s current
    stream and raise with CUDA's message if it returns an error (the
    launch's ``cudaGetLastError()``)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: " + getattr(
            lib, f"{name}_error_string")(rc).decode())
