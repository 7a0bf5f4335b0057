"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go to
``.kernel_build/`` beside the package, named by a hash of the sources and
flags, so an edited source is rebuilt. ``build()`` starts one ``nvcc`` per
source, all at once; nothing is built or loaded at import.

``launches`` counts, per kernel, the launches the wrappers made; the
wrappers in ``ops/`` add one where they launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"
KERNELS = ("attention", "conv1d", "act_conv", "snake", "dit_glue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# A's decode launch (csrc/attention.cu) is counted apart from A
launches: Dict[str, int] = {name: 0 for name in KERNELS + ("kv_decode",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source in parallel. Returns the wall seconds; raises on a failed build
    with the compiler's output."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in KERNELS:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name} (rc {proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)
                out.with_suffix(".log").write_text(log)   # ptxas -v
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` of kernel ``name`` (building it first if
    needed), with its argument types declared and an int return."""
    fn = _fns.get(symbol)
    if fn is not None:
        return fn
    if not _lib_path(name).exists():
        build()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _demangle(names):
    """Readable kernel names (``c++filt`` where the toolkit's host has it,
    else the mangled names)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def ptxas_report(name: str):
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function of kernel ``name``, from the ``ptxas -v`` output that
    ``build`` keeps beside the library (none for a library built without
    it)."""
    log = _lib_path(name).with_suffix(".log")
    rows, fn, spill = [], None, (0, 0)
    for line in (log.read_text() if log.exists() else "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "bytes spill stores" in line:
            parts = [p.split() for p in line.split(",")]
            spill = (int(parts[1][0]), int(parts[2][0]))
        elif "Used" in line and "registers" in line and fn is not None:
            regs = int(line.split("Used")[1].split()[0])
            rows.append([fn, regs, *spill])
            fn, spill = None, (0, 0)
    for row, pretty in zip(rows, _demangle([r[0] for r in rows])):
        row[0] = pretty
    return [tuple(r) for r in rows]


def sass_mma_counts(name: str):
    """{kernel: number of tensor-core instructions (HMMA / HGMMA)} in the
    SASS of kernel ``name``'s library, by ``cuobjdump -sass``; None where
    the toolkit has no cuobjdump."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def forbid_grad(name: str, *tensors) -> None:
    """Kernels B, C and D have no backward (nor do their Pallas
    counterparts: the codec is frozen and the vocoder is not trained). A
    call that autograd would have to differentiate raises here rather than
    return a result with no gradient; run such calls under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and "
                           "an input requires grad; call it under "
                           "torch.no_grad()")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
