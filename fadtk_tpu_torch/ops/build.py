"""Build a kernel source into a shared library with nvcc, once per content.

Every hand-written kernel of the port is one ``csrc/*.cu`` file with a plain C
entry point (helpers shared between sources live in ``csrc/*.cuh``).
``library_path`` compiles it with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into ``build/fadtk_tpu_torch/`` under a name keyed on a hash of the source, the
shared headers and the flags, so an edit rebuilds and an unchanged source is
reused; the ptxas register/shared-memory report
lands beside it as ``.log``. The wrappers load the library with ctypes.
Nothing is built at import time: only a call on a CUDA tensor builds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import log

REPO = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO / "build" / "fadtk_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's kernels are built "
            f"from {CSRC} at first use on a CUDA machine"
        )
    return found


def nvcc_command(source: Path, out: Path) -> list[str]:
    """The nvcc command line that builds ``source`` into the library ``out``;
    ``csrc/`` is on the include path, so a copy of a source elsewhere builds
    too."""
    return [nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(out), str(source)]


def library_path(source: Path) -> Path:
    """Build ``source`` (if needed) and return the library's path."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libfadtk_{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log.info(f"building {out.name} with nvcc")
    proc = subprocess.run(nvcc_command(source, tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)  # ptxas -v report
    os.replace(tmp, out)
    return out
