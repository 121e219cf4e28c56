"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line on standard output is the result
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``; the numbers compared, beside their
limits, under ``compared``, last). Those numbers also end standard error.

A cell on several cards runs one process a card: this process is rank 0 and
starts the others (``--rank``), which join it over ``torch.distributed``
on ``tcp://localhost``. Rank 0 writes the pool of WAV files into a new
directory under ``TMPDIR`` and removes it at the end; it waits for every
rank it started, and ends those still running if it fails.

``--control 1`` (not used by the benchmark's own runs) also reads the
control, the reference in TF32 in the program's place, on the same calls.

Exits non-zero without a result when no card is usable or fewer cards than
the cell needs are present, and when JAX, jaxlib, flax or the JAX package
are loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fadtk_tpu"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--pool", default="")
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import manifest

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    from portbench import harness

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()}, count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2

    run = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
               trace=bool(args.trace), t_start=T_START, control=bool(args.control), world=chips)
    if args.rank > 0:
        harness.run_cell(**run, rank=args.rank, port=args.port, pool_dir=Path(args.pool))
        return _clean_exit()

    pool = Path(tempfile.mkdtemp(prefix="portbench-pool-"))
    children = []
    try:
        port = 0
        if chips > 1:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            base = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                    "--seed", str(args.seed), "--seconds", str(args.seconds),
                    "--trace", str(args.trace), "--port", str(port), "--pool", str(pool)]
            children = [subprocess.Popen(base + ["--rank", str(r)], stdout=sys.stderr,
                                         env=dict(os.environ)) for r in range(1, chips)]
        result = harness.run_cell(**run, rank=0, port=port, pool_dir=pool)
        for c in children:
            c.wait(timeout=300)
        bad = [c.returncode for c in children if c.returncode != 0]
        if bad:
            print(f"portbench: ranks exited with {bad}", file=sys.stderr)
            return 1
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
        shutil.rmtree(pool, ignore_errors=True)
    return emit(result)


def emit(result: dict) -> int:
    """The numbers compared, beside their limits, as the last lines of
    standard error, then the result as the last line of standard output;
    nothing, and 3, when JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the result's process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _clean_exit() -> int:
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
