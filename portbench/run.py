#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pyrecode_tpu_torch`` once, on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``pyrecode_tpu_torch/``.  Set-up makes the cell's frames on the card
from the seed, builds what the program builds (kept inside the checkout)
and brings the cell's path up once; the window then drives the cell's call
pattern for ``--seconds`` (the call in flight finishes); the check compares
what the window produced with the plain reference.  The last lines of
standard error are the numbers compared, each beside its limit; the last
line of standard output is the result as one JSON object: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a profiler trace of the window.

Exits with a code other than 0, printing no result, without CUDA or with
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, leads sys.path: the package is
# imported as ``portbench`` and none of its modules shadows another
sys.path[0] = CHECKOUT
# caches of the CUDA driver and of any PyTorch extension or Triton build stay
# at fixed paths inside the checkout; the program's kernels build into
# pyrecode_tpu_torch/_build/ there
CACHE = os.path.join(CHECKOUT, ".portbench_cache")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pyrecode_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``pyrecode_tpu_torch`` is not ``pyrecode_tpu``)."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    from portbench import harness, spec

    cell = spec.cell(args.workload, spec.load_benchmark())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START)

    found = loaded_forbidden()
    if found:
        print(f"the run loaded {found}: the benchmark measures pyrecode_tpu_torch alone",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": cell.chips, **result["device"],
                        "power_limit": power_limit()}
    checks = result.pop("checks")
    for name, check in checks.items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
