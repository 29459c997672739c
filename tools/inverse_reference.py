"""Runs the JAX package's config 5 trainer (gpupathtracer_tpu.grad.inverse.
run_inverse_demo) on the CPU at its defaults and prints its result as one
JSON line: the reference that the port's trainer is compared with.

    python3 tools/inverse_reference.py [STEPS]

STEPS defaults to 100, the CLI's default. The result (loss history,
recovered albedo, errors) is the reference's; its wall time is a CPU time
and says nothing about a device.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gpupathtracer_tpu.grad.inverse import run_inverse_demo  # noqa: E402


def main() -> None:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    t0 = time.perf_counter()
    result = run_inverse_demo(steps=steps)
    result["cpu_wall_s"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
