"""Benchmark driver: prints ONE JSON line with the north-star metric.

Metric: DOF-updates/sec/chip on the 3D explosive-source benchmark
(BASELINE.json [D]): E = 82944 P3 tets, LF4, sponge, 100-step scan, on the
engine ops/select.py chooses for the device.  A device metric needs the
device: without a GPU this exits non-zero and prints no metric.
"""

import json
import sys


def main():
    from seigen_jax.bench.device import card_name_and_power, require_gpu
    from seigen_jax.bench.throughput import main as bench_main
    from seigen_jax.utils.cache import enable_compile_cache

    require_gpu("bench (DOF-updates/s/chip is a device metric)")
    enable_compile_cache()
    out = bench_main(n=24, degree=3, n_steps=100)
    out["detail"]["card"] = card_name_and_power()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
