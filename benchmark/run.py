"""The benchmark of unidepth_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It builds the cell's program and weights from the seed, serves the
cell's traffic for ``--seconds`` and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; its last key,
``checks``, gives each number compared with the reference beside its
limit, and the last lines of standard error say the same. Cells,
configurations, traffic mixes and metrics are files under ``benchmark/``
(see ``harness/registry.py``).

Exits with 3, printing no result, without the cards the cell needs, and
with 4 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "benchmark_cache"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    # every kernel and build cache at a fixed place inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    from benchmark.harness import isolation, registry

    chips = registry.cell(ROOT, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3

    from benchmark.harness import session

    result, lines = session.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = isolation.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules were loaded: {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
