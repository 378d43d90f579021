"""Run one cell of BENCHMARK.json once, on the card, and print its result
line last on standard output:

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Run from anywhere in a checkout that holds ``src/repro_torch``; the
port's CUDA libraries build into ``build/`` inside it at first use.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare() -> bool:
    """Point the program's caches into the checkout's ``build/`` and put
    the checkout and its ``src`` first on the path; False where the
    checkout holds no ``src/repro_torch``."""
    src = os.path.join(ROOT, "src")
    if not os.path.isfile(os.path.join(src, "repro_torch", "__init__.py")):
        print("portbench: this checkout holds no src/repro_torch",
              file=sys.stderr)
        return False
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        del sys.path[0]
    sys.path[:0] = [ROOT, src]
    return True


def main() -> int:
    if not prepare():
        return 2
    from portbench.bench import harness
    return harness.main(ROOT, sys.argv[1:], t0=T0)


if __name__ == "__main__":
    sys.exit(main())
