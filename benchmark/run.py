"""One run of one benchmark cell on the card.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints, as its last line, one JSON
object: correct, attempted, failed, metrics, device (and, traced,
breakdown), then the numbers compared with their limits under `checks`;
the same numbers are the last lines of standard error. Exits non-zero
without a result where torch sees no card, or too few.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".torch_ext_build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda_cache")
sys.path[0] = str(ROOT)  # the checkout, not this folder

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
