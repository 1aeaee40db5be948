"""Compare the compiler reports of two builds of the port's kernel library.

Usage, from the root of a checkout, after both libraries were built:

    python3 tools/ptxas_compare.py OTHER_CHECKOUT

Reads each checkout's newest build/kernels/*.log (nvcc's -Xptxas -v output,
kept beside the library by engine/cuda.py `build()`), reduces each to one
line per kernel instantiation (chip_smoke.py `ptxas_report`: registers,
stack, spills) and prints the lines only one of them has. Exits 1 when a
line of OTHER_CHECKOUT's report is missing from this checkout's.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_report  # noqa: E402


def report(checkout: Path) -> list:
    logs = sorted((checkout / "build" / "kernels").glob("*.log"), key=lambda p: p.stat().st_mtime)
    if not logs:
        raise SystemExit(f"no build log under {checkout}/build/kernels")
    return ptxas_report(logs[-1].read_text())


def main() -> int:
    mine, other = report(ROOT), report(Path(sys.argv[1]).resolve())
    gone = [ln for ln in other if ln not in mine]
    new = [ln for ln in mine if ln not in other]
    print(f"{len(other)} lines in the other report, {len(mine)} in this one")
    for ln in gone:
        print(f"  only in the other: {ln}")
    for ln in new:
        print(f"  only in this one: {ln}")
    return 1 if gone else 0


if __name__ == "__main__":
    sys.exit(main())
