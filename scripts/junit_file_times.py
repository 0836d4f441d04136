"""Sum a pytest junit XML's testcase times by test file, the port's files
(``tests/test_torch_*.py``) apart from the JAX package's.

    python -m pytest tests/ ... -p xdist -n 6 --dist loadfile --junitxml=FILE
    python3 scripts/junit_file_times.py FILE [--top N]

Prints the two sums, then each file's sum and test count, largest first.
The tier-1 run's limit is on its wall time; these sums say where its
workers' time went.
"""

from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def file_times(path: str) -> dict:
    """{test file's module name: (summed seconds, testcases)}."""
    times, counts = collections.defaultdict(float), collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        name = parts[1] if len(parts) > 1 else parts[0]
        times[name] += float(case.get("time") or 0.0)
        counts[name] += 1
    return {name: (times[name], counts[name]) for name in times}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="junit_file_times")
    parser.add_argument("junit")
    parser.add_argument("--top", type=int, default=0, help="files to list (0: all)")
    args = parser.parse_args(argv)
    files = file_times(args.junit)
    port = sum(t for name, (t, _) in files.items() if name.startswith("test_torch_"))
    other = sum(t for name, (t, _) in files.items() if not name.startswith("test_torch_"))
    print(f"port files {port:.1f} s summed, the JAX package's {other:.1f} s")
    ranked = sorted(files.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in ranked[:args.top or None]:
        print(f"{t:8.1f} s {n:4d} {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
