"""Where a Python program's host time goes: run a script under a thread
that samples its main thread's stack at a fixed interval.

    python -m aod_meh_hua_torch.tools.host_sampler --out samples.txt \\
        [--interval 0.2] chip_smoke.py [its arguments]

The report gives, per function (file:name:first line), the seconds of
samples whose stack held it (inclusive: a function counted once per
sample however deep it recurs) and, per line, the seconds of samples
that stood there (the leaf: where the thread was, be it computing,
waiting for the card or for a subprocess). The sampler reads
`sys._current_frames()` and holds the GIL only while it walks one stack,
so the program runs at its own speed; a subprocess's time shows as the
wait for it. The script runs as `__main__` with `sys.argv` set to its
path and arguments; its exit code is the tool's.
"""

from __future__ import annotations

import argparse
import collections
import os
import runpy
import sys
import threading
import time
from typing import Optional, Sequence


class StackSampler:
    """Samples one thread's stack every `interval` seconds while running
    (a daemon thread): `inclusive` and `leaf` Counters of sample counts."""

    def __init__(self, thread_id: int, interval: float = 0.2):
        self.thread_id, self.interval = thread_id, interval
        self.inclusive, self.leaf = collections.Counter(), collections.Counter()
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self.thread_id)
            if frame is None:
                continue
            self.samples += 1
            code = frame.f_code
            self.leaf[f"{_key(code)}@{frame.f_lineno}"] += 1
            seen = set()
            while frame is not None:
                key = _key(frame.f_code)
                if key not in seen:
                    seen.add(key)
                    self.inclusive[key] += 1
                frame = frame.f_back

    def __enter__(self) -> "StackSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def report(self, wall_s: float, top: int = 400, top_leaf: int = 150) -> str:
        lines = [f"wall {wall_s:.1f} s, {self.samples} samples at {self.interval} s"]
        lines += [f"{n * self.interval:8.1f} {k}" for k, n in self.inclusive.most_common(top)]
        lines += ["", "LEAF"]
        lines += [f"{n * self.interval:8.1f} {k}" for k, n in self.leaf.most_common(top_leaf)]
        return "\n".join(lines) + "\n"


def _key(code) -> str:
    return f"{os.path.basename(code.co_filename)}:{code.co_name}:{code.co_firstlineno}"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="the report's file")
    p.add_argument("--interval", type=float, default=0.2, help="seconds between samples")
    p.add_argument("script", help="the Python file to run as __main__")
    p.add_argument("args", nargs=argparse.REMAINDER, help="the script's arguments")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    a = parse_args(argv)
    script = os.path.abspath(a.script)
    argv_before, path_before = sys.argv, list(sys.path)
    sys.argv = [script, *a.args]
    sys.path.insert(0, os.path.dirname(script))
    code, t0 = 0, time.time()
    sampler = StackSampler(threading.get_ident(), a.interval)
    try:
        with sampler:
            runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        if not isinstance(e.code, int) and e.code is not None:
            print(e.code, file=sys.stderr)
    finally:  # the report also of a run that raised
        sys.argv, sys.path[:] = argv_before, path_before
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            fh.write(sampler.report(time.time() - t0))
    return code


if __name__ == "__main__":
    sys.exit(main())
