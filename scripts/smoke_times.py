#!/usr/bin/env python3
"""Where chip_smoke.py's wall time goes: the script run as it is, with a
timestamp before each line it emits and, at the end, the inclusive
seconds and calls of every top-level function of the script and of the
tools it drives in-process (mtacc, decodebench, servebench).

    python3 scripts/smoke_times.py [OUT.json]

Run it from the root of a checkout on a machine with the card. It prints
what chip_smoke.py prints, each JSON line after an ``@T <seconds>
<phase>`` line, and writes the totals, largest first, to OUT.json
(default ``chiprun_out/smoke_times.json``). The ranks that chip_smoke.py
spawns run its functions untimed; their phases show in the ``@T`` lines.
A function's seconds include those of the functions it calls.
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()
TOTALS = {}
_emit = cs.emit


def emit(obj):
    print(f"@T {time.perf_counter() - T0:.2f} "
          f"{obj.get('phase', list(obj)[0])}", flush=True)
    _emit(obj)


def timed(name, fn):
    @functools.wraps(fn)  # spawned ranks unpickle the function by name
    def inner(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            rec = TOTALS.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - t
    return inner


def patch():
    from ddlbench_tpu_torch.tools import decodebench, mtacc, servebench

    for name, fn in list(vars(cs).items()):
        if (isinstance(fn, type(timed)) and fn.__module__ == cs.__name__
                and name not in ("emit", "main")):
            setattr(cs, name, timed(name, fn))
    cs.emit = emit
    for mod, attr in ((mtacc, "run"), (decodebench, "main"),
                      (servebench, "run")):
        setattr(mod, attr, timed(f"{mod.__name__}.{attr}",
                                 getattr(mod, attr)))


def main(argv):
    out = argv[0] if argv else os.path.join("chiprun_out",
                                            "smoke_times.json")
    patch()
    try:
        return cs.main()
    finally:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"seconds_calls": dict(sorted(
                ((k, [round(s, 3), n]) for k, (n, s) in TOTALS.items()),
                key=lambda kv: -kv[1][0]))}, f, indent=0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
