"""Run a command that prints one JSON object a line for each phase (as
``chip_smoke.py`` does, ``{"phase": ..., ...}``) and time its phases from
the outside: each phase line is given the seconds since the line before
it. Works on any commit's ``chip_smoke.py``, so two commits' phases can
be compared in one call on the same card.

    python scripts/phase_seconds.py OUT.json -- python3 chip_smoke.py

The command's standard output passes through unchanged. ``OUT.json``
gets the command, its exit code, its total seconds and one entry a
phase line in order: ``{"phase", "seconds", "at"}``, where ``seconds``
runs from the previous phase line (or the start) to this one. Lines
printed by a spawned rank count like any other.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    out, cmd = argv[0], argv[2:]
    t0 = time.perf_counter()
    last, phases = 0.0, []
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            bufsize=1)
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        now = time.perf_counter() - t0
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "phase" in obj:
            phases.append({"phase": obj["phase"], "seconds": now - last,
                           "at": now})
            last = now
    rc = proc.wait()
    with open(out, "w") as f:
        json.dump({"command": cmd, "rc": rc,
                   "seconds": time.perf_counter() - t0, "phases": phases},
                  f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
