"""``python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1``:
one run of one cell (see :mod:`benchmark.harness`)."""
import os
import sys
import time


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    ``/proc``; where it cannot be read, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    t_start = process_start()  # before the heavy imports: set-up counts from the process's start
    from benchmark.harness import main

    sys.exit(main(t_start=t_start))
