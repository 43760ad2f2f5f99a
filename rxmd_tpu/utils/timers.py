"""Per-phase wall-clock accounting and the end-of-run summary table.

The reference accumulates `system_clock` ticks into a 30-slot array
`it_timer` around every significant subroutine (ref: module.F90:215-217,
e.g. LINKEDLIST main.F90:297-316, COPYATOMS comm.F90:64-98, BOCALC
bo.F90:10-23) and prints a per-phase max/min seconds table plus peak array
occupancies and memory at exit (`FinalizeMD`, ref: main.F90:128-186).

On an accelerator the interesting boundaries are different — XLA fuses the
whole MD step into one computation, so intra-step phases are visible only
through `jax.profiler`, not host clocks — but the host-level phases (compile,
neighbor rebuild, step execution, trajectory I/O) and the occupancy /
iteration counters map directly and are tracked here.
"""
from __future__ import annotations

import time
from contextlib import contextmanager


class Timers:
    """Named wall-clock accumulators + scalar counters.

    Usage::

        t = Timers()
        with t("neighbor rebuild"):
            ...
        t.count("QEq iterations", 12)        # ref: it_timer slot 24
        print("\n".join(t.summary_lines()))
    """

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.ncalls: dict[str, int] = {}
        self.counters: dict[str, float] = {}
        self.peaks: dict[str, tuple[float, float]] = {}  # name -> (used, cap)
        self._t0 = time.time()

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.ncalls[name] = self.ncalls.get(name, 0) + 1

    def add(self, name: str, seconds: float, calls: int = 1):
        self.acc[name] = self.acc.get(name, 0.0) + seconds
        self.ncalls[name] = self.ncalls.get(name, 0) + calls

    def count(self, name: str, inc: float = 1):
        self.counters[name] = self.counters.get(name, 0) + inc

    def peak(self, name: str, used: float, cap: float):
        """Track max occupancy of a fixed-capacity array (the analog of the
        reference's `maxas` statistics, ref: main.F90:128-146)."""
        old = self.peaks.get(name, (0.0, cap))[0]
        self.peaks[name] = (max(old, used), cap)

    # ------------------------------------------------------------------
    def summary_lines(self, device=None) -> list[str]:
        """FinalizeMD-style report (ref: main.F90:128-186)."""
        out = ["-" * 60, f"{'phase':>28s} {'seconds':>10s} {'calls':>8s}"]
        total = time.time() - self._t0
        for name, sec in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            out.append(f"{name:>28s} {sec:10.3f} {self.ncalls[name]:8d}")
        out.append(f"{'total wall':>28s} {total:10.3f}")
        for name, val in self.counters.items():
            out.append(f"{name:>28s} {val:10.0f}")
        if self.peaks:
            out.append(f"{'-- peak occupancy --':>28s}")
            for name, (used, cap) in self.peaks.items():
                pct = 100.0 * used / cap if cap else 0.0
                out.append(f"{name:>28s} {int(used):6d} /{int(cap):6d} "
                           f"({pct:5.1f}%)")
        if device is not None:
            stats = getattr(device, "memory_stats", lambda: None)()
            if stats and "bytes_in_use" in stats:
                mb = stats["bytes_in_use"] / 2**20
                pk = stats.get("peak_bytes_in_use", 0) / 2**20
                out.append(f"{'device memory [MB]':>28s} {mb:10.1f} "
                           f"(peak {pk:.1f})")
        out.append("-" * 60)
        return out


class RunProfile:
    """Per-print-interval profile file writer.

    The reference declares `saveRunProfile` / `RunProfilePath`
    (ref: module.F90:271-273; file closed at main.F90:126) for a per-run
    performance summary.  Lines: step, wall seconds since start, current
    atom-steps/s, QEq iterations at this step.
    """

    def __init__(self, path: str, natoms: int):
        self._fh = open(path, "w")
        self._fh.write("# step  wall_s  atom_steps_per_s  nqeq\n")
        self._t0 = time.time()
        self._last = (0, self._t0)
        self._n = natoms

    def record(self, step: int, nqeq: int):
        now = time.time()
        s0, t0 = self._last
        rate = self._n * (step - s0) / (now - t0) if step > s0 else 0.0
        self._fh.write(f"{step:9d} {now - self._t0:12.4f} {rate:14.4e} "
                       f"{nqeq:5d}\n")
        self._fh.flush()
        self._last = (step, now)

    def close(self):
        self._fh.close()
