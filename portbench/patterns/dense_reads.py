"""Dense reads of a container written during set-up: a viewer's or an
analysis step's calls ``ReCoDeReader.read_frames_dense(start, count)``,
back to back (closed loop), each at a start drawn from the seed.

The container is one acquisition of the run's frames, written by the
program through the server and merged; the reader is opened once.  The
check: the frames that a sample of the window's calls returned, drawn from
the seed as the calls come (a reservoir), equal the plain reference frame
for frame.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

import pyrecode_tpu_torch as port
from portbench.patterns.acquisitions import write


class Pattern:
    def __init__(self, run):
        self.run = run
        self.count = int(run.cell.traffic["frames_per_call"])
        self.keep = int(run.cell.traffic["check_calls"])
        self.starts = run.rng(2)
        self.picks = run.rng(3)
        self.kept: list = []
        self.reader = None

    def setup(self) -> None:
        step = write(self.run, self.run.tmp / "container")
        if not step["ok"]:
            raise RuntimeError("writing the container failed")
        self.reader = port.ReCoDeReader(step["merged"], device=self.run.device)
        self.reader.open()
        self.reader.read_frames_dense(0, self.count)   # the call's own shapes, once

    def step(self, i: int) -> dict:
        run = self.run
        start = int(self.starts.integers(0, run.n_frames - self.count + 1))
        t0 = time.perf_counter()
        try:
            with run.span("read_frames_dense"):
                out = self.reader.read_frames_dense(start, self.count)
        except Exception:   # a failed call is counted, and the window goes on
            traceback.print_exc(file=sys.stderr)
            return {"ok": False, "frames": 0, "bytes": 0,
                    "latency_s": time.perf_counter() - t0}
        latency = time.perf_counter() - t0
        # reservoir sample of the calls' outputs, drawn from the seed
        if i < self.keep:
            self.kept.append((start, out))
        else:
            j = int(self.picks.integers(0, i + 1))
            if j < self.keep:
                self.kept[j] = (start, out)
        return {"ok": True, "frames": self.count, "start": start,
                "bytes": self.count * run.height * run.width * 2, "latency_s": latency}

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()

    def check(self) -> dict:
        run = self.run
        bad_frames = bad_pixels = checked = 0
        expected = {}
        for start, out in self.kept:
            if out.shape != (self.count, run.height, run.width):
                print(f"a call at {start} returned shape {out.shape}", file=sys.stderr)
                bad_frames += self.count
                bad_pixels += self.count * run.height * run.width
                checked += self.count
                continue
            for j in range(self.count):
                z = start + j
                if z not in expected:
                    expected[z] = run.expected(z)
                diff = int(np.count_nonzero(out[j] != expected[z]))
                bad_frames += diff > 0
                bad_pixels += diff
                checked += 1
        self.kept.clear()
        return {
            "failed_calls": {"value": len(run.steps) - len(run.done()), "limit": 0},
            "unchecked_frames": {"value": self.keep * self.count - checked, "limit": 0},
            "bad_frames": {"value": bad_frames, "limit": 0},
            "bad_pixels": {"value": bad_pixels, "limit": 0},
        }
