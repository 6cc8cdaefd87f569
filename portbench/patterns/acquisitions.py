"""Acquisitions back to back: the frames in host memory, as a frame grabber
delivers them, written through ``ReCoDeServer('batch')`` with thread nodes
and merged by ``merge_parts`` into a fresh directory, one after another
until the window has passed (closed loop).

Each acquisition takes its frames from a pool of ``pool_acquisitions``
acquisitions' worth, starting at its own offset: acquisition i (the
set-up's is 0) starts at ``i * offset_step`` modulo the number of
offsets, so no two acquisitions of a window hand the program the same
buffer and the same frames while the offsets last (97 for a pool of two
96-frame acquisitions and a step prime to 97).

The check: every completed acquisition's container holds all its frames,
and a sample of frames drawn from the seed over all of them, read back by
the plain reader, equals the plain reference of the pool's frame that the
acquisition was given, frame for frame.
"""

from __future__ import annotations

import shutil
import sys
import time
import traceback

import numpy as np

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch.constants import rc_cfg
from portbench.plain_reader import ContainerError, PlainContainer


def write(run, out_dir, offset: int = 0) -> dict:
    """One acquisition of the pool's frames ``offset`` .. ``offset`` +
    ``run.n_frames`` into ``out_dir``."""
    data = run.frames[offset:offset + run.n_frames]
    out_dir.mkdir()
    base = f"acq.rc{run.level}"
    init = port.InitParams("batch", str(out_dir), image_filename="acq",
                           log_filename=str(out_dir / "recode.log"), run_name="portbench",
                           verbosity=0)
    t0 = time.perf_counter()
    try:
        server = port.ReCoDeServer("batch", isolation="thread", device=run.device)
        with run.span("server.run"):
            metrics = server.run(init, run.input_params(), dark_data=run.dark, data=data)
        statuses = [node.status for node in server._nodes]
        written = sum(m.get("run_frames", 0) for m in metrics.values())
        if statuses != [rc_cfg.STATUS_CODE_IS_CLOSED] * run.nodes or written != run.n_frames:
            raise RuntimeError(f"server run: node statuses {statuses}, {written} frames written")
        with run.span("merge_parts"):
            merged = port.merge_parts(str(out_dir), base, run.nodes)
    except Exception:   # a failed acquisition is counted, and the window goes on
        traceback.print_exc(file=sys.stderr)
        return {"ok": False, "frames": 0, "bytes": 0, "seconds": time.perf_counter() - t0}
    return {"ok": True, "frames": run.n_frames, "offset": offset, "bytes": data.nbytes,
            "seconds": time.perf_counter() - t0, "run_metrics": list(metrics.values()),
            "merged": merged}


class Pattern:
    def __init__(self, run):
        self.run = run
        self.check_frames = int(run.cell.traffic["check_frames"])
        self.offsets = run.pool_frames - run.n_frames + 1
        self.offset_step = int(run.cell.traffic["offset_step"])

    def offset(self, i: int) -> int:
        """The pool offset of acquisition i; the set-up's is 0."""
        return i * self.offset_step % self.offsets

    def setup(self) -> None:
        """One acquisition of the cell's own shapes: builds the kernels and
        the host library, and brings every path of the window up once."""
        warm = self.run.tmp / "warm_up"
        if not write(self.run, warm)["ok"]:
            raise RuntimeError("the warm-up acquisition failed")
        shutil.rmtree(warm)

    def step(self, i: int) -> dict:
        return write(self.run, self.run.tmp / f"acquisition{i:04d}", self.offset(i + 1))

    def close(self) -> None:
        pass

    def check(self) -> dict:
        run = self.run
        done = run.done()
        frames_in, missing = {}, 0
        for k, step in enumerate(done):
            try:
                frames_in[k] = min(PlainContainer(step["merged"]).nz, run.n_frames)
            except ContainerError as exc:
                print(f"acquisition {k}: {exc}", file=sys.stderr)
                frames_in[k] = 0
            missing += run.n_frames - frames_in[k]
        pairs = [(k, z) for k, nz in frames_in.items() for z in range(nz)]
        picks = run.rng(1).choice(len(pairs), min(self.check_frames, len(pairs)), replace=False)
        sample = sorted(pairs[i] for i in picks)
        bad_frames = bad_pixels = 0
        expected, container = {}, (None, None)
        for k, z in sample:
            z_pool = done[k]["offset"] + z
            if z_pool not in expected:
                expected[z_pool] = run.expected(z_pool)
            try:
                if container[0] != k:
                    container = (k, PlainContainer(done[k]["merged"]))
                diff = int(np.count_nonzero(container[1].dense(z) != expected[z_pool]))
            except ContainerError as exc:
                print(f"acquisition {k}, frame {z}: {exc}", file=sys.stderr)
                diff = run.height * run.width
            bad_frames += diff > 0
            bad_pixels += diff
        return {
            "failed_acquisitions": {"value": len(run.steps) - len(done), "limit": 0},
            "missing_frames": {"value": missing, "limit": 0},
            "unchecked_frames": {"value": self.check_frames - len(sample), "limit": 0},
            "bad_frames": {"value": bad_frames, "limit": 0},
            "bad_pixels": {"value": bad_pixels, "limit": 0},
        }
