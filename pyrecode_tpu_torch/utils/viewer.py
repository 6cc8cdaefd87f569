"""Live viewer: sum sparse frames from part files during acquisition.

The port of pyrecode_tpu/utils/viewer.py, over the port's ReCoDeReader
(its ``device``, "cuda" or "cpu", is the readers').  Capability parity with the reference ``utils/viewer.py`` and the richer
notebook variants (examples/ReCoDe_Live_View*.ipynb): poll N intermediate
part files while a run is in progress, k-way merge the next frames in
acquisition order, and accumulate ``fractionation`` frames into a 2-D view.
EOF-safe: a partially-written frame leaves the reader position untouched so
the next poll retries (the notebooks' ``_save_seek_position`` pattern).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..reader import ReCoDeReader


class ReCoDeViewer:
    """Polling viewer over intermediate part files."""

    def __init__(self, folder_path: str, base_filename: str, num_parts: int,
                 fractionation: int, device="cuda"):
        self._num_parts = num_parts
        self._fractionation = fractionation
        self._readers: Dict[int, ReCoDeReader] = {}
        for index in range(num_parts):
            name = os.path.join(folder_path, f"{base_filename}_part{index:03d}")
            reader = ReCoDeReader(name, is_intermediate=True, device=device)
            reader.open()
            self._readers[index] = reader
        shape = self._readers[0].get_shape()
        self._ny, self._nx = shape[1], shape[2]
        self._view: Optional[np.ndarray] = None
        self._frame_start = 0
        self._buffers: Dict[int, List[dict]] = {i: [] for i in range(num_parts)}

    def _get_next_frame_safely(self, reader_index: int):
        """Read the next frame only if fully present; on a short read restore
        the file position so the next poll can retry."""
        reader = self._readers[reader_index]
        position = reader.get_file_position()
        try:
            frame = reader.get_next_frame()
        except Exception:
            frame = None
        if frame is None:
            reader._fp.seek(position)
            # keep the sequential index consistent with the restored position
            return None
        return frame

    def get_next_view(self) -> dict:
        """Accumulate the next ``fractionation`` frames into a view."""
        # top up per-part buffers
        for index in range(self._num_parts):
            while len(self._buffers[index]) < self._fractionation:
                frame = self._get_next_frame_safely(index)
                if frame is None:
                    break
                self._buffers[index].append(frame)

        # collect frames for [frame_start, frame_start + fractionation)
        window = {}
        for fid in range(self._frame_start, self._frame_start + self._fractionation):
            for index in range(self._num_parts):
                buf = self._buffers[index]
                if buf and fid in buf[0]:
                    window.update(buf.pop(0))

        if len(window) < self._fractionation:
            print(f"Warning: read fewer frames ({len(window)}) than requested "
                  f"({self._fractionation}).")

        self._view = np.zeros((self._ny, self._nx))
        for frame_id, frame in window.items():
            if frame is not None:
                self._view += np.asarray(frame["data"].todense())

        ret = {"start": self._frame_start, "n_frames": len(window), "view": self._view}
        if window:
            self._frame_start = int(max(window.keys())) + 1
        # on an empty window keep frame_start unchanged: data may simply not
        # have been written yet (advancing would skip frames forever)
        return ret

    def close(self) -> None:
        for reader in self._readers.values():
            reader.close()


class ReCoDeViewerMT:
    """Concurrent live viewer: one reader thread per part file.

    The analogue of the reference's multi-process notebook viewer
    (examples/ReCoDe_Live_View_MT.ipynb: one reader Process per part with
    Manager dicts); here threads share an in-process frame table — file IO
    and decompression release the GIL, so parts are tailed concurrently
    while acquisition is still writing them.
    """

    def __init__(self, folder_path: str, base_filename: str, num_parts: int,
                 fractionation: int, poll_interval: float = 0.01, device="cuda"):
        import threading

        self._num_parts = num_parts
        self._fractionation = fractionation
        self._poll_interval = poll_interval
        self._frames: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._readers: List[ReCoDeReader] = []
        self._threads: List[threading.Thread] = []
        for index in range(num_parts):
            name = os.path.join(folder_path, f"{base_filename}_part{index:03d}")
            reader = ReCoDeReader(name, is_intermediate=True, device=device)
            reader.open()
            self._readers.append(reader)
        shape = self._readers[0].get_shape()
        self._ny, self._nx = shape[1], shape[2]
        self._frame_start = 0
        for index in range(num_parts):
            t = threading.Thread(target=self._reader_loop, args=(index,),
                                 name=f"recode-view-{index}", daemon=True)
            t.start()
            self._threads.append(t)

    def _reader_loop(self, index: int) -> None:
        import time as _time

        reader = self._readers[index]
        while not self._stop.is_set():
            position = reader.get_file_position()
            try:
                frame = reader.get_next_frame()
            except Exception:
                frame = None
            if frame is None:
                reader._fp.seek(position)
                _time.sleep(self._poll_interval)
                continue
            with self._lock:
                self._frames.update(frame)

    def get_next_view(self, timeout: float = 1.0) -> dict:
        """Accumulate the next ``fractionation`` frames into a view, waiting
        up to ``timeout`` seconds for the reader threads to deliver them."""
        import time as _time

        wanted = range(self._frame_start, self._frame_start + self._fractionation)
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                if all(fid in self._frames for fid in wanted):
                    break
            _time.sleep(self._poll_interval)

        view = np.zeros((self._ny, self._nx))
        got = 0
        last = self._frame_start - 1
        with self._lock:
            for fid in wanted:
                frame = self._frames.pop(fid, None)
                if frame is not None:
                    view += np.asarray(frame["data"].todense())
                    got += 1
                    last = fid
        ret = {"start": self._frame_start, "n_frames": got, "view": view}
        if got:
            self._frame_start = last + 1
        return ret

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for reader in self._readers:
            reader.close()
