"""ReCoDeWriter on PyTorch: the JAX writer with its device encode replaced.

Subclass of :class:`pyrecode_tpu.writer.ReCoDeWriter`: the constructor
(header, threshold = dark + epsilon, saturated), part-file lifecycle, the
1-batch lookahead of ``_run_impl``, host entropy coding and record assembly
are inherited.  Overridden are the hooks that import JAX:

* ``_dispatch_encode`` moves the batch to the device, counts the foreground
  (one host sync, as in the JAX writer), picks the value buffer with
  ``_bucket_for`` and launches the fused encode and the value pack without
  waiting for them;
* ``_materialize_streams`` copies the streams back to the host.

Every frame size goes through the plain encode kernel, including the
``ny <= 128`` frames the JAX writer stacks into one superframe: stacking
spreads a TPU grid step's fixed cost and has no counterpart here.  The
buffer holds the batch's largest count, so an overflow means a fault and
raises; it is never re-encoded on the host.  ``use_tpu=False`` keeps the
JAX writer's host oracle path, a user's choice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyrecode_tpu.writer import ReCoDeWriter as _JaxReCoDeWriter
from pyrecode_tpu.writer import _bucket_for

from .device import resolve_device
from .ops.encode import count_foreground, encode_frames_auto


class ReCoDeWriter(_JaxReCoDeWriter):
    """Encode a frame stream into a ReCoDe intermediate part file."""

    def __init__(self, image_filename, *args, device="cuda", device_entropy=False,
                 buffer_size_in_frames=4, **kwargs):
        """Parameters as :class:`pyrecode_tpu.writer.ReCoDeWriter`, plus
        ``device`` ("cuda" or "cpu"; "cuda" without CUDA raises).

        ``buffer_size_in_frames`` is the frames per device batch; four
        4096x4096 frames make 134 MB.  ``device_entropy`` is not ported yet
        (ROADMAP Queue 1 item 5).
        """
        if device_entropy:
            raise NotImplementedError(
                "device entropy coding is not ported yet (ROADMAP Queue 1 item 5)")
        self._device = resolve_device(device)
        super().__init__(image_filename, *args, device_entropy=False,
                         buffer_size_in_frames=buffer_size_in_frames, **kwargs)
        self._threshold_dev = None
        if self._init_params.use_tpu:
            if self._reduction_level not in (1, 3):
                raise NotImplementedError(
                    "L2/L4 encode is not ported yet (ROADMAP Queue 1 item 8)")
            if self._src_dtype not in (np.uint8, np.uint16):
                raise NotImplementedError(
                    f"the encode kernel takes 8- and 16-bit unsigned sources, not {self._src_dtype}")
            self._threshold_dev = self._to_device(self._threshold)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint16))
        return host.to(self._device)

    def run(self, data=None, profile_dir: Optional[str] = None) -> dict:
        """Encode this node's slice of the current chunk; returns run metrics.

        ``profile_dir`` is not supported yet: the port's profiler hooks come
        with ROADMAP Queue 1 item 9.
        """
        if profile_dir:
            raise NotImplementedError(
                "profile_dir is not ported yet (ROADMAP Queue 1 item 9)")
        return self._run_impl(data)

    def _dispatch_encode(self, batch: np.ndarray):
        if not self._init_params.use_tpu:
            return ("host", self._encode_batch_oracle(batch))
        frames = self._to_device(batch)
        counts = count_foreground(frames, self._threshold_dev)
        max_count = int(counts.max()) if counts.numel() else 0
        bucket = _bucket_for(max_count, int(self._header["ny"]) * int(self._header["nx"]))
        res = encode_frames_auto(frames, self._threshold_dev, self._reduction_level,
                                 self._bit_depth, max_values=bucket)
        return ("torch", res)

    def _materialize_streams(self, batch: np.ndarray, dispatched):
        kind, res = dispatched
        if kind == "host":
            return ("raw", res)
        if bool(res.overflow.any()):
            raise RuntimeError(
                "encode overflow although the value buffer holds the batch's "
                f"largest foreground count (counts {res.counts.tolist()})")
        bitmaps = res.bitmap.cpu().numpy()
        if res.packed is None:
            return ("raw", [(bitmaps[i].tobytes(), None) for i in range(batch.shape[0])])
        plens = res.packed_len.cpu().numpy()
        packed = res.packed[:, :int(plens.max())].cpu().numpy()
        return ("raw", [(bitmaps[i].tobytes(), packed[i, :int(plens[i])].tobytes())
                        for i in range(batch.shape[0])])
