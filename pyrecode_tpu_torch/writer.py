"""ReCoDeWriter on PyTorch: the JAX writer with its device stages replaced.

Subclass of :class:`pyrecode_tpu.writer.ReCoDeWriter`: the constructor
(header, threshold = dark + epsilon, saturated), part-file lifecycle, the
1-batch lookahead of ``_run_impl``, host entropy coding and record assembly
(``_finish_batch``, ``_assemble_precompressed``) are inherited.  Overridden
are the hooks that import JAX:

* ``_dispatch_encode`` moves the batch to the device, counts the foreground
  (one host sync, as in the JAX writer), picks the value buffer with
  ``_bucket_for`` and launches the fused encode and the value pack without
  waiting for them;
* ``_materialize_streams`` deflates the streams on the device
  (``device_entropy``) and returns the zlib streams, or copies the raw
  streams back to the host for host entropy coding.

Every frame size goes through the plain encode kernel, including the
``ny <= 128`` frames the JAX writer stacks into one superframe: stacking
spreads a TPU grid step's fixed cost and has no counterpart here.  The
buffer holds the batch's largest count, so an overflow means a fault and
raises; it is never re-encoded on the host.  ``use_tpu=False`` keeps the
JAX writer's host oracle path, a user's choice.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional

import numpy as np
import torch

from pyrecode_tpu import native
from pyrecode_tpu.writer import ReCoDeWriter as _JaxReCoDeWriter
from pyrecode_tpu.writer import _bucket_for

from .codecs.dyndeflate import deflate_batch_device
from .device import resolve_device
from .ops.encode import count_foreground, encode_frames_auto


class ReCoDeWriter(_JaxReCoDeWriter):
    """Encode a frame stream into a ReCoDe intermediate part file."""

    def __init__(self, image_filename, *args, device="cuda", device_entropy=None,
                 buffer_size_in_frames=4, **kwargs):
        """Parameters as :class:`pyrecode_tpu.writer.ReCoDeWriter`, plus
        ``device`` ("cuda" or "cpu"; "cuda" without CUDA raises).

        ``buffer_size_in_frames`` is the frames per device batch; four
        4096x4096 frames make 134 MB.  ``device_entropy`` deflates the
        streams on the device (scheme 0, mode 1): None, the default, turns
        it on when the device is CUDA, ``use_tpu`` is set, the scheme is 0,
        the mode 1 and the native host library is available, as the JAX
        writer does on a TPU; True forces it (on the CPU it runs the
        kernels' twins); False turns it off.  The part files are the same
        bytes either way.
        """
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
        self._device_entropy = self._resolve_device_entropy(device_entropy)

    def _resolve_device_entropy(self, device_entropy) -> bool:
        if device_entropy is None:
            return (self._device.type == "cuda" and bool(self._init_params.use_tpu)
                    and self._scheme == 0 and self._rc_operation_mode == 1
                    and native.available())
        if not device_entropy:
            return False
        if self._scheme == 12:
            raise NotImplementedError(
                "scheme-12 device entropy coding is not ported yet (ROADMAP Queue 1 item 7)")
        if self._scheme != 0 or self._rc_operation_mode != 1:
            raise ValueError("device_entropy needs compression_scheme 0 and rc_operation_mode 1")
        return True

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
        """("raw", [(bitmap bytes, pixvals bytes or None), ...]) for host
        entropy coding, or ("compressed", ([(cbm, cpx or None, pixvals
        length), ...], bitmap time, pixvals time)) from the device."""
        kind, res = dispatched
        if kind == "host":
            return ("raw", res)
        if bool(res.overflow.any()):
            raise RuntimeError(
                "encode overflow although the value buffer holds the batch's "
                f"largest foreground count (counts {res.counts.tolist()})")
        if self._device_entropy:
            return ("compressed", self._deflate_on_device(res))
        bitmaps = res.bitmap.cpu().numpy()
        if res.packed is None:
            return ("raw", [(bitmaps[i].tobytes(), None) for i in range(batch.shape[0])])
        plens = res.packed_len.cpu().numpy()
        packed = res.packed[:, :int(plens.max())].cpu().numpy()
        return ("raw", [(bitmaps[i].tobytes(), packed[i, :int(plens[i])].tobytes())
                        for i in range(batch.shape[0])])

    def _deflate_on_device(self, res):
        """Deflate the batch's bitmap and packed-value streams where they
        lie; only the zlib streams come back to the host (a raw stream only
        for the stored-block fallback)."""
        B, n_bm = res.bitmap.shape
        stt = datetime.now()
        cbm = deflate_batch_device(res.bitmap, np.full(B, n_bm, np.int32),
                                   hint_state=self._entropy_hints["bm"])
        t_bm = datetime.now() - stt
        if res.packed is None:
            return [(c, None, 0) for c in cbm], t_bm, timedelta(0)
        plens = res.packed_len.cpu().numpy()
        stt = datetime.now()
        cpx = deflate_batch_device(res.packed, plens, hint_state=self._entropy_hints["px"])
        t_px = datetime.now() - stt
        return [(cbm[i], cpx[i], int(plens[i])) for i in range(B)], t_bm, t_px
