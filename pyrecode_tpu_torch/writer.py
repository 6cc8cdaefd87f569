"""ReCoDeWriter on PyTorch: the encoder engine with its device stages on the card.

The port's counterpart of pyrecode_tpu/writer.py, a class of its own with
the same constructor surface, ``start()`` / ``run()`` / ``close()``
lifecycle, part-file naming ``<base>.rc<L>_part<NNN>``, per-node frame
slicing, validation frames, run metrics and record layout, so that the part
files are the JAX writer's bytes.  Its device stages:

* ``_dispatch_encode`` moves the batch to the device (on the card through
  a pinned staging buffer, ``_batch_to_device``), counts the foreground
  (one host sync, as in the JAX writer), picks the value buffer with
  ``_bucket_for`` and launches the fused encode (L1/L3: with the values'
  pixel positions when scheme 12 codes on the device; L2/L4: the label
  kernel) and the value pack without waiting for them.  Unsigned sources
  widen to uint16, and int8/int16 L1/L3 frames have their sign bit flipped
  (:func:`.ops.encode.signed_to_kernel_frames`), as the JAX writer widens
  them for its Pallas kernel; int8/int16 L2/L4 frames, whose statistics are
  of the signed values, take the plain :func:`.ops.encode.encode_frames` in
  their own dtype, as the JAX writer sends every L2/L4 batch to XLA;
* ``_finish_batch`` is one step on every route: entropy, then records.
  ``_materialize_streams`` (span ``writer.entropy``) returns each frame's
  final payloads: coded on the device (``device_entropy``; scheme 0 by
  :func:`.codecs.dyndeflate.deflate_batch_device`, scheme 12 by the rANS
  coders, whose stream modes :mod:`.codecs.rans` chooses), coded on the
  host (the raw streams copied back; more than one frame on the
  compression pool, one frame by the writer's codec), or raw in mode 0.
  Then :func:`.structures.frame_record` builds every frame's record (span
  ``writer.records``) from the container's schema.

Spans (:func:`.profiling.annotate`, with the session and node ids): in the
constructor ``writer.threshold`` (child ``writer.threshold_device`` where
the threshold is built on the device, ``_device_threshold``); per
batch ``writer.dispatch`` (children ``writer.h2d``, with ``writer.h2d_pinned``
on the staged route, ``writer.count``, ``writer.encode``; it times
``frame_thresholding_and_counting_time``) and
``writer.finish`` (children ``writer.entropy``, ``writer.records``; it times
``frame_time``), and ``writer.flush`` for each write of the part file.  At
scheme 12 on the device ``writer.entropy`` holds the batch encoders'
``rans.*`` spans (``codecs/rans.py``).

Every frame size goes through the plain encode kernel, including the
``ny <= 128`` frames the JAX writer stacks into one superframe: stacking
spreads a TPU grid step's fixed cost and has no counterpart here.  The
buffer holds the batch's largest count, so an overflow means a fault and
raises; it is never re-encoded on the host.  ``use_tpu=False`` keeps the
JAX writer's host oracle path, a user's choice.

The pinned staging buffer costs one batch of page-locked host memory a
writer on the card, held from its first batch to ``close()``: 134 MB at
four 4096x4096 frames, 403 MB for a server's three nodes.  It comes from
:func:`.device.pinned_empty`, and ``close()`` hands it back to PyTorch's
caching host allocator, which nothing in the port empties: the block stays
pinned for the next writer's buffer or a reader's output.
"""

from __future__ import annotations

import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import codecs, native, oracle
from .codecs import rans
from .codecs.dyndeflate import deflate_batch_device
from .constants import rc_cfg as rc
from .device import pinned_empty, resolve_device
from .fileutils import read_file
from .header import ReCoDeHeader
from .ops.encode import (count_foreground, encode_frames, encode_frames_auto,
                         signed_to_kernel_frames)
from .params import InitParams, InputParams
from .profiling import annotate, trace
from .structures import frame_record

_L2_STATISTIC_NAMES = {0: "max", 1: "max", 2: "sum"}
_L4_SCHEME_NAMES = {0: "weighted_average", 1: "weighted_average", 2: "max", 3: "unweighted"}

_MIN_BUCKET = 1 << 10


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _bucket_for(count: int, limit: int) -> int:
    """Smallest power-of-two >= count (and >= _MIN_BUCKET), capped at limit."""
    b = _MIN_BUCKET
    while b < count:
        b <<= 1
    return min(b, limit)


class ReCoDeWriter:
    """Encode a frame stream into a ReCoDe intermediate part file."""

    def __init__(self, image_filename, dark_data=None, dark_filename="", output_directory="",
                 input_params=None, params_filename="", mode="batch", validation_frame_gap=-1,
                 log_filename="recode.log", run_name="run", verbosity=0, use_tpu=True,
                 max_count=-1, chunk_time_in_sec=0, node_id=0, buffer_size_in_frames=4,
                 use_c=None, fast_deflate=True, device_entropy=None, device="cuda",
                 session_id=""):
        """Parameters as the reference writer's (recode_writer.py:26-66) and
        the JAX writer's, plus ``device`` ("cuda" or "cpu"; "cuda" without
        CUDA raises) and ``session_id``, the server session this writer
        serves, which its spans name beside ``node_id``.

        ``node_id`` selects this writer's contiguous frame slice and names
        its part file.  ``buffer_size_in_frames`` is the frames per device
        batch; four 4096x4096 frames make 134 MB.  ``use_tpu`` (the JAX
        name) selects the device path; False takes the host oracle.
        ``fast_deflate`` (scheme 0) codes with the native sparse deflate.

        ``device_entropy`` entropy-codes on the device (mode 1): scheme 0 by
        the deflate kernels, scheme 12 by the rANS kernels (at L1 the bitmap
        in gap mode from the encode's positions, 8..12-bit values as
        symbols and values of other widths in gap mode, as the JAX writer's
        XLA path codes them; at L2-L4 the streams in gap mode from the
        bitmap -> positions kernel).  None, the default, turns it on where it applies
        when the device is CUDA and ``use_tpu`` is set, as the JAX writer does
        on a TPU; True forces it (on the CPU it runs the kernels' twins) and
        raises where it is not ported; False turns it off.  Scheme 0 on the
        device raises when the native host library cannot be built, rather
        than coding on the host.  Scheme 0 writes the same bytes either way;
        scheme 12 with device entropy writes the JAX device coder's bytes
        (fixed lane counts), a different valid stream from the host coder's.
        """
        self._device = resolve_device(device)
        self._init_params = InitParams(
            mode, output_directory, image_filename=image_filename,
            calibration_filename=dark_filename, params_filename=params_filename,
            validation_frame_gap=validation_frame_gap, log_filename=log_filename,
            run_name=run_name, verbosity=verbosity, use_tpu=use_tpu, use_c=use_c,
            max_count=max_count, chunk_time_in_sec=chunk_time_in_sec)

        if input_params is None:
            self._input_params = InputParams()
            self._input_params.load(Path(self._init_params.params_filename))
        elif isinstance(input_params, dict):
            self._input_params = InputParams(input_params)
        else:
            self._input_params = input_params
        if not self._input_params.validate():
            raise ValueError("Invalid input params")

        self._rc_header = ReCoDeHeader()
        self._rc_header.create(self._init_params, self._input_params, is_intermediate=True)
        if self._input_params.source_file_type in (rc.FILE_TYPE_MRC, rc.FILE_TYPE_SEQ):
            self._rc_header.set("source_header_length", 1024)
        else:
            self._rc_header.set("source_header_length", 0)
        if self._init_params.verbosity > 0:
            self._rc_header.print()
        if not self._rc_header.validate():
            raise ValueError("Invalid ReCoDe header created")
        self._header = self._rc_header.as_dict()

        self._src_dtype = self._input_params.source_numpy_dtype
        if self._src_dtype == np.uint64:   # the JAX writer's saturation overflows here too
            raise OverflowError(
                "uint64 sources: the threshold's saturation at the dtype's max overflows int64, "
                "as in the JAX writer (ROADMAP Queue 3)")
        calibration = self._load_calibration(dark_data)
        if self._header["ny"] != calibration.shape[0] or self._header["nx"] != calibration.shape[1]:
            raise RuntimeError("Data and Calibration frames have different shapes")
        if calibration.dtype != self._src_dtype:
            calibration = calibration.astype(self._src_dtype)
        self._calibration_frame = calibration
        self._host_threshold = None   # the ``_threshold`` property's, at its first use

        self._node_id = node_id
        self._span_args = ({"session": session_id, "node": node_id} if session_id
                           else {"node": node_id})
        self._reduction_level = int(self._header["reduction_level"])
        self._rc_operation_mode = int(self._header["rc_operation_mode"])
        self._bit_depth = int(self._input_params.source_bit_depth)
        self._l2_statistic = _L2_STATISTIC_NAMES[int(self._header["L2_statistics"])]
        self._l4_scheme = _L4_SCHEME_NAMES[int(self._header["L4_centroiding"])]
        self._batch_size = max(1, int(buffer_size_in_frames))

        self._scheme = int(self._header["compression_scheme"])
        level = int(self._header["compression_level"])
        self._codec = (codecs.get_codec(self._scheme, level)
                       if self._rc_operation_mode == 1 else None)
        if fast_deflate and self._scheme == 0 and self._codec is not None and native.available():
            self._codec = codecs.Codec(0, "zlib-sparse-native", native.deflate_sparse,
                                       self._codec.decompress)

        self._threshold_dev = None
        self._signed_source = self._src_dtype in (np.int8, np.int16)
        # the host dtype of the frames the device encode takes
        self._frames_dtype = self._src_dtype if self._signed_source else np.uint16
        # the pinned staging buffer of a writer on the card: None until the
        # first batch, False where pinning failed (``_batch_to_device``)
        self._staging = None
        if self._init_params.use_tpu:
            if self._src_dtype not in (np.uint8, np.uint16, np.int8, np.int16):
                raise NotImplementedError(
                    f"the device writer takes 8- and 16-bit integer sources, not "
                    f"{np.dtype(self._src_dtype).name}: the JAX writer's device path writes other "
                    "bytes than its host oracle for them (ROADMAP Queue 3); pass use_tpu=False")
            # L2 statistics saturate at the source dtype's max, then at the
            # bit depth (oracle.reduce_frame)
            self._stat_limit = min(int(np.iinfo(self._src_dtype).max), (1 << self._bit_depth) - 1)
        # a host writer's threshold is computed at its first batch (``_threshold``)
        with annotate("writer.threshold", self._span_args):
            if self._init_params.use_tpu:
                with annotate("writer.threshold_device", self._span_args):
                    self._threshold_dev = self._device_threshold(calibration)
        self._device_entropy = self._resolve_device_entropy(device_entropy)
        # observed token densities per stream kind: lets deflate_batch_device
        # run the fused tokenize+compact kernel from the second batch on
        self._entropy_hints = {"bm": {}, "px": {}}

        self._codec_local = threading.local()
        self._compression_pool = (
            ThreadPoolExecutor(max_workers=max(2, (os.cpu_count() or 4) // 2),
                               thread_name_prefix=f"rc-compress-{node_id}")
            if self._rc_operation_mode == 1 else None)

        self._intermediate_file = None
        self._intermediate_file_name = None
        self._validation_file = None
        self._validation_file_name = None
        self._is_first_chunk = True
        self._chunk_offset = 0
        self._num_frames_in_part = 0
        self._out_buffer: list = []
        self._out_buffer_bytes = 0
        self._out_buffer_limit = None
        self._source_shape = None

        # validation-frame counting ROI (central <=128x128 window,
        # recode_writer.py:236-240)
        nx, ny = int(self._header["nx"]), int(self._header["ny"])
        roi_nx, roi_ny = min(nx, 128), min(ny, 128)
        self._vc_roi = {"x_start": (nx - roi_nx) // 2, "y_start": (ny - roi_ny) // 2,
                        "nx": roi_nx, "ny": roi_ny}
        self._vc_n_pixels = roi_nx * roi_ny
        self._vc_dose_rate = 0.0

    # ------------------------------------------------------------------ setup

    def _device_entropy_error(self) -> Optional[Exception]:
        """The error device entropy raises for this configuration, or None."""
        if self._rc_operation_mode != 1 or self._scheme not in (0, 12):
            return ValueError(
                "device_entropy needs rc_operation_mode 1 and compression_scheme 0 or 12")
        return None

    def _resolve_device_entropy(self, device_entropy) -> bool:
        error = self._device_entropy_error()
        if device_entropy is None:
            device_entropy = (self._device.type == "cuda" and bool(self._init_params.use_tpu)
                              and error is None)
        elif device_entropy and error is not None:
            raise error
        # scheme 0 builds its Huffman tables with the host library; scheme 12
        # does not need it
        if device_entropy and self._scheme == 0 and not native.available():
            raise RuntimeError(
                "scheme-0 device entropy needs the native host library, which could not "
                "be built from native/recode_host.cpp with g++; pass device_entropy=False "
                "to entropy-code on the host")
        return bool(device_entropy)

    @property
    def _threshold(self) -> np.ndarray:
        """The threshold on the host: dark + epsilon, saturated at the
        dtype's max rather than wrapped (the reference wraps,
        recode_writer.py:137), in the source dtype.  Only the validation
        frames' count and the host oracle's encode read it, so it is
        computed at its first use: a device writer that writes no
        validation frames makes none of its int64 passes."""
        if self._host_threshold is None:
            thr = (self._calibration_frame.astype(np.int64)
                   + self._input_params.calibration_threshold_epsilon)
            if np.issubdtype(self._src_dtype, np.integer):
                thr = np.minimum(thr, np.iinfo(self._src_dtype).max)
            self._host_threshold = thr.astype(self._src_dtype)
        return self._host_threshold

    def _device_threshold(self, calibration: np.ndarray) -> torch.Tensor:
        """The span ``writer.threshold_device``: the threshold as the encode
        takes it, ``_to_device(self._threshold)`` byte for byte, built on
        the device from one pageable copy of the calibration in the frames'
        dtype: widened to int32, plus epsilon, saturated at the source
        dtype's max, cast to the source dtype (which wraps a sum below its
        min, as the host formula's cast does) and to the frames' dtype."""
        eps = self._input_params.calibration_threshold_epsilon
        # int32 holds every sum: past +-2^16 an 8- or 16-bit threshold
        # saturates above, and below keeps only its residue mod 2^16
        if eps > 1 << 16:
            eps = 1 << 16
        elif eps < -(1 << 16):
            eps = eps % (1 << 16) - (1 << 16)
        dark = torch.from_numpy(np.ascontiguousarray(calibration, dtype=self._frames_dtype))
        dark = dark.to(self._device)
        thr = dark.to(torch.int32).add_(eps).clamp_(max=int(np.iinfo(self._src_dtype).max))
        return self._kernel_frames(thr.to(_torch_dtype(self._src_dtype)).to(dark.dtype))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Frames on the device as the encode takes them: uint16 for the
        kernels, the source dtype for the plain L2/L4 encode; a pageable
        copy."""
        dev = torch.from_numpy(np.ascontiguousarray(arr, dtype=self._frames_dtype))
        return self._kernel_frames(dev.to(self._device))

    def _kernel_frames(self, dev: torch.Tensor) -> torch.Tensor:
        """Signed L1/L3 frames with their sign bit flipped for the kernels."""
        if self._signed_source and self._reduction_level not in (2, 4):
            return signed_to_kernel_frames(dev)
        return dev

    def _batch_to_device(self, batch: np.ndarray) -> torch.Tensor:
        """The span ``writer.h2d``: a batch on the device as ``_to_device``
        puts it there.

        On the card the batch is copied into this writer's staging buffer,
        a tensor of pinned host memory of the batch's shape from PyTorch's
        caching host allocator, taken at the first batch and reused for
        every later one, and from there to the card without waiting (span
        ``writer.h2d_pinned`` around the two copies, not the allocation).
        The host copy releases the interpreter lock, so the nodes' copies
        run side by side.  If pinning fails, every batch of this writer
        takes the pageable copy."""
        with annotate("writer.h2d", self._span_args):
            if self._device.type == "cuda" and self._staging is None:
                staging = pinned_empty(batch.shape, _torch_dtype(self._frames_dtype))
                # no pinned memory to be had: the pageable copy
                self._staging = False if staging is None else staging
            if not isinstance(self._staging, torch.Tensor):
                return self._to_device(batch)
            with annotate("writer.h2d_pinned", self._span_args):
                np.copyto(self._staging.numpy(), batch)
                # the buffer is written again at the next batch's dispatch, after
                # this batch's int(counts.max()) has waited for the stream, and so
                # for this copy, which goes before the count on the same stream
                frames = self._staging.to(self._device, non_blocking=True)
            return self._kernel_frames(frames)

    def _load_calibration(self, dark_data) -> np.ndarray:
        if dark_data is not None:
            arr = np.asarray(dark_data)
        else:
            ftype = self._input_params.calibration_file_type
            fname = self._init_params.calibration_filename
            if ftype == rc.FILE_TYPE_BINARY:
                arr = read_file(fname, self._header["ny"], self._header["nx"], self._src_dtype)
            elif ftype in (rc.FILE_TYPE_MRC, rc.FILE_TYPE_SEQ):
                from .em_reader import emfile

                with emfile(fname, ftype) as reader:
                    arr = np.asarray(reader[0])
            else:
                raise NotImplementedError(
                    "No implementation available for loading calibration file of type 'Other'")
        if arr.ndim > 2:
            arr = np.squeeze(arr[0])
        return arr

    @property
    def part_file_name(self) -> Optional[str]:
        return self._intermediate_file_name

    def start(self, resume: bool = False, chunk_offset: int = 0) -> None:
        """Create the part file, serialize the header, set up buffers.

        With ``resume=True`` (stream-mode node replacement) an existing part
        file is appended to: its complete records restore the frame count, a
        torn trailing record is dropped, and ``chunk_offset`` restores the
        global frame counter so new frame ids continue where the dead writer
        left off.
        """
        if self._init_params.mode == "batch":
            base_filename = Path(self._init_params.image_filename).stem
        else:
            base_filename = self._init_params.run_name

        self._intermediate_file_name = os.path.join(
            self._init_params.output_directory,
            f"{base_filename}.rc{self._reduction_level}_part{self._node_id:03d}")
        resumed = resume and self._resume_part_file(
            max_frame_id_exclusive=int(chunk_offset) if chunk_offset else None)
        if not resumed:
            self._intermediate_file = open(self._intermediate_file_name, "wb")
            self._rc_header.serialize_to(self._intermediate_file)
            self._intermediate_file.flush()
            self._num_frames_in_part = 0

        if self._init_params.validation_frame_gap > 0:
            self._validation_file_name = os.path.join(
                self._init_params.output_directory,
                f"{base_filename}_part{self._node_id:03d}_validation_frames.bin")
            self._validation_file = open(self._validation_file_name, "ab" if resumed else "wb")

        frame_bytes = (int(self._header["ny"]) * int(self._header["nx"])
                       * np.dtype(self._src_dtype).itemsize)
        self._out_buffer_limit = max(frame_bytes * self._batch_size, 1 << 20)
        self._chunk_offset = int(chunk_offset) if resumed else 0

    def _resume_part_file(self, max_frame_id_exclusive=None) -> bool:
        """Reopen an existing part file for append; restore the frame count.

        Returns False (the caller starts a fresh file) when the file is
        missing or its headers are unreadable.  Records whose frame id is at
        or above ``max_frame_id_exclusive`` (the head node's completed-chunk
        frame counter) belong to the chunk in flight and are dropped: the
        replacement re-encodes that whole chunk.
        """
        path = self._intermediate_file_name
        if not os.path.exists(path):
            return False
        try:
            from .reader import ReCoDeReader

            scan = ReCoDeReader(path, is_intermediate=True, device="cpu")
            scan.open()
            end_pos = scan._frame_data_start_position
            if os.path.getsize(path) < end_pos:
                scan.close()
                return False
            n = 0
            while True:
                rec = scan.get_next_frame_raw(read_data=False)
                if rec is None:
                    break
                if max_frame_id_exclusive is not None and \
                        min(rec.keys()) >= max_frame_id_exclusive:
                    break
                n += 1
                end_pos = scan.get_file_position()
            scan.close()
        except Exception:
            return False
        self._intermediate_file = open(path, "r+b")
        self._intermediate_file.truncate(end_pos)
        self._intermediate_file.seek(end_pos)
        self._num_frames_in_part = n
        self._is_first_chunk = False  # source header is already on disk
        return True

    # -------------------------------------------------------------------- run

    def _do_sanity_checks(self, data=None) -> None:
        """Resolve the source shape and serialize the source header once."""
        if data is None:
            ftype = self._input_params.source_file_type
            if ftype in (rc.FILE_TYPE_MRC, rc.FILE_TYPE_SEQ):
                from .em_reader import emfile

                src = emfile(self._init_params.image_filename, ftype)
                self._source_shape = src.shape
                if self._is_first_chunk:
                    src.serialize_header(self._intermediate_file)
                    self._intermediate_file.flush()
                src.close()
            elif ftype == rc.FILE_TYPE_BINARY:
                self._source_shape = (self._header["nz"], self._header["ny"], self._header["nx"])
            else:
                raise NotImplementedError(
                    "No implementation available for loading source file of type 'Other'")
        else:
            self._source_shape = data.shape

        if self._source_shape[1] != self._header["ny"]:
            raise RuntimeError("Expected height does not match height in source file")
        if self._source_shape[2] != self._header["nx"]:
            raise RuntimeError("Expected width does not match width in source file")

        if self._input_params.num_frames == -1:
            self._header["nz"] = self._source_shape[0]
        elif self._input_params.num_frames > self._source_shape[0]:
            raise RuntimeError(
                "Number of frames requested in config file is larger than available in source file")
        else:
            self._header["nz"] = self._input_params.num_frames

    def run(self, data=None, profile_dir: Optional[str] = None) -> dict:
        """Encode this node's slice of the current chunk; returns run metrics.

        ``profile_dir`` captures a ``torch.profiler`` trace of the whole run
        (host and device; :func:`.profiling.trace`) as a Chrome trace file in
        that directory.
        """
        if profile_dir:
            with trace(profile_dir):
                return self._run_impl(data)
        return self._run_impl(data)

    def _run_impl(self, data=None) -> dict:
        run_metrics: dict = {}
        self._do_sanity_checks(data)
        self._is_first_chunk = False

        if self._init_params.mode == "batch":
            n_frames_in_chunk = int(self._header["nz"])
        else:
            n_frames_in_chunk = int(self._source_shape[0])

        num_threads = int(self._input_params.num_threads)
        n_frames_per_thread = int(math.ceil(n_frames_in_chunk / num_threads))
        frame_offset = self._node_id * n_frames_per_thread
        available_frames = min(n_frames_per_thread, max(n_frames_in_chunk - frame_offset, 0))

        stt = datetime.now()
        if data is None:
            data = self._read_source_slice(frame_offset, available_frames)
            available_frames = data.shape[0]
        else:
            data = data[frame_offset: frame_offset + available_frames]
        if data.dtype != self._src_dtype:
            data = data.astype(self._src_dtype)
        run_metrics["run_data_read_time"] = datetime.now() - stt

        run_start = datetime.now()
        zero = timedelta(0)
        for key in ("frame_thresholding_and_counting_time", "frame_binary_image_packing_time",
                    "frame_pixel_intensity_packing_time", "frame_binary_image_compression_time",
                    "frame_pixel_intensity_compression_time", "frame_time"):
            run_metrics[key] = zero

        # 1-batch lookahead: dispatch the device encode of batch k+1, then
        # finish batch k on the host while the device works
        pending = None
        for batch_start in range(0, available_frames, self._batch_size):
            batch = data[batch_start: batch_start + self._batch_size]
            n_in_batch = batch.shape[0]
            if n_in_batch < self._batch_size:
                # short final batch: padded to the fixed shape (the padding
                # frames' records are dropped), as the JAX writer does
                pad = np.zeros((self._batch_size - n_in_batch, *batch.shape[1:]),
                               dtype=batch.dtype)
                batch = np.concatenate([batch, pad], axis=0)
            first_abs_index = self._chunk_offset + frame_offset + batch_start
            with annotate("writer.dispatch", self._span_args, run_metrics,
                          "frame_thresholding_and_counting_time"):
                dispatched = self._dispatch_encode(batch)
            if pending is not None:
                self._finish_batch(*pending, run_metrics)
            pending = (batch, first_abs_index, dispatched, n_in_batch)
        if pending is not None:
            self._finish_batch(*pending, run_metrics)

        self._flush_out_buffer()

        # validation frames + dose-rate telemetry (recode_writer.py:402-415)
        if self._init_params.validation_frame_gap > 0:
            gap = self._init_params.validation_frame_gap
            for i in range(available_frames):
                abs_index = self._chunk_offset + frame_offset + i
                if abs_index % gap == 0:
                    self._validation_file.write(np.ascontiguousarray(data[i]).tobytes())
                    roi = self._vc_roi
                    ys = slice(roi["y_start"], roi["y_start"] + roi["ny"])
                    xs = slice(roi["x_start"], roi["x_start"] + roi["nx"])
                    _, num_features = oracle.label_components(
                        data[i][ys, xs] > self._threshold[ys, xs])
                    self._vc_dose_rate = num_features / self._vc_n_pixels
                    run_metrics.setdefault("run_dose_rates", []).append(self._vc_dose_rate)

        self._chunk_offset += n_frames_in_chunk
        self._num_frames_in_part += available_frames
        run_metrics["run_time"] = datetime.now() - run_start
        run_metrics["run_frames"] = available_frames
        return run_metrics

    def _read_source_slice(self, frame_offset: int, available_frames: int) -> np.ndarray:
        ftype = self._input_params.source_file_type
        if ftype == rc.FILE_TYPE_BINARY:
            ny, nx = int(self._header["ny"]), int(self._header["nx"])
            frame_bytes = ny * nx * np.dtype(self._src_dtype).itemsize
            offset = self._input_params.source_header_length + frame_offset * frame_bytes
            with open(self._init_params.image_filename, "rb") as f:
                f.seek(offset)
                raw = f.read(available_frames * frame_bytes)
            n = len(raw) // frame_bytes
            return np.frombuffer(raw[: n * frame_bytes], dtype=self._src_dtype).reshape(n, ny, nx)
        from .em_reader import emfile

        with emfile(self._init_params.image_filename, ftype) as f:
            try:
                return np.asarray(f[frame_offset: frame_offset + available_frames])
            except IndexError:
                frames = []
                for i in range(available_frames):
                    try:
                        frames.append(np.squeeze(f[frame_offset + i]))
                    except IndexError:
                        break
                return np.asarray(frames)

    # ------------------------------------------------------------ batch encode

    def _dispatch_encode(self, batch: np.ndarray):
        """Launch the device encode without waiting for it; returns what
        ``_materialize_streams`` takes."""
        if not self._init_params.use_tpu:
            return ("host", self._encode_batch_oracle(batch))
        frames = self._batch_to_device(batch)
        with annotate("writer.count", self._span_args):
            counts = count_foreground(frames, self._threshold_dev)
            max_count = int(counts.max()) if counts.numel() else 0
        bucket = _bucket_for(max_count, int(self._header["ny"]) * int(self._header["nx"]))
        # scheme-12 device entropy codes the bitmap by its set-bit positions:
        # the L1 encode kernel stores them beside the values (the foreground
        # count also bounds the L2/L4 puddle count)
        with_positions = (self._device_entropy and self._scheme == 12
                          and self._reduction_level == 1)
        with annotate("writer.encode", self._span_args):
            if self._signed_source and self._reduction_level in (2, 4):
                return ("torch", encode_frames(frames, self._threshold_dev,
                                               self._reduction_level, self._bit_depth,
                                               max_values=bucket,
                                               l2_statistic=self._l2_statistic,
                                               l4_scheme=self._l4_scheme,
                                               stat_limit=self._stat_limit))
            return ("torch", encode_frames_auto(frames, self._threshold_dev,
                                                self._reduction_level, self._bit_depth,
                                                max_values=bucket,
                                                with_positions=with_positions,
                                                l2_statistic=self._l2_statistic,
                                                l4_scheme=self._l4_scheme,
                                                stat_limit=self._stat_limit))

    def _materialize_streams(self, dispatched, n_in_batch: int):
        """The span ``writer.entropy``: the batch's first ``n_in_batch``
        frames' payloads, ``[(first, second or None, packed length), ...]``
        as :func:`.structures.frame_record` takes them, and the bitmaps' and
        the values' compression times.  It waits for the batch's encode.

        Mode 1 codes on the device (``device_entropy``), or copies the raw
        streams back and codes them on the host (:meth:`_code_on_host`);
        mode 0 passes the raw streams on."""
        kind, res = dispatched
        if kind == "host":
            streams = res[:n_in_batch]
        else:
            if bool(res.overflow.any()):
                raise RuntimeError(
                    "encode overflow although the value buffer holds the batch's "
                    f"largest foreground count (counts {res.counts.tolist()})")
            if self._device_entropy:
                payloads, t_bm, t_px = self._code_on_device(res)
                return payloads[:n_in_batch], t_bm, t_px
            bitmaps = res.bitmap[:n_in_batch].cpu().numpy()
            if res.packed is None:
                streams = [(bitmap.tobytes(), None) for bitmap in bitmaps]
            else:
                plens = res.packed_len[:n_in_batch].cpu().numpy()
                packed = res.packed[:n_in_batch, :int(plens.max())].cpu().numpy()
                streams = [(bitmaps[i].tobytes(), packed[i, :int(plens[i])].tobytes())
                           for i in range(n_in_batch)]
        if self._rc_operation_mode == 0:
            return [(bitmap, pixvals, 0) for bitmap, pixvals in streams], timedelta(0), timedelta(0)
        return self._code_on_host(streams)

    def _code_on_device(self, res):
        """Entropy-code the batch's bitmap and packed-value streams where
        they lie, scheme 0 by the deflate kernels and scheme 12 by the rANS
        coders; only the coded streams come back to the host (a raw stream
        only for a host-coded or stored fallback)."""
        B, n_bm = res.bitmap.shape
        plens = None if res.packed is None else res.packed_len.cpu().numpy().astype(np.int64)
        level, bit_depth = self._reduction_level, self._bit_depth
        stt = datetime.now()
        if self._scheme == 12:
            cbm = rans.encode_bitmaps_device(res.bitmap, level, bit_depth, plens, res.positions,
                                             res.counts)
        else:
            cbm = deflate_batch_device(res.bitmap, np.full(B, n_bm, np.int32),
                                       hint_state=self._entropy_hints["bm"])
        t_bm = datetime.now() - stt
        if res.packed is None:
            return [(c, None, 0) for c in cbm], t_bm, timedelta(0)
        stt = datetime.now()
        if self._scheme == 12:
            cpx = rans.encode_values_device(res.packed, plens, level, bit_depth)
        else:
            cpx = deflate_batch_device(res.packed, plens, hint_state=self._entropy_hints["px"])
        return list(zip(cbm, cpx, plens.tolist())), t_bm, datetime.now() - stt

    def _code_on_host(self, streams):
        """Mode-1 host entropy coding of ``[(bitmap, pixvals or None), ...]``,
        as the JAX writer's host path codes them.  More than one frame: on
        the pool, a frame a task, in order (the codecs release the GIL), at
        scheme 12 by :func:`.codecs.rans.host_coders`, else by a codec of the
        task's thread.  One frame: by this writer's codec.  The compression
        times are summed over the frames."""
        if len(streams) == 1:
            coders = (self._codec.compress, self._codec.compress)
            coded = [self._code_frame(coders, streams[0])]
        else:
            coded = list(self._compression_pool.map(
                lambda frame: self._code_frame(self._pool_coders(), frame), streams))
        payloads, t_bm, t_px = zip(*coded)
        return list(payloads), sum(t_bm, timedelta(0)), sum(t_px, timedelta(0))

    @staticmethod
    def _code_frame(coders, frame):
        """((coded bitmap, coded pixvals or None, pixvals length), bitmap
        time, pixvals time) of one frame."""
        (code_bitmap, code_values), (bitmap, pixvals) = coders, frame
        t0 = datetime.now()
        cbm = code_bitmap(bitmap)
        t1 = datetime.now()
        cpx = None if pixvals is None else code_values(pixvals)
        return (cbm, cpx, 0 if pixvals is None else len(pixvals)), t1 - t0, datetime.now() - t1

    def _pool_coders(self):
        """(bitmap coder, values coder) of a pool task: scheme 12's host
        coders, else a codec of the task's thread (zstd compressor contexts
        are not shareable; the native sparse deflate is stateless)."""
        if self._scheme == 12:
            return rans.host_coders(self._reduction_level, self._bit_depth)
        codec = (self._codec if self._codec.name == "zlib-sparse-native"
                 else getattr(self._codec_local, "codec", None))
        if codec is None:
            codec = self._codec_local.codec = codecs.get_codec(
                self._scheme, int(self._header["compression_level"]))
        return codec.compress, codec.compress

    def _finish_batch(self, batch: np.ndarray, first_abs_index: int, dispatched,
                      n_in_batch: int, run_metrics: dict) -> None:
        """Entropy (span ``writer.entropy``), then the frame records (span
        ``writer.records``), then the output buffer."""
        with annotate("writer.finish", self._span_args, run_metrics, "frame_time"):
            with annotate("writer.entropy", self._span_args):
                payloads, t_bm, t_px = self._materialize_streams(dispatched, n_in_batch)
            run_metrics["frame_binary_image_compression_time"] += t_bm
            run_metrics["frame_pixel_intensity_compression_time"] += t_px
            with annotate("writer.records", self._span_args):
                records = [frame_record(self._reduction_level, self._rc_operation_mode,
                                        first_abs_index + i, *payload)
                           for i, payload in enumerate(payloads)]
            for record in records:
                self._out_buffer.append(record)
                self._out_buffer_bytes += len(record)
                if self._out_buffer_bytes >= self._out_buffer_limit:
                    self._flush_out_buffer()

    def _encode_batch_oracle(self, batch: np.ndarray):
        out = []
        for i in range(batch.shape[0]):
            enc = oracle.reduce_frame(
                batch[i], self._threshold, self._reduction_level, self._bit_depth,
                l2_statistic=self._l2_statistic, l4_scheme=self._l4_scheme)
            out.append((enc["packed_binary_map"], enc["packed_pixvals"]))
        return out

    def _flush_out_buffer(self) -> None:
        if self._out_buffer:
            with annotate("writer.flush", self._span_args):
                self._intermediate_file.write(b"".join(self._out_buffer))
                self._intermediate_file.flush()
                self._out_buffer.clear()
                self._out_buffer_bytes = 0

    # ------------------------------------------------------------------ close

    def close(self) -> None:
        """Flush, patch the true frame count into the header, close files."""
        self._flush_out_buffer()
        self._rc_header.update("nz", self._num_frames_in_part)
        self._intermediate_file.seek(0)
        self._rc_header.serialize_to(self._intermediate_file)
        self._intermediate_file.close()
        if self._validation_file is not None:
            self._validation_file.close()
        if self._compression_pool is not None:
            self._compression_pool.shutdown(wait=False)
        # back to the caching host allocator, which keeps it pinned for the
        # next writer (device.pinned_empty)
        self._staging = None


def print_run_metrics(run_metrics: dict) -> None:
    """Pretty-print per-frame metrics (reference recode_writer.py:610-618)."""
    for key, value in run_metrics.items():
        if key.startswith("frame_"):
            frames = max(run_metrics.get("run_frames", 1), 1)
            total = run_metrics.get("frame_time")
            fraction = value / total if total else float("nan")
            print(key, "\t", value / frames, "\t", fraction)
        elif key == "run_dose_rates":
            print(key, "\t", value, "\t", "Avg.=", np.mean(value))
        else:
            print(key, "\t", value)
