"""Session (InitParams) and codec (InputParams) parameter handling.

The port's own copy of pyrecode_tpu/params.py: the port imports nothing of the
JAX package.

Capability parity with the reference ``pyrecode/params.py``:

* ``InitParams`` (params.py:7-190) — runtime/session options: mode
  batch/stream, paths, verbosity, validation frame gap, streaming chunking.
  The reference's ``use_c`` flag (select the C hot path) maps here to
  ``use_tpu`` (select the TPU batched encode path vs. the numpy oracle path).
* ``InputParams`` (params.py:193-579) — the 25 codec parameters loaded from a
  flat ``key = int`` text file with a strict known-key check (params.py:215-225),
  the validation matrix (params.py:227-341) and round-trip ``serialize()``
  (params.py:343-346).  These parameters are frozen into every file header,
  making files self-describing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from .constants import map_dtype

_PARAM_KEYS = (
    "reduction_level", "rc_operation_mode", "calibration_threshold_epsilon",
    "target_bit_depth", "source_bit_depth", "num_cols", "num_rows",
    "num_frames", "frame_offset", "num_calibration_frames",
    "calibration_frame_offset", "keep_part_files", "num_threads",
    "l2_statistics", "l4_centroiding", "compression_scheme", "compression_level",
    "source_file_type", "source_header_length", "keep_calibration_data",
    "calibration_file_type", "source_data_type", "target_data_type",
    # derived, not exposed in params files:
    "source_numpy_dtype", "target_numpy_dtype",
)


class InitParams:
    """Validates and holds session parameters for a run."""

    def __init__(self, mode, output_directory, image_filename="", directory_path="",
                 calibration_filename="", params_filename="", validation_frame_gap=-1,
                 log_filename="recode.log", run_name="run", verbosity=0, use_tpu=True,
                 max_count=-1, chunk_time_in_sec=0, use_c=None):
        """
        Parameters
        ----------
        mode : str
            'batch' for offline processing, 'stream' for online processing.
        output_directory : str
            location where processed data will be written.
        image_filename : str
            file to process when mode='batch' (or desired output base name when
            processing in-memory data).
        directory_path : str
            folder to watch when mode='stream'.
        calibration_filename : str
            file containing calibration (dark) data.
        params_filename : str
            file containing codec input parameters.
        validation_frame_gap : int
            number of frames between archived raw validation frames (<=0 disables).
        log_filename, run_name : str
            logging identity.
        verbosity : int
            0, 1 or 2 (clamped).
        use_tpu : bool
            True = batched TPU encode path; False = numpy oracle path.
            (``use_c`` is accepted as a deprecated alias for API compatibility
            with the reference, params.py:37-38.)
        max_count : int
            maximum number of data chunks to process when mode='stream'.
        chunk_time_in_sec : int
            acquisition seconds per chunk file when mode='stream'.
        """
        self._mode = str(mode).strip().lower()
        self._verbosity = int(verbosity)
        self._validation_frame_gap = validation_frame_gap
        self._image_filename = image_filename
        self._calibration_filename = calibration_filename
        self._params_filename = params_filename
        self._output_directory = output_directory
        self._log_filename = log_filename
        self._run_name = run_name
        # ``use_c`` is accepted for reference API compatibility but has no
        # effect: the native hot path here is the TPU one, chosen via use_tpu.
        del use_c
        self._use_tpu = bool(use_tpu)
        self._directory_path = directory_path
        self._max_count = max_count
        self._chunk_time_in_sec = chunk_time_in_sec

        if not self._validate_init_params():
            self.show_usage()
            raise ValueError("Invalid initialization parameters")

    def validate(self):
        return self._validate_init_params()

    def _validate_init_params(self) -> bool:
        if self._output_directory == "":
            print("Output Directory cannot be empty")
            return False
        if self._mode not in ("batch", "stream"):
            print("Unknown mode: mode can only be 'batch' or 'stream'")
            return False
        if self._mode == "batch" and self._image_filename == "":
            print("Image filename cannot be empty")
            return False
        self._verbosity = min(max(self._verbosity, 0), 2)
        return True

    mode = property(lambda self: self._mode)
    verbosity = property(lambda self: self._verbosity)
    validation_frame_gap = property(lambda self: self._validation_frame_gap)
    image_filename = property(lambda self: self._image_filename)
    calibration_filename = property(lambda self: self._calibration_filename)
    params_filename = property(lambda self: self._params_filename)
    output_directory = property(lambda self: self._output_directory)
    log_filename = property(lambda self: self._log_filename)
    run_name = property(lambda self: self._run_name)
    use_tpu = property(lambda self: self._use_tpu)
    # deprecated alias kept for reference API compatibility
    use_c = property(lambda self: not self._use_tpu)
    directory_path = property(lambda self: self._directory_path)
    max_count = property(lambda self: self._max_count)
    chunk_time_in_sec = property(lambda self: self._chunk_time_in_sec)

    @staticmethod
    def show_usage():
        print("See README.md for usage details")


class InputParams:
    """The codec parameter set frozen into every ReCoDe file header."""

    def __init__(self, values: Optional[Dict[str, int]] = None):
        self._param_map: Dict[str, object] = {k: -1 for k in _PARAM_KEYS}
        if values:
            for key, value in values.items():
                key = key.strip().lower()
                if key not in self._param_map:
                    raise ValueError(f"Unknown parameter: {key}")
                self._param_map[key] = value

    # ------------------------------------------------------------------- io

    def load(self, params_filename: Union[str, Path]) -> None:
        """Load from a flat ``key = int`` text file with strict key checking."""
        if str(params_filename) == "":
            raise ValueError("Params filename missing")
        with open(params_filename) as fp:
            for line in fp:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, value = line.partition("=")
                key = key.strip().lower()
                if key not in self._param_map:
                    raise ValueError(f"Unknown parameter: {key}")
                self._param_map[key] = int(value.strip())

    def serialize(self, filename: Union[str, Path]) -> None:
        with open(filename, "w") as f:
            for key in self._param_map:
                if key in ("source_numpy_dtype", "target_numpy_dtype"):
                    continue  # derived, not valid `key = int` entries
                f.write(f"{key} = {self._param_map[key]}\n")

    # ------------------------------------------------------------- validation

    def validate(self) -> bool:
        return self._validate_input_params()

    def _validate_input_params(self) -> bool:
        p = self._param_map

        def fail(msg: str) -> bool:
            print(msg)
            return False

        if p["reduction_level"] not in (1, 2, 3, 4):
            return fail("Reduction level must be 1, 2, 3 or 4")
        if p["rc_operation_mode"] not in (0, 1):
            return fail("RC Operation mode can be 0 or 1")
        if p["calibration_threshold_epsilon"] == "":
            return fail("Calibration threshold (epsilon) cannot be empty")
        binary_like = p["source_file_type"] in (0, 3)
        if p["source_bit_depth"] == -1 and binary_like:
            return fail("Source bit depth cannot be empty when source filetype is binary/other")
        for dim in ("num_cols", "num_rows", "num_frames"):
            if p[dim] == -1 and binary_like:
                return fail(f"{dim} cannot be empty when source filetype is binary/other")
        for int_key in ("frame_offset", "num_calibration_frames", "calibration_frame_offset", "num_threads"):
            if not isinstance(p[int_key], (int, np.integer)):
                return fail(f"{int_key} should be an integer")
        if p["keep_part_files"] not in (0, 1):
            return fail("Keep part files must be 0 or 1")
        if p["l2_statistics"] not in (0, 1, 2):
            return fail("L2 statistics must be 0, 1 or 2")
        if p["l4_centroiding"] not in (0, 1, 2, 3):
            return fail("L4 centroiding must be 0, 1, 2 or 3")
        if p["compression_scheme"] not in range(13):
            return fail("Compression scheme must be an integer in [0, 12]")
        if not (0 <= int(p["compression_level"]) <= 22):
            return fail("Compression level can be from 0 - 22")
        if p["keep_calibration_data"] not in (0, 1):
            return fail("Keep calibration data must be 0 or 1")
        if p["source_file_type"] not in (0, 1, 2, 3):
            return fail("Source file type must be 0, 1, 2 or 3")
        if binary_like and not isinstance(p["source_header_length"], (int, np.integer)):
            return fail("Source Header Length must be an integer when source filetype is binary/other")
        if binary_like and p["source_header_length"] == -1:
            # raw binary has no header unless told otherwise
            p["source_header_length"] = 0
        if p["calibration_file_type"] not in (0, 1, 2, 3):
            return fail("Calibration filetype must be 0, 1, 2 or 3")
        if p["source_data_type"] not in (0, 1, 2):
            return fail("Source data type must be 0, 1, or 2")
        if p["target_data_type"] not in (0, 1, 2):
            return fail("Target data type must be 0, 1, or 2")

        if p["frame_offset"] < 0:
            p["frame_offset"] = 0
        if p["num_threads"] < 1:
            p["num_threads"] = 1
        if p["target_bit_depth"] == -1:
            p["target_bit_depth"] = p["source_bit_depth"]

        p["source_numpy_dtype"] = map_dtype(p["source_data_type"], p["source_bit_depth"])
        p["target_numpy_dtype"] = map_dtype(p["target_data_type"], p["target_bit_depth"])
        return True

    # ------------------------------------------------------------- properties

    def _get(self, key):
        return self._param_map[key]

    def _set(self, key, value):
        self._param_map[key] = value

    reduction_level = property(lambda self: self._get("reduction_level"),
                               lambda self, v: self._set("reduction_level", v))
    rc_operation_mode = property(lambda self: self._get("rc_operation_mode"),
                                 lambda self, v: self._set("rc_operation_mode", v))
    calibration_threshold_epsilon = property(
        lambda self: self._get("calibration_threshold_epsilon"),
        lambda self, v: self._set("calibration_threshold_epsilon", v))
    target_bit_depth = property(lambda self: self._get("target_bit_depth"),
                                lambda self, v: self._set("target_bit_depth", v))
    source_bit_depth = property(lambda self: self._get("source_bit_depth"),
                                lambda self, v: self._set("source_bit_depth", v))
    num_cols = property(lambda self: self._get("num_cols"), lambda self, v: self._set("num_cols", v))
    num_rows = property(lambda self: self._get("num_rows"), lambda self, v: self._set("num_rows", v))
    num_frames = property(lambda self: self._get("num_frames"), lambda self, v: self._set("num_frames", v))
    nx = property(lambda self: self._get("num_cols"), lambda self, v: self._set("num_cols", v))
    ny = property(lambda self: self._get("num_rows"), lambda self, v: self._set("num_rows", v))
    nz = property(lambda self: self._get("num_frames"), lambda self, v: self._set("num_frames", v))
    frame_offset = property(lambda self: self._get("frame_offset"),
                            lambda self, v: self._set("frame_offset", v))
    num_calibration_frames = property(lambda self: self._get("num_calibration_frames"),
                                      lambda self, v: self._set("num_calibration_frames", v))
    calibration_frame_offset = property(lambda self: self._get("calibration_frame_offset"),
                                        lambda self, v: self._set("calibration_frame_offset", v))
    keep_part_files = property(lambda self: self._get("keep_part_files"),
                               lambda self, v: self._set("keep_part_files", v))
    num_threads = property(lambda self: self._get("num_threads"),
                           lambda self, v: self._set("num_threads", v))
    l2_statistics = property(lambda self: self._get("l2_statistics"),
                             lambda self, v: self._set("l2_statistics", v))
    l4_centroiding = property(lambda self: self._get("l4_centroiding"),
                              lambda self, v: self._set("l4_centroiding", v))
    L2_statistics = property(lambda self: self._get("l2_statistics"))
    L4_centroiding = property(lambda self: self._get("l4_centroiding"))
    compression_scheme = property(lambda self: self._get("compression_scheme"),
                                  lambda self, v: self._set("compression_scheme", v))
    compression_level = property(lambda self: self._get("compression_level"),
                                 lambda self, v: self._set("compression_level", v))
    keep_calibration_data = property(lambda self: self._get("keep_calibration_data"),
                                     lambda self, v: self._set("keep_calibration_data", v))
    source_file_type = property(lambda self: self._get("source_file_type"),
                                lambda self, v: self._set("source_file_type", v))
    source_header_length = property(lambda self: self._get("source_header_length"),
                                    lambda self, v: self._set("source_header_length", v))
    calibration_file_type = property(lambda self: self._get("calibration_file_type"),
                                     lambda self, v: self._set("calibration_file_type", v))
    source_data_type = property(lambda self: self._get("source_data_type"),
                                lambda self, v: self._set("source_data_type", v))
    target_data_type = property(lambda self: self._get("target_data_type"),
                                lambda self, v: self._set("target_data_type", v))
    source_numpy_dtype = property(lambda self: self._get("source_numpy_dtype"))
    target_numpy_dtype = property(lambda self: self._get("target_numpy_dtype"))

    def as_dict(self) -> Dict[str, object]:
        return dict(self._param_map)

    def __repr__(self) -> str:
        return f"InputParams({self.as_dict()!r})"
