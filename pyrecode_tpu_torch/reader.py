"""ReCoDeReader and merge_parts on PyTorch: decode and finalize containers.

The port's counterpart of pyrecode_tpu/reader.py, a class of its own:
opening merged or intermediate files, seek tables from the per-frame
metadata, random access ``get_frame(z)`` (merged only), sequential
``get_next_frame()``, raw pass-through ``get_next_frame_raw()`` for merging,
the sparse host decode, and ``merge_parts``, the ordered k-way merge of part
files into one seekable container (reference recode_reader.py:15-595).

``read_frames_dense`` decodes in bulk on the reader's device: L1 scheme 12
through the device rANS read chains, L1 otherwise by host inflate, then the
12-bit unpack kernel (other bit depths: plain unpack) and the decode kernel;
from the card the frames come back into pinned host memory.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from scipy.sparse import coo_matrix

from . import codecs, native, oracle
from .codecs import rans
from .constants import map_dtype
from .device import pinned_empty, resolve_device
from .header import ReCoDeHeader
from .ops.bitpack import bitunpack_values_device, packed_group_shape
from .ops.hopper_decode import decode_l1
from .profiling import annotate
from .structures import ReCoDeStructures

# schemes whose decompress is stateless / thread-safe (zstd and blosc hold
# per-codec context objects that are not)
_POOL_SAFE_SCHEMES = (0, 2, 3, 4, 5, 12)


class ReCoDeReader:
    """Decoder for merged (.rcX) and intermediate (.rcX_partNNN) files."""

    def __init__(self, file, is_intermediate: bool = False, device="cuda"):
        self._device = resolve_device(device)
        self._source_filename = file
        self._is_intermediate = 1 if is_intermediate else 0
        self._current_frame_index = 0
        self._fp = None
        self._file_size = None
        self._rc_header: Optional[ReCoDeHeader] = None
        self._header: Optional[dict] = None
        self._structures: Optional[ReCoDeStructures] = None
        self._frame_metadata = None
        self._seek_table = None
        self._frame_data_start_position = 0
        self._sz_frame_metadata = None
        self._numpy_dtype = None
        self._codec = None

    # ------------------------------------------------------------------- open

    def open(self, print_header: bool = False) -> None:
        self._rc_header = ReCoDeHeader()
        self._rc_header.load(self._source_filename, is_intermediate=bool(self._is_intermediate))
        self._header = self._rc_header.as_dict()
        if print_header:
            self._rc_header.print()
        codecs.import_checks(self._header)

        self._fp = open(self._source_filename, "rb")
        self._fp.seek(0, 2)
        self._file_size = self._fp.tell()
        self._fp.seek(0, 0)

        self._initialize()
        self._load_seek_table()
        self._numpy_dtype = map_dtype(int(self._header["target_dtype"]),
                                      int(self._header["target_bit_depth"]))
        if int(self._header["rc_operation_mode"]) == 1:
            self._codec = codecs.get_codec(int(self._header["compression_scheme"]),
                                           int(self._header["compression_level"]))

    def _initialize(self) -> None:
        # header fields are untrusted bytes: validate before they size any
        # buffer or index any schema
        level = int(self._header["reduction_level"])
        mode = int(self._header["rc_operation_mode"])
        ny, nx = int(self._header["ny"]), int(self._header["nx"])
        if level not in (1, 2, 3, 4):
            raise ValueError(f"Invalid reduction level in header: {level}")
        if mode not in (0, 1):
            raise ValueError(f"Invalid rc_operation_mode in header: {mode}")
        if not (0 < ny <= 65536 and 0 < nx <= 65536):
            raise ValueError(f"Invalid frame shape in header: ({ny}, {nx})")
        if int(self._header["nz"]) > (self._file_size or 0):
            raise ValueError(
                f"Header nz={int(self._header['nz'])} exceeds file size {self._file_size}")
        self._structures = ReCoDeStructures(self._header)
        nsm = self._rc_header.non_standard_metadata_sizes
        self._sz_frame_metadata = (
            self._structures.get_standard_frame_metadata_size(level, mode) + sum(nsm.values()))
        self._frame_data_start_position = self._rc_header.get_frame_data_offset(
            bool(self._is_intermediate), self._sz_frame_metadata)

    def _load_seek_table(self) -> None:
        """The per-frame seek table of a merged file: frame offsets are the
        cumulative frame sizes from the metadata table between the headers
        and the frame data (recode_reader.py:127-168)."""
        if self._is_intermediate:
            return
        level = int(self._header["reduction_level"])
        mode = int(self._header["rc_operation_mode"])
        sm = self._structures.standard_frame_metadata_structure_for(level, mode)
        nz = int(self._header["nz"])

        meta_start = self._rc_header.get_frame_data_offset(True, self._sz_frame_metadata)
        if meta_start + nz * self._sz_frame_metadata > self._file_size:
            raise ValueError(
                "Frame metadata table extends past end of file "
                f"(nz={nz}, {self._sz_frame_metadata} B/frame, file is {self._file_size} B)")
        self._fp.seek(meta_start, 0)
        raw = self._fp.read(nz * self._sz_frame_metadata)

        self._frame_metadata = []
        pos = 0
        for _ in range(nz):
            d = {}
            for field in sm:
                d[field["name"]] = int.from_bytes(raw[pos: pos + field["bytes"]], "little")
                pos += field["bytes"]
            for name, size in self._rc_header.non_standard_metadata_sizes.items():
                d[name] = raw[pos: pos + size]
                pos += size
            self._frame_metadata.append(d)

        self._seek_table = np.zeros((nz, 2), dtype=np.uint64)
        for z in range(nz):
            self._seek_table[z, 0] = self._structures.get_frame_data_size(
                level, mode, self._frame_metadata[z])
        self._seek_table[1:, 1] = np.cumsum(self._seek_table[:-1, 0])
        if nz and int(self._seek_table[-1, 1] + self._seek_table[-1, 0]) > (
                self._file_size - self._frame_data_start_position):
            raise ValueError("Seek table extends past end of file (corrupt per-frame "
                             "length fields)")

    # ------------------------------------------------------------- properties

    def get_header(self) -> ReCoDeHeader:
        return self._rc_header

    def get_source_header(self):
        return self._rc_header.source_header

    def get_shape(self):
        return (int(self._header["nz"]), int(self._header["ny"]), int(self._header["nx"]))

    get_true_shape = get_shape

    def get_dtype(self):
        return self._header["target_dtype"]

    @property
    def sz_frame_metadata(self):
        return self._sz_frame_metadata

    def get_file_position(self) -> int:
        return self._fp.tell()

    def seek_to_frame_data(self) -> None:
        self._frame_data_start_position = self._rc_header.get_frame_data_offset(
            bool(self._is_intermediate), self._sz_frame_metadata)
        self._fp.seek(0, 2)
        if self._frame_data_start_position <= self._fp.tell():
            self._fp.seek(self._frame_data_start_position, 0)

    # ------------------------------------------------------------------- read

    def _read_intermediate_metadata(self):
        """Read [frame_id u32][metadata fields] at the current position."""
        # part files grow during acquisition (live viewing): refresh the size
        self._file_size = os.fstat(self._fp.fileno()).st_size
        level = int(self._header["reduction_level"])
        mode = int(self._header["rc_operation_mode"])
        sm = self._structures.standard_frame_metadata_structure_for(level, mode)
        if self._file_size - self._fp.tell() < 4 + self._sz_frame_metadata:
            return None, None
        frame_id = int.from_bytes(self._fp.read(4), "little")
        d = {}
        for field in sm:
            d[field["name"]] = int.from_bytes(self._fp.read(field["bytes"]), "little")
        for name, size in self._rc_header.non_standard_metadata_sizes.items():
            d[name] = self._fp.read(size)
        return frame_id, d

    def _check_random_access(self, z: int) -> None:
        if self._is_intermediate:
            raise ValueError("Random access is not available for intermediate files")
        if not 0 <= z < int(self._header["nz"]):
            raise ValueError("Requested frame index is greater than number of frames in dataset")

    def get_frame(self, z: int):
        """Random access to frame z (merged files only, recode_reader.py:188)."""
        self._check_random_access(z)
        self._fp.seek(self._frame_data_start_position + int(self._seek_table[z, 1]), 0)
        if self._file_size - self._fp.tell() == 0:
            return None
        frame_dict = self._decode_current(self._frame_metadata[z])
        if frame_dict is None:
            return None
        self._current_frame_index = z + 1
        return {z: frame_dict}

    def get_next_frame(self):
        """Sequential decode (recode_reader.py:223-273)."""
        if self._current_frame_index == 0:
            self._fp.seek(self._frame_data_start_position, 0)
        if self._is_intermediate:
            self._file_size = os.fstat(self._fp.fileno()).st_size
        if self._file_size - self._fp.tell() == 0:
            return None
        if not self._is_intermediate and self._current_frame_index >= int(self._header["nz"]):
            raise ValueError("Requested frame index is greater than number of frames in dataset")

        if self._is_intermediate:
            frame_id, d = self._read_intermediate_metadata()
            if frame_id is None:
                return None
        else:
            frame_id = self._current_frame_index
            d = self._frame_metadata[frame_id]

        frame_dict = self._decode_current(d)
        if frame_dict is None:
            self._header["nz"] = self._current_frame_index
            return None
        self._current_frame_index += 1
        return {frame_id: frame_dict}

    def get_next_frame_raw(self, read_data: bool = True):
        """Raw pass-through of the next frame (for merge, recode_reader.py:275-324)."""
        if self._current_frame_index == 0:
            self._fp.seek(self._frame_data_start_position, 0)
        if not self._is_intermediate and self._current_frame_index >= int(self._header["nz"]):
            raise ValueError("Requested frame index is greater than number of frames in dataset")

        if self._is_intermediate:
            frame_id, d = self._read_intermediate_metadata()
            if frame_id is None:
                return None
        else:
            if self._file_size - self._fp.tell() == 0:
                return None
            frame_id = self._current_frame_index
            d = self._frame_metadata[frame_id]

        raw = self._read_raw_blobs(d, read_data=read_data)
        if raw is None:
            return None
        self._current_frame_index += 1
        return {frame_id: {"metadata": d, "data": raw}}

    def _read_raw_blobs(self, metadata: dict, read_data: bool = True):
        level = int(self._header["reduction_level"])
        mode = int(self._header["rc_operation_mode"])
        if mode == 0:
            sz_binary_map = self._structures.binary_image_sz_bytes
        else:
            sz_binary_map = int(metadata["bytes_in_compressed_binary_map"])

        if self._file_size - self._fp.tell() < sz_binary_map:
            return None
        if read_data:
            binary_map = self._fp.read(sz_binary_map)
        else:
            binary_map = None
            self._fp.seek(sz_binary_map, 1)

        if level in (1, 2):
            if level == 1:
                key = "bytes_in_packed_pixvals" if mode == 0 else "bytes_in_compressed_pixvals"
            else:
                key = ("bytes_in_packed_summary_stats" if mode == 0
                       else "bytes_in_compressed_summary_stats")
            sz_pixvals = int(metadata[key])
            if self._file_size - self._fp.tell() < sz_pixvals:
                return None
            if read_data:
                pixvals = self._fp.read(sz_pixvals)
            else:
                pixvals = None
                self._fp.seek(sz_pixvals, 1)
            return {"binary_map": binary_map, "pixvals": pixvals}
        return {"binary_map": binary_map}

    def _decode_current(self, metadata: dict):
        """Decode the frame at the current file position into a COO frame."""
        level = int(self._header["reduction_level"])
        mode = int(self._header["rc_operation_mode"])
        ny, nx = int(self._header["ny"]), int(self._header["nx"])
        bit_depth = int(self._header["target_bit_depth"])

        raw = self._read_raw_blobs(metadata, read_data=True)
        if raw is None:
            return None
        binary_map = raw["binary_map"]
        pixvals = raw.get("pixvals")
        if mode == 1:
            binary_map = self._codec.decompress(binary_map)
            if pixvals is not None:
                pixvals = self._codec.decompress(pixvals)

        rows, cols, vals = native.unpack_frame_sparse(
            binary_map, pixvals if level == 1 else None, ny, nx, bit_depth, level)
        data = coo_matrix((vals.astype(self._numpy_dtype), (rows, cols)),
                          shape=(ny, nx), dtype=self._numpy_dtype)
        if level != 2:
            return {"metadata": metadata, "data": data}
        # the true puddle count comes from a label pass over the decoded
        # bitmap, not from the packed byte length (its pad bits would count)
        mask = np.zeros((ny, nx), np.uint8)
        mask[rows.astype(np.int64), cols.astype(np.int64)] = 1
        _, n_puddles = native.label_components(mask)
        stats = oracle.decode_summary_stats(pixvals, bit_depth, n_puddles, dtype=self._numpy_dtype)
        return {"metadata": metadata, "data": data, "summary_stats": stats}

    # --------------------------------------------------------- batched decode

    def read_frames_dense(self, start: int, count: int, use_tpu: bool = True,
                          verify: bool = False) -> np.ndarray:
        """Bulk-decode ``count`` frames starting at ``start`` to a dense array.

        ``use_tpu`` (the JAX reader's name) selects the device path; False
        decodes on the host.  Levels 2-4 decode on the host after the
        entropy decode.  Scheme-12 L1 reads through the gap chain (gap
        bitmaps: rANS decode -> positions -> positions decode) or the symbol
        chain (bitmaps as 8-bit symbols), which never check the streams'
        adler32; ``verify=True`` takes the byte path instead (device rANS
        decode to bytes, adler-checked, then the decode kernel).

        On the card the frames are copied into page-locked host memory from
        PyTorch's caching host allocator, several times faster than into a
        fresh pageable array.  The caller owns the returned array: no array
        alive at the same time shares its memory, and its block goes back
        to the allocator only when the array is freed.  The cost: the
        allocator keeps its blocks pinned after the arrays are freed, as
        many as were alive at once, each the output's size rounded up to a
        power of two, for later outputs and writers' staging buffers of the
        process (:func:`.device.pinned_empty`).
        """
        args = {"start": start, "count": count}
        with annotate("reader.read_frames_dense", args):
            return self._read_frames_dense(start, count, use_tpu, verify, args)

    def _read_frames_dense(self, start: int, count: int, use_tpu: bool, verify: bool,
                           args: dict) -> np.ndarray:
        """``read_frames_dense``; its child spans tile it: ``reader.fetch``,
        ``reader.inflate`` (host inflate, or scheme 12's device rANS decode
        to bytes, ``reader.rans_bytes``), ``reader.stage`` (the host arrays
        of bitmaps and packed values and their copies to the device),
        ``reader.decode`` (through the overflow check; the host decode, or
        scheme 12's device chains from the coded streams, ``reader.rans_chain``
        where a chain runs) and ``reader.d2h`` (see ``_to_host``).  A
        scheme-12 L1 call with ``use_tpu`` runs one of ``reader.rans_chain``
        and ``reader.rans_bytes``."""
        with annotate("reader.fetch", args):
            self._check_random_access(start)
            count = min(count, int(self._header["nz"]) - start)
            level = int(self._header["reduction_level"])
            mode = int(self._header["rc_operation_mode"])
            scheme = int(self._header["compression_scheme"])
            ny, nx = int(self._header["ny"]), int(self._header["nx"])
            bit_depth = int(self._header["target_bit_depth"])

            raw_blobs = []
            for z in range(start, start + count):
                self._fp.seek(self._frame_data_start_position + int(self._seek_table[z, 1]), 0)
                raw = self._read_raw_blobs(self._frame_metadata[z], read_data=True)
                raw_blobs.append((raw["binary_map"], raw.get("pixvals")))

        dev12 = use_tpu and mode == 1 and scheme == 12
        if dev12 and level == 1 and all(pv is not None for _, pv in raw_blobs):
            bms, pvs = [bm for bm, _ in raw_blobs], [pv for _, pv in raw_blobs]
            with annotate("reader.decode", args):
                dense = rans.decode_l1_gap_device(bms, pvs, ny, nx, self._device, verify=verify)
                if dense is None:
                    dense = rans.decode_l1_symbol_device(bms, pvs, ny, nx, self._device,
                                                         verify=verify)
            if dense is not None:
                return self._to_host(dense, args)
        with annotate("reader.inflate", args):
            if dev12:
                with annotate("reader.rans_bytes", args):
                    flat = rans.rans_decompress_device_batch(
                        [b for pair in raw_blobs for b in pair if b is not None],
                        self._device)
                it = iter(flat)
                inflated = [(next(it), next(it) if pv is not None else None)
                            for _, pv in raw_blobs]
            else:
                inflated = self._inflate(raw_blobs, mode, scheme)
        with annotate("reader.stage", args):
            bitmaps = np.zeros((count, self._structures.binary_image_sz_bytes), dtype=np.uint8)
            for i, (bm, _) in enumerate(inflated):
                bitmaps[i] = np.frombuffer(bm, dtype=np.uint8)
            pixval_blobs = [pv for _, pv in inflated]
            on_host = not use_tpu or level != 1
            if not on_host:
                _, g_bytes = packed_group_shape(bit_depth)
                max_bytes = max((len(b) for b in pixval_blobs), default=g_bytes)
                max_bytes = max(g_bytes, -(-max_bytes // g_bytes) * g_bytes)
                packed = np.zeros((count, max_bytes), dtype=np.uint8)
                for i, blob in enumerate(pixval_blobs):
                    packed[i, : len(blob)] = np.frombuffer(blob, dtype=np.uint8)
                packed_dev = torch.from_numpy(packed).to(self._device)
                bitmaps_dev = torch.from_numpy(bitmaps).to(self._device)

        with annotate("reader.decode", args):
            if on_host:
                out = np.zeros((count, ny, nx), dtype=self._numpy_dtype)
                for i in range(count):
                    rows, cols, vals = oracle.decode_frame_sparse(
                        bitmaps[i].tobytes(), pixval_blobs[i], ny, nx, bit_depth, level,
                        dtype=self._numpy_dtype)
                    out[i, rows.astype(int), cols.astype(int)] = vals
                return out
            values = bitunpack_values_device(packed_dev, bit_depth)
            dense, overflow = decode_l1(bitmaps_dev, values, ny, nx)
            if bool(overflow.any()):
                raise ValueError("corrupt frame: more foreground pixels than stored values")
        return self._to_host(dense, args)

    def _to_host(self, dense: torch.Tensor, args: dict) -> np.ndarray:
        """The span ``reader.d2h``: the decoded frames as a host array.

        A tensor on the card is copied, synchronously, into a fresh tensor
        of pinned host memory (span ``reader.d2h_pinned`` around the copy,
        not the allocation); if pinning fails, into pageable memory.  A
        tensor on the CPU is returned without a copy."""
        with annotate("reader.d2h", args):
            if dense.device.type == "cuda":
                host = pinned_empty(dense.shape, dense.dtype)
                if host is not None:
                    with annotate("reader.d2h_pinned", args):
                        host.copy_(dense)
                    return host.numpy().astype(self._numpy_dtype, copy=False)
            return dense.cpu().numpy().astype(self._numpy_dtype, copy=False)

    def _inflate(self, raw_blobs, mode: int, scheme: int):
        """Entropy-decode (bitmap, pixvals) blob pairs on the host."""
        def inflate(blob_pair):
            bm, pv = blob_pair
            if mode == 0:
                return bm, pv
            return (self._codec.decompress(bm),
                    self._codec.decompress(pv) if pv is not None else None)

        count = len(raw_blobs)
        if mode == 1 and count > 1 and scheme in _POOL_SAFE_SCHEMES:
            # the codecs release the GIL: fan the per-frame inflate over threads
            workers = min(count, max((os.cpu_count() or 2) // 2, 1))
            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(inflate, raw_blobs))
        return [inflate(pair) for pair in raw_blobs]

    # ------------------------------------------------------------------ close

    def copy_headers_to(self, target_fp, source_header_length: int) -> None:
        self._fp.seek(0, 0)
        target_fp.write(self._fp.read(self._rc_header.recode_header_length))
        target_fp.write(self._fp.read(source_header_length))

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def merge_parts(folder_path: str, base_filename: str, num_parts: int) -> str:
    """Merge intermediate part files into one seekable ReCoDe file.

    Reproduces reference recode_reader.py:495-595: ordered k-way merge on
    frame_id, metadata table backfilled before the frame data, ``nz``
    patched to the true merged frame count.  Returns the merged file path.
    """
    with annotate("merge.parts"):
        return _merge_parts(folder_path, base_filename, num_parts)


def _merge_parts(folder_path: str, base_filename: str, num_parts: int) -> str:
    """``merge_parts``, with the spans ``merge.scan`` (the frame count) and
    ``merge.copy`` (the k-way merge, the table backfill, ``nz``)."""
    part_names = [os.path.join(folder_path, f"{base_filename}_part{index:03d}")
                  for index in range(num_parts)]
    target_path = os.path.join(folder_path, base_filename)

    def part_reader(name):
        reader = ReCoDeReader(name, is_intermediate=True, device="cpu")
        reader.open()
        return reader

    with open(target_path, "wb") as target:
        reader0 = part_reader(part_names[0])
        header = reader0.get_header().as_dict()
        source_header_length = int(header["source_header_length"])
        reader0.copy_headers_to(target, source_header_length)
        sz_frame_metadata = reader0.sz_frame_metadata
        header_length = reader0.get_header().recode_header_length
        nz_position = reader0.get_header().get_field_position_in_bytes("nz")
        nz_bytes = reader0.get_header().get_definition("nz")["bytes"]
        reader0.close()

        readers = [part_reader(name) for name in part_names]
        pending = [reader.get_next_frame_raw() for reader in readers]

        # reserve the metadata region: count every part's frames first
        with annotate("merge.scan"):
            total_frames = 0
            for name in part_names:
                scan = part_reader(name)
                while scan.get_next_frame_raw(read_data=False) is not None:
                    total_frames += 1
                scan.close()
        target.seek(total_frames * sz_frame_metadata, 1)

        with annotate("merge.copy"):
            # k-way min-merge on frame_id
            metadata_rows = []
            metadata_fields = ReCoDeStructures(header).standard_frame_metadata_structure_for(
                int(header["reduction_level"]), int(header["rc_operation_mode"]))
            while True:
                live = [(i, next(iter(p.keys()))) for i, p in enumerate(pending) if p is not None]
                if not live:
                    break
                part_index, frame_id = min(live, key=lambda t: t[1])
                frame = pending[part_index][frame_id]
                metadata_rows.append(frame["metadata"])
                for blob in frame["data"].values():
                    target.write(blob)
                pending[part_index] = readers[part_index].get_next_frame_raw()

            # backfill the metadata table (frame_id is dropped: recode_reader.py:584-585)
            target.seek(header_length + source_header_length, 0)
            for row in metadata_rows:
                for field in metadata_fields:
                    target.write(int(row[field["name"]]).to_bytes(field["bytes"], "little"))

            # patch nz with the true merged frame count
            target.seek(nz_position, 0)
            target.write(len(metadata_rows).to_bytes(nz_bytes, "little"))

    for reader in readers:
        reader.close()
    return target_path
