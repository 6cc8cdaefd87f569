"""The port's frame record (``structures.frame_record``) for each of the
eight (level, mode) pairs: read back through the container's schema, the
record holds its frame id, each metadata field (a stream's length, or mode
1's uncompressed packed length), then its streams, and its length is the
frame id, the metadata and the frame's data size the reader seeks by."""

import numpy as np
import pytest

from pyrecode_tpu_torch.structures import ReCoDeStructures, frame_record

HEADER = {"nx": 100, "ny": 60}   # a 750-byte bitmap
FIRST, SECOND, UNCOMPRESSED = 123, 77, 4321
PAIRS = [(level, mode) for level in (1, 2, 3, 4) for mode in (0, 1)]
FIELDS = {
    (1, 0): {"bytes_in_packed_pixvals": SECOND},
    (1, 1): {"bytes_in_compressed_binary_map": FIRST, "bytes_in_compressed_pixvals": SECOND,
             "bytes_in_packed_pixvals": UNCOMPRESSED},
    (2, 0): {"bytes_in_packed_summary_stats": SECOND},
    (2, 1): {"bytes_in_compressed_binary_map": FIRST,
             "bytes_in_compressed_summary_stats": SECOND,
             "bytes_in_packed_summary_stats": UNCOMPRESSED},
    (3, 0): {}, (3, 1): {"bytes_in_compressed_binary_map": FIRST},
    (4, 0): {}, (4, 1): {"bytes_in_compressed_binary_map": FIRST},
}


@pytest.mark.parametrize("level, mode", PAIRS, ids=[f"L{lv}-mode{md}" for lv, md in PAIRS])
def test_record_reads_back_through_the_schema(level, mode):
    rng = np.random.default_rng(10 * level + mode)
    structures = ReCoDeStructures(HEADER)
    # mode 0 stores the raw bitmap, mode 1 a coded one of any length
    first = rng.integers(0, 256, structures.binary_image_sz_bytes if mode == 0 else FIRST,
                         dtype=np.uint8).tobytes()
    second = rng.integers(0, 256, SECOND, dtype=np.uint8).tobytes() if level in (1, 2) else None
    record = frame_record(level, mode, 0xA1B2C3, first, second, UNCOMPRESSED)

    assert int.from_bytes(record[:4], "little") == 0xA1B2C3
    pos, fields = 4, {}
    for field in structures.standard_frame_metadata_structure_for(level, mode):
        fields[field["name"]] = int.from_bytes(record[pos:pos + field["bytes"]], "little")
        pos += field["bytes"]
    assert fields == FIELDS[(level, mode)]
    assert record[pos:] == first + (second or b"")
    assert len(record) == (4 + structures.get_standard_frame_metadata_size(level, mode)
                           + structures.get_frame_data_size(level, mode, fields))
