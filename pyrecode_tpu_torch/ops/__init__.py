"""Tensor operations of the port: plain PyTorch, and the Hopper kernels.

Kernel modules (each kernel with its plain twin and launch counter):
:mod:`.hopper_encode`, :mod:`.hopper_label`, :mod:`.hopper_bitpack`,
:mod:`.hopper_deflate`, :mod:`.hopper_gaps`, :mod:`.hopper_rans`,
:mod:`.hopper_decode`.  Plain PyTorch: :mod:`.bitpack`, :mod:`.cc_label`,
:mod:`.segment`, :mod:`.compact`.
"""

from .bitpack import (bitpack_values, bitpack_values_device, bitunpack_values,
                      bitunpack_values_device, pack_bits, packed_group_shape,
                      packed_size_bytes, unpack_bits)
from .cc_label import label_components
from .compact import stream_compact
from .decode import decode_bitmap_frames, decode_l1_frames
from .encode import EncodeResult, count_foreground, encode_frames_auto
from .hopper_bitpack import bitpack12, bitunpack12
from .hopper_decode import decode_l1, posdecode
from .hopper_deflate import assemble, compact_tokens, tokenize, tokenize_compact
from .hopper_encode import encode_l1
from .hopper_gaps import bitmap_positions
from .hopper_label import encode_l2l4
from .hopper_rans import rans_decode, rans_encode, rans_encode_tokens, rans_hist

__all__ = [
    "EncodeResult", "assemble", "bitmap_positions", "bitpack12", "bitpack_values",
    "bitpack_values_device", "bitunpack12", "bitunpack_values", "bitunpack_values_device",
    "compact_tokens", "count_foreground", "decode_bitmap_frames", "decode_l1",
    "decode_l1_frames", "encode_frames_auto", "encode_l1", "encode_l2l4", "label_components",
    "pack_bits", "packed_group_shape", "packed_size_bytes", "posdecode", "rans_decode",
    "rans_encode", "rans_encode_tokens", "rans_hist", "stream_compact", "tokenize", "tokenize_compact",
    "unpack_bits",
]
