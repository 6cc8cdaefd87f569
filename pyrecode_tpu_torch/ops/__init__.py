"""Tensor operations of the port: plain PyTorch, and the Hopper kernels.

Kernel modules (each kernel with its plain twin and launch counter):
:mod:`.hopper_encode`, :mod:`.hopper_label`, :mod:`.hopper_bitpack`,
:mod:`.hopper_deflate`, :mod:`.hopper_tokens`, :mod:`.hopper_gaps`,
:mod:`.hopper_rans`, :mod:`.hopper_decode`.  Plain PyTorch: :mod:`.bitpack`, :mod:`.cc_label`,
:mod:`.segment`, :mod:`.compact`.
"""

from .bitpack import (bitpack_values, bitpack_values_device, bitpack_values_words,
                      bitunpack_values, bitunpack_values_device, pack_bits, packed_group_shape,
                      packed_size_bytes, packed_word_group_shape, unpack_bits)
from .cc_label import label_components
from .compact import stream_compact
from .decode import decode_bitmap_frames, decode_l1_frames
from .encode import EncodeResult, count_foreground, encode_frames, encode_frames_auto
from .hopper_bitpack import PACK_LAUNCHES, UNPACK_LAUNCHES, WORDS_LAUNCHES, bitpack12, bitpack12_words, bitunpack12
from .hopper_decode import decode_l1, posdecode
from .hopper_deflate import (ASSEMBLE_SPLIT_LAUNCHES, assemble, assemble_split, compact_tokens,
                             tokenize, tokenize_compact)
from .hopper_encode import PAIRS_LAUNCHES, encode_l1
from .hopper_gaps import bitmap_positions
from .hopper_label import encode_l2l4
from .hopper_rans import rans_decode, rans_encode, rans_encode_tokens, rans_hist
from .hopper_tokens import LAUNCHES as TOKENS_FROM_PAIRS_LAUNCHES
from .hopper_tokens import tokens_from_pairs

__all__ = [
    "ASSEMBLE_SPLIT_LAUNCHES", "EncodeResult", "PACK_LAUNCHES", "PAIRS_LAUNCHES",
    "TOKENS_FROM_PAIRS_LAUNCHES", "UNPACK_LAUNCHES", "WORDS_LAUNCHES", "assemble",
    "assemble_split", "bitmap_positions", "bitpack12", "bitpack12_words", "bitpack_values",
    "bitpack_values_device", "bitpack_values_words", "bitunpack12", "bitunpack_values",
    "bitunpack_values_device", "compact_tokens", "count_foreground", "decode_bitmap_frames",
    "decode_l1", "decode_l1_frames", "encode_frames", "encode_frames_auto", "encode_l1",
    "encode_l2l4", "label_components", "pack_bits", "packed_group_shape", "packed_size_bytes",
    "packed_word_group_shape", "posdecode", "rans_decode", "rans_encode", "rans_encode_tokens",
    "rans_hist", "stream_compact", "tokenize", "tokenize_compact", "tokens_from_pairs",
    "unpack_bits",
]
