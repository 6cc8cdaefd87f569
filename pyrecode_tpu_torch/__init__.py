"""pyrecode_tpu_torch — the ReCoDe codec on PyTorch and CUDA for NVIDIA Hopper.

A port of :mod:`pyrecode_tpu` (JAX on a TPU), slice by slice.  This slice is
the main operating point: L1 reduction, ``rc_operation_mode=1``,
``compression_scheme=0``, 12-bit values, through

    ReCoDeServer('batch') -> ReCoDeWriter part files -> merge_parts
    -> ReCoDeReader.read_frames_dense

Hand-written CUDA kernels for ``sm_90a`` (``csrc/``) carry its device
work: the fused L1 encode, the 12-bit pack, the deflate tokenizer (dense
and compacted) and bit assembler of the device entropy stage, the 12-bit
unpack and the L1 decode.  Huffman tables, headers, parameters, container
layout, host entropy coding and merge are the JAX package's JAX-free
modules, imported, not copied.

Writer, reader and server take ``device=`` ("cuda" by default; "cpu" runs
each kernel's plain PyTorch twin).  On CUDA the writer deflates on the
device by default (``device_entropy``), as the JAX writer does on a TPU.
This package imports ``torch`` and never ``jax``.
"""

from pyrecode_tpu.params import InitParams, InputParams

from .ops import hopper_bitpack, hopper_decode, hopper_deflate, hopper_encode
from .reader import ReCoDeReader, merge_parts
from .server import ReCoDeServer
from .writer import ReCoDeWriter

__all__ = [
    "InitParams",
    "InputParams",
    "ReCoDeWriter",
    "ReCoDeReader",
    "ReCoDeServer",
    "merge_parts",
    "kernel_launch_counts",
    "reset_kernel_launch_counts",
]

_COUNTERS = {
    "encode_l1": hopper_encode.LAUNCHES,
    "bitpack12": hopper_bitpack.PACK_LAUNCHES,
    "tokenize": hopper_deflate.TOKENIZE_LAUNCHES,
    "tokenize_compact": hopper_deflate.TOKENIZE_COMPACT_LAUNCHES,
    "assemble": hopper_deflate.ASSEMBLE_LAUNCHES,
    "bitunpack12": hopper_bitpack.UNPACK_LAUNCHES,
    "decode_l1": hopper_decode.LAUNCHES,
}


def kernel_launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {name: counter.value for name, counter in _COUNTERS.items()}


def reset_kernel_launch_counts() -> None:
    for counter in _COUNTERS.values():
        counter.reset()
