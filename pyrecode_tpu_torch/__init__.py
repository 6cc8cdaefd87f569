"""pyrecode_tpu_torch — the ReCoDe codec on PyTorch and CUDA for NVIDIA Hopper.

A port of :mod:`pyrecode_tpu` (JAX on a TPU), slice by slice, through

    ReCoDeServer('batch') -> ReCoDeWriter part files -> merge_parts
    -> ReCoDeReader.read_frames_dense

at reduction levels L1-L4, ``rc_operation_mode=1``, with compression
scheme 0 (dynamic deflate) or 12 (interleaved rANS).  Hand-written CUDA
kernels for ``sm_90a`` (``csrc/``) carry the device work: the fused L1/L3
encode (with the values' pixel positions for scheme 12), the fused L2/L4
label encode (puddle statistics, centroids), the 12-bit pack and unpack,
the deflate tokenizer (from bytes, and from the bitmap's nonzero-byte
pairs) and bit assembler (one-pass and split), the bitmap -> positions
extraction,
the rANS histogram, encode (of symbols, and of deflate tokens for the
byte-mode coder) and decode, the L1 decode and the positions decode.
:mod:`pyrecode_tpu_torch.parallel` spreads the encode over a mesh of
devices and gathers the blocks over ``torch.distributed``;
:mod:`pyrecode_tpu_torch.profiling` traces a run with ``torch.profiler``
and holds the program's spans (:func:`span_totals`: the count and host
seconds of each span closed while a profile recorded);
:mod:`pyrecode_tpu_torch.tools` holds the developer probes (the encode and
decode phase splits, the butterfly, f32-dot and lowering probes), each on
kernels of its own.

The package is self-contained: it imports ``torch`` and never ``jax``, and
nothing of :mod:`pyrecode_tpu`.  Headers, parameters, container layout,
host entropy coding and merge are its own copies of the JAX package's
JAX-free modules; the native host library builds from the repository's
``native/recode_host.cpp`` into ``pyrecode_tpu_torch/_build/``.

Writer, reader and server take ``device=`` ("cuda" by default; "cpu" runs
each kernel's plain PyTorch twin).  On CUDA the writer entropy-codes on the
device by default (``device_entropy``), as the JAX writer does on a TPU.
"""

from .ops import (hopper_bitpack, hopper_decode, hopper_deflate, hopper_encode, hopper_gaps,
                  hopper_label, hopper_probes, hopper_rans, hopper_tokens)
from .constants import get_dtype_code, get_dtype_string, map_dtype, rc_cfg
from .header import ReCoDeHeader
from .params import InitParams, InputParams
from .profiling import reset_span_totals, span_totals
from .reader import ReCoDeReader, merge_parts
from .server import ReCoDeServer
from .structures import ReCoDeStructures
from .writer import ReCoDeWriter

__version__ = "0.1.0"

__all__ = [
    "rc_cfg",
    "map_dtype",
    "get_dtype_code",
    "get_dtype_string",
    "InitParams",
    "InputParams",
    "ReCoDeHeader",
    "ReCoDeStructures",
    "ReCoDeWriter",
    "ReCoDeReader",
    "ReCoDeServer",
    "merge_parts",
    "__version__",
    "kernel_launch_counts",
    "reset_kernel_launch_counts",
    "span_totals",
    "reset_span_totals",
]

_COUNTERS = {
    "encode_l1": hopper_encode.LAUNCHES,
    "encode_l1_positions": hopper_encode.POSITIONS_LAUNCHES,
    "label_l2l4": hopper_label.LAUNCHES,
    "bitpack12": hopper_bitpack.PACK_LAUNCHES,
    "bitmap_positions": hopper_gaps.LAUNCHES,
    "tokenize": hopper_deflate.TOKENIZE_LAUNCHES,
    "tokenize_compact": hopper_deflate.TOKENIZE_COMPACT_LAUNCHES,
    "assemble": hopper_deflate.ASSEMBLE_LAUNCHES,
    "rans_hist": hopper_rans.HIST_LAUNCHES,
    "rans_encode": hopper_rans.ENCODE_LAUNCHES,
    "rans_encode_tokens": hopper_rans.ENCODE_TOKENS_LAUNCHES,
    "rans_decode": hopper_rans.DECODE_LAUNCHES,
    "bitunpack12": hopper_bitpack.UNPACK_LAUNCHES,
    "decode_l1": hopper_decode.LAUNCHES,
    "posdecode": hopper_decode.POSDECODE_LAUNCHES,
    "encode_l1_pairs": hopper_encode.PAIRS_LAUNCHES,
    "tokens_from_pairs": hopper_tokens.LAUNCHES,
    "assemble_split": hopper_deflate.ASSEMBLE_SPLIT_LAUNCHES,
    "bitpack12_words": hopper_bitpack.WORDS_LAUNCHES,
    "encode_l1_phases": hopper_encode.PHASES_LAUNCHES,
    "decode_l1_phases": hopper_decode.PHASES_LAUNCHES,
    "probe_mosaic": hopper_probes.MOSAIC_LAUNCHES,
    "probe_f32dot": hopper_probes.F32DOT_LAUNCHES,
    "probe_butterfly": hopper_probes.BUTTERFLY_LAUNCHES,
}


def kernel_launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset
    (``encode_l1_positions`` and ``encode_l1_pairs``: those of the encode
    that stored positions or bitmap-byte pairs)."""
    return {name: counter.value for name, counter in _COUNTERS.items()}


def reset_kernel_launch_counts() -> None:
    for counter in _COUNTERS.values():
        counter.reset()
