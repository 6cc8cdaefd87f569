"""Entropy coding of the port: the backend registry (scheme codes 0-12) and
the scheme-0 (:mod:`.dyndeflate`) and scheme-12 (:mod:`.rans`) coders.

The registry is the port's own copy of pyrecode_tpu/codecs/backends.py
(reference ``recode_compressors.py``); ``dyndeflate`` and ``rans`` hold the
numpy host halves of their JAX counterparts and the device halves on torch
tensors, through the port's kernels.  ``compress`` and ``de_compress`` keep
the reference call signatures; ``get_codec`` is the class-based entry point.
"""

from .backends import (
    Codec,
    available_schemes,
    compress,
    de_compress,
    get_codec,
    import_checks,
    scheme_name,
)

__all__ = [
    "Codec",
    "available_schemes",
    "compress",
    "de_compress",
    "get_codec",
    "import_checks",
    "scheme_name",
]
