"""The port's copy of the host codecs (``codecs/backends.py`` and the
pure-Python fallbacks in ``codecs/purepy.py``) against the JAX package's,
scheme by scheme: the same compressed bytes, and each package decodes the
other's.  This keeps the two copies in step.  Exact bytes.
"""

import warnings

import numpy as np
import pytest

from pyrecode_tpu import codecs as jax_codecs
from pyrecode_tpu_torch import codecs as port_codecs


def _sparse_bitmap(seed=5, n=12288):
    """An LSB-first bitmap of a ~4% foreground frame, the codecs' usual input."""
    rng = np.random.default_rng(seed)
    return np.packbits(rng.random(n * 8) < 0.04, bitorder="little").tobytes()


@pytest.mark.parametrize("scheme", range(13))
def test_port_codec_matches_the_jax_package(scheme):
    data = _sparse_bitmap()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        try:
            want = jax_codecs.get_codec(scheme, 1)
        except ImportError:
            with pytest.raises(ImportError):
                port_codecs.get_codec(scheme, 1)
            return
        got = port_codecs.get_codec(scheme, 1)
    coded = got.compress(data)
    assert coded == want.compress(data)
    assert got.decompress(coded) == data
    assert want.decompress(coded) == data
    assert got.decompress(want.compress(data[:777])) == data[:777]
