"""Layer: reader (``reader.read_frames_dense``, ``codecs.rans``'s read
chains).  The share of the window's ``reader.read_frames_dense`` calls that
decoded through a scheme-12 device chain (gaps or symbols -> dense frames,
span ``reader.rans_chain``) and not the byte path (span
``reader.rans_bytes``: the streams decoded to bytes, then the decode
kernel); 100 x count of ``reader.rans_chain`` / count of
``reader.read_frames_dense``; % of calls.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has neither scheme-12 span (the window read no
scheme-12 frame, or the program lacks the spans)."""

import pyrecode_tpu_torch as port


def read(run):
    totals = getattr(port, "span_totals", dict)()
    calls = totals.get("reader.read_frames_dense", (0, 0.0))[0]
    if not calls or ("reader.rans_chain" not in totals and "reader.rans_bytes" not in totals):
        return None
    return 100.0 * totals.get("reader.rans_chain", (0, 0.0))[0] / calls
