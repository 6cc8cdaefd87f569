"""Layer: device entropy (``codecs.rans``, the scheme-12 batch encoders).
The share of the window's scheme-12 streams whose coding on the card was
kept: one span a stream, ``rans.assemble`` for a stream coded on the card
(with the child ``rans.stored`` where the stored block replaced it) or
``rans.host_coder`` for one the host coder took; 100 x (assemble - stored)
/ (assemble + host_coder); % of streams.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has neither per-stream span."""

import pyrecode_tpu_torch as port


def read(run):
    totals = getattr(port, "span_totals", dict)()
    count = {name: totals.get(f"rans.{name}", (0, 0.0))[0]
             for name in ("assemble", "stored", "host_coder")}
    if count["assemble"] + count["host_coder"] == 0:
        return None
    return 100.0 * (count["assemble"] - count["stored"]) / (count["assemble"]
                                                           + count["host_coder"])
