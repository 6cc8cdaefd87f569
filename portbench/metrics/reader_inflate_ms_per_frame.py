"""Layer: host inflate (``reader._inflate``).  The host seconds of the span
``reader.inflate``, each call's coded streams inflated on the host's thread
pool, summed over the window's calls, over the frames returned; ms a
frame.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has no such span."""

import pyrecode_tpu_torch as port

SPANS = ("reader.inflate",)


def read(run):
    totals = getattr(port, "span_totals", dict)()
    frames = run.frames_done()
    if not frames or any(name not in totals for name in SPANS):
        return None
    return sum(totals[name][1] for name in SPANS) / frames * 1e3
