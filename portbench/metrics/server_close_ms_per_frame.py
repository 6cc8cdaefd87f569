"""Layer: server (``server.py``).  The host seconds of the head's span
``server.close``, over the frames written; ms a frame.  It runs from the
close broadcast (each node's last flush, ``nz`` patch and pool shutdown)
through the joins and the log's close to the end of ``ReCoDeServer.run``.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has no such span."""

import pyrecode_tpu_torch as port

SPANS = ("server.close",)


def read(run):
    totals = getattr(port, "span_totals", dict)()
    frames = run.frames_done()
    if not frames or any(name not in totals for name in SPANS):
        return None
    return sum(totals[name][1] for name in SPANS) / frames * 1e3
