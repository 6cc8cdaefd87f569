"""Layer: writer (``writer.py``).  The host seconds of the span
``writer.h2d``, the wait in ``_to_device`` for each batch's pageable copy to
the card (behind whatever the card has queued), summed over the nodes and
acquisitions of the window, over the frames written; ms a frame.  Nodes
overlap, so this is not wall time.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has no such span."""

import pyrecode_tpu_torch as port

SPANS = ("writer.h2d",)


def read(run):
    totals = getattr(port, "span_totals", dict)()
    frames = run.frames_done()
    if not frames or any(name not in totals for name in SPANS):
        return None
    return sum(totals[name][1] for name in SPANS) / frames * 1e3
