"""Layer: device entropy (``codecs.rans``, the scheme-12 batch encoders).
The host seconds of the span ``rans.host_stage``: each batch's frequency
quantisation and its per-stream loop (headers, stored blocks, streams the
host coder takes), summed over the nodes and acquisitions of the window,
over the frames written; ms a frame.  Nodes overlap, so this is not wall
time.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has no such span."""

import pyrecode_tpu_torch as port

SPAN = "rans.host_stage"


def read(run):
    totals = getattr(port, "span_totals", dict)()
    frames = run.frames_done()
    if not frames or SPAN not in totals:
        return None
    return totals[SPAN][1] / frames * 1e3
