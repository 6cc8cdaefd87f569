"""Layer: server (``server.start``: each node's ``node.open`` builds its
writer).  The share of the window's ``writer.threshold`` spans, one a
writer constructed, in which the threshold was built on the writer's device
from one copy of the calibration (the child span
``writer.threshold_device``); % of writers.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has either span missing."""

import pyrecode_tpu_torch as port


def read(run):
    totals = getattr(port, "span_totals", dict)()
    if "writer.threshold" not in totals or "writer.threshold_device" not in totals:
        return None
    return 100.0 * totals["writer.threshold_device"][0] / totals["writer.threshold"][0]
