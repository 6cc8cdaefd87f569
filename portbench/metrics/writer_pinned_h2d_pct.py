"""Layer: device copies (``writer._batch_to_device``).  The share of the
window's ``writer.h2d`` spans, one a batch a node dispatched to the card,
that went through the writer's pinned staging buffer (the child span
``writer.h2d_pinned``); % of batches.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has either span missing."""

import pyrecode_tpu_torch as port


def read(run):
    totals = getattr(port, "span_totals", dict)()
    if "writer.h2d" not in totals or "writer.h2d_pinned" not in totals:
        return None
    return 100.0 * totals["writer.h2d_pinned"][0] / totals["writer.h2d"][0]
