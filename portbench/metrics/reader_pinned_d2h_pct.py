"""Layer: device copies (``reader._to_host``).  The share of the window's
``reader.d2h`` spans, one a call that decoded on the card, that copied into
pinned host memory (the child span ``reader.d2h_pinned``); % of calls.
The program's span table, ``pyrecode_tpu_torch.span_totals()``, fills only
while a profile records, so it holds the traced window alone.  Nothing
(None) where the program has either span missing."""

import pyrecode_tpu_torch as port


def read(run):
    totals = getattr(port, "span_totals", dict)()
    if "reader.d2h" not in totals or "reader.d2h_pinned" not in totals:
        return None
    return 100.0 * totals["reader.d2h_pinned"][0] / totals["reader.d2h"][0]
