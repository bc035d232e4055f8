"""Host seconds of the program's copies to the card at set-up: its spans
``upload``, the feature tables in ``pipeline.prepare``
(``GraphBatch.from_graph``) and the first fill of NA's device tables in
the session's warm-up (``ops._layout_device``, ``flows._device_tables``)."""
from portbench.program_trace import span_seconds

UNIT = "s"


def read(ctx):
    return span_seconds("upload") if ctx.cuda else None
