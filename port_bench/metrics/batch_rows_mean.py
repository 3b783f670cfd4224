"""Rows per device batch the server's batcher formed across the window:
the change of its ``batched_requests_total`` over that of its
``batches_total`` (``ServerStats``)."""


def read(run):
    return getattr(run.gen, "batch_rows", None)
