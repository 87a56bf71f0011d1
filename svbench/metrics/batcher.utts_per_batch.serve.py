"""Utterances per batch the batcher ran in the window (its counters
``utts_served / batches_run``, read before and after)."""


def read(r):
    return r["batcher.utts"] / r["batcher.batches"] if r.get(
        "batcher.batches") else None
