"""Peak device memory allocated during the training window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its open)."""


def read(r):
    peak = r.get("device.peak_bytes")
    return peak / 2 ** 30 if peak and r.get("trace") is not None else None
