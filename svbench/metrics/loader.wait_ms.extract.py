"""Mean host time ``extract_embeddings`` waits for the eval loader's next
batch within a pass (each pass's first wait, the loader's start, left
out, as ``loader.gap_ms.extract`` leaves it out): the program's
``loader.wait`` spans of the traced window."""

from svbench.harness.spans import host_ms, window_spans


def read(r):
    return host_ms(window_spans(r), "loader.wait",
                   keep=lambda s: s.attrs.get("batch", 0) > 0)
