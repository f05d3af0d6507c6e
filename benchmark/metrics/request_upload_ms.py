"""A request's upload: the median of the program's `request.upload` span,
the pageable copy of the request's windows to the device."""

from benchmark.metrics import program_spans

LAYER = "request upload"
UNIT = "ms"
MOVES = "request_ms_p95"


def read(ctx):
    upload = program_spans.stats("request.upload")
    return None if upload is None else upload["median_s"] * 1e3
