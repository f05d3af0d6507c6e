"""What the readers of the program's own spans share: the port's span
aggregates (`coskad_tpu_torch.utils.profiling.span_stats`) in this
process. They hold set-up, warm-up and the untraced window; the port
leaves out every span a profiler recorded, so never a traced capture."""

from __future__ import annotations


def stats(name: str):
    """The aggregates of the port's span `name`, or None where the port
    records none: a program without spans, or a path that opened none."""
    from coskad_tpu_torch.utils import profiling

    span_stats = getattr(profiling, "span_stats", None)
    return None if span_stats is None else span_stats().get(name)
