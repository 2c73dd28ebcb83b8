"""The program's own record of a traced stretch, for the per-layer metrics
that read the program's spans and counters.

``pbrpathtracer_tpu_torch.utils.observability.last_record()`` holds what
the program traced while the profiler was on: in a ``--trace 1`` run the
traced stretch's calls and the one call before it, all whole calls. Its
``calls`` are the session passes and fit steps that finished in it,
``device_ms`` the exclusive device milliseconds of each ``pbr.*`` span and
``counts`` its counters. A program that keeps no such record (one older
than its tracing) gives nothing, and a metric that reads it is left out of
the result line.
"""

from __future__ import annotations


def last_record():
    """The program's newest record, or None."""
    try:
        from pbrpathtracer_tpu_torch.utils import observability
    except ImportError:
        return None
    read = getattr(observability, "last_record", None)
    return None if read is None else read()


def per_call(field: str, name: str):
    """``record[field][name]`` over the record's calls: a device span's
    milliseconds (``field`` "device_ms"; None where the span has none) or a
    counter (``field`` "counts"); None without a record or a call."""
    rec = last_record()
    if not rec or not rec.get("calls"):
        return None
    value = rec.get(field, {}).get(name)
    if value is None:
        return None
    return value / rec["calls"]
