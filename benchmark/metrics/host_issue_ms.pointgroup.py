"""Host ms a PointGroup train step on the program's host step path in the
traced window: the program's spans ``ir.load``, ``ir.step`` and
``ir.to_host``, less ``ir.to_host.wait``, where the host waits for the
device (``_program_spans``).  Left out where the program keeps no spans."""

from benchmark.metrics._program_spans import host_issue_ms


def read(record):
    if record.get("model") != "pointgroup":
        return None
    return host_issue_ms(record, "train")
