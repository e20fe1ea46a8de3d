"""Host ms an eval step on the program's host step path in the traced
window: the program's spans ``ir.load`` (``finish`` into the graph's
inputs), ``ir.step`` (mode, replay, clones) and ``ir.to_host`` (the stack
and its read-back), less ``ir.to_host.wait``, where the host waits for the
device (``_program_spans``).  Left out where the program keeps no spans."""

from benchmark.metrics._program_spans import host_issue_ms


def read(record):
    return host_issue_ms(record, "eval")
