"""Traffic drivers: ``run(ctx) -> record``, found by the name a traffic file gives."""
