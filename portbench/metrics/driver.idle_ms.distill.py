"""Device idle ms a traced outer step in gaps that began inside one of the
program's ``driver.*`` spans (the expert segment, the batch plan, the
log), from ``spans.attribute``."""

from portbench.harness.readers import idle_ms


def read(run):
    return idle_ms(run, "driver.")
