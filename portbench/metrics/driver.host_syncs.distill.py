"""The program's host syncs a traced outer step: blocking copies to the card
and reads of a tensor's values (``utils/profiling.COUNTS['host_syncs']``)."""

from portbench.harness.readers import count


def read(run):
    return count(run, "host_syncs")
