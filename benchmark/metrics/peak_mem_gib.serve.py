"""The allocator's peak over a serving run, GiB."""
from benchmark import readings


def read(r):
    return readings.peak_gib(r)
