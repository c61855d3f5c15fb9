"""The share of the traced serving segment with the device idle, %."""
from benchmark import readings


def read(r):
    return readings.idle_share(r)
