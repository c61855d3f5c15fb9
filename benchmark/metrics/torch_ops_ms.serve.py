"""Device ms a request of every operation that is not a hand kernel."""
from benchmark import readings


def read(r):
    return readings.other_ms(r)
