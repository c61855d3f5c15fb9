"""A training step's model operations a second over the chip's peak, %."""
from benchmark import readings


def read(r):
    return readings.mfu(r)
