"""Device ms a training step of every operation that is not a hand kernel:
the model glue, cuFFT, copies, the weight gradients' products, AdamW."""
from benchmark import readings


def read(r):
    return readings.other_ms(r)
