"""Kernels layer: the device time of a multiply's bin launches (each
bin's gather, kernel and epilogue, between a CUDA event pair; no copies),
every kind summed, mean over the window's multiplies, from the port's
``OceanReport.device_seconds`` (device spans ``device.bin``). The port
measures it only while tracing, and only on a card."""
from ..spans import device_ms


def read(ctx):
    return device_ms(ctx)
