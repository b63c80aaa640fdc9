"""sw_forward_roofline_pe250 (%, device trace): `sw_forward_roofline`'s
reading, by its own reader, in the cells of 250-base reads, whose extend
runs the (256, 360) bucket at R = 8 (the accepted entry lists the
150-base cells)."""

from benchmark.metrics.sw_forward_roofline import read  # noqa: F401
