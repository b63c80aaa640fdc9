"""sw_traceback_roofline_pe250 (%, device trace): `sw_traceback_roofline`'s
reading, by its own reader, in the cells of 250-base reads, whose walks
are 250 rows or more (the accepted entry lists the 150-base cells)."""

from benchmark.metrics.sw_traceback_roofline import read  # noqa: F401
