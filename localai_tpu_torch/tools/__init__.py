"""Command-line tools of the port: ``tools.autotune`` sweeps the paged
decode kernel (K1) and writes the tuning table (``ops.tuning``)."""
