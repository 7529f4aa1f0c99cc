"""The port's benchmark harness: finds a cell's configuration, traffic mix,
checks and per-layer metric readers by the names in ``BENCHMARK.json``,
drives the program (``ultrasound_modeling_tpu_torch``) through the cell's
traffic, reads the trace and compares what the timed path produced with
the plain reference (``bench_torch/reference``)."""
