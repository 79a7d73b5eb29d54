"""The benchmark harness of the PyTorch / CUDA port.

Everything here is the yardstick: traffic generation, weights made from
the seed, the plain reference, the comparison that decides ``correct``,
the card's peaks and the reduction from spans, counters and the
profiler's trace to metrics. What one architecture is (its weight tree,
its reference layers, its FLOP and byte counts) is its block's, in
``blocks/<block>.py``. From the program (``dpu_operator_tpu_torch``) the
harness takes only the system under test.
"""
