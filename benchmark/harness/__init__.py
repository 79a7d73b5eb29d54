"""The benchmark harness of the PyTorch / CUDA port.

Everything here is the yardstick: traffic generation, weights made from
the seed, the plain reference, the comparison that decides ``correct``,
the frozen FLOP and byte counts, the card's peaks and the reduction from
spans, counters and the profiler's trace to metrics. From the program
(``dpu_operator_tpu_torch``) the harness takes only the system under test.
"""
