"""adhoc_queries_pointclouds_torch — the PyTorch/CUDA port of the query engine.

The port runs beside adhoc_queries_pointclouds_tpu, which stays the
reference it is tested against. It imports torch, never jax and nothing
of that package: the numpy-only host modules (formats/, native/, index.py,
sinks.py, models/, utils/, parallel/pipeline.py) are its own copies under
the same names, byte for byte but for the build step of native/__init__.py.
It runs bbox, class and GPS-time counts and collects over a set of
LAS/LAZ/LAST/LAZER files (engine.run_query, cli), on one CUDA device
through the hand-written kernels in csrc/, or on the CPU through their
plain PyTorch versions:

    formats/, native/    host decode -> int32 SoA point blocks
    index.py             block min/max sidecar index
    parallel/pipeline.py decode-ahead block feeder
    host.py              step assembly and bit-planar packing
    parallel/comm.py     the device, H2D copies
    parallel/step.py     one step: K blocks -> int32 total, or a bit mask
    sinks.py             hit emission: LAS write-back, printing
    ops/predicate.py     kernel wrappers and plain versions
    csrc/*.cu            the CUDA kernels, built by _build.py at first use
"""

__version__ = "0.1.0"
