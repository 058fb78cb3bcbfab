"""PMR446 SDR framework in JAX (XLA on GPU; CPU for tests).

A from-scratch re-design of the capabilities of the sdr_pmr446 C reference
as pure block-functions over static shapes with an explicit carried-state
pytree, built for batch throughput on an accelerator.
"""

__version__ = "0.1.0"
