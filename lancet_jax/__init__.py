"""lancet_jax — JAX somatic micro-assembly variant caller.

A brand-new implementation with the capabilities of nygenome/lancet
(C++ reference studied for behavior; no code copied). The compute path
is JAX/XLA, run on NVIDIA GPUs; the host oracle engine in
`lancet_jax.engine` defines exact reference semantics.
"""

__version__ = "0.1.0"
