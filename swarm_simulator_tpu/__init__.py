"""swarm_simulator_tpu — accelerator-native multi-agent trajectory planning.

A from-scratch JAX/XLA re-design of the RBP swarm trajectory
planning pipeline (reference: qwerty35/swarm_simulator): ECBS initial path
search, safe-flight-corridor construction over a precomputed ESDF tensor,
and a batched Bernstein-polynomial QP solved with an OSQP-style ADMM method
instead of CPLEX.
"""
__version__ = "0.1.0"

from .core.types import GridSpec, Mission, Param, PlanResult  # noqa: F401
from .pipeline import evaluate, plan  # noqa: F401
