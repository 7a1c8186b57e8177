"""pdecontrol_tpu — model-based PDE control in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``stwerner97/model-based-pde-control`` (ECC'24): batched PDE control
environments (Kuramoto–Sivashinsky, Burgers), learned neural PDE surrogate
ensembles, Soft Actor-Critic, and an MBPO-style model-based RL loop — all as
jitted programs over a device mesh instead of process pools.
"""

__version__ = "0.1.0"
