"""The one piece of the JAX package's ``resilience/`` that serving needs:
which life of a supervised worker is running. The supervisor, chaos,
guards and resharding are not ported yet (ROADMAP.md §A item 8)."""

from .supervisor import ENV_INCARNATION, incarnation_from_env  # noqa: F401
