"""The internal-coordinate layer of the port: differentiable primitives,
constraints, host topology discovery and the :class:`Internals`
container with its torch evaluation engine."""
from .constraints import Constraints, DummyStore, DuplicateInternalError
from .internals import Internals

__all__ = ["Constraints", "DummyStore", "DuplicateInternalError",
           "Internals"]
