from . import banded, kkt, prox                               # noqa: F401
