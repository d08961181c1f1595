"""Fleet-axis sharding — the port of the reference's ``repro.parallel``
(its fleet side, ``parallel.fleet``).

The model side of the reference's package (``ctx``, ``sharding``,
``collectives``: parameters, optimizer moments and gradients across a
pod) belongs with training and is not ported here.
"""
from . import fleet  # noqa: F401
