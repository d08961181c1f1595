"""Sharding — the port of the reference's ``repro.parallel``: the fleet
axis (``fleet``: the stream dimension split across shards of one
process), and the model side (``ctx``: the logical mesh and its marker
rules; ``sharding``: the parameter, optimizer, batch and cache specs;
``collectives``: the int8 error-feedback mean over shards), which the
dry run (``repro_torch.launch.dryrun``) prices per chip.
"""
from . import fleet  # noqa: F401
