"""Scoped tier-outage helper — a copy of the reference's
``resilience.outage``.

The mechanics live on the engine (``StreamEngine.tier_outage`` /
``tier_recover`` — the outage must consult the replanner, meter, and
cost monitor that the engine owns); this module adds the operator-facing
context manager so a drill or a test reads as one block::

    with TierOutage(engine, tier=1, burn_grace=8) as out:
        ...   # ingest through the outage; tier 1 is masked + evacuated
    # on exit the tier recovers, with hysteresis chunks of flap damping
"""
from __future__ import annotations

from typing import Dict, Optional


class TierOutage:
    """Declare a tier failed on enter, recover it on exit.

    ``summary`` holds the evacuation report (rows evacuated, residents
    moved, the priced relocation bill, and any skipped/infeasible
    rows). Exiting never swallows exceptions, and recovery is applied
    even when the body raises — a crashed drill must not leave the tier
    masked forever."""

    def __init__(self, engine, tier: int, *, burn_grace: int = 8,
                 hysteresis: int = 2):
        self.engine = engine
        self.tier = int(tier)
        self.burn_grace = int(burn_grace)
        self.hysteresis = int(hysteresis)
        self.summary: Optional[Dict] = None

    def __enter__(self) -> "TierOutage":
        self.summary = self.engine.tier_outage(self.tier,
                                               burn_grace=self.burn_grace)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.tier in self.engine._failed_tiers:
            self.engine.tier_recover(self.tier,
                                     hysteresis=self.hysteresis)
        return False
