# Host-side data: the synthetic token stream and the elastic StreamLoader
# (NumPy copies of the reference's data.synthetic and data.pipeline), and
# TopKCurator, which mirrors a top-K reservoir and places the retained
# payloads through a TieredStore.
from . import curation, pipeline, synthetic  # noqa: F401
