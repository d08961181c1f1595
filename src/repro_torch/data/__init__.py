# Host-side consumers of scored examples: TopKCurator mirrors a top-K
# reservoir and places the retained payloads through a TieredStore.
from . import curation  # noqa: F401
