# Entry points: ``python -m repro_torch.launch.serve`` serves an LM and
# retains its most interesting requests top-K across tiers;
# ``python -m repro_torch.launch.train`` trains one with top-K curation;
# ``python -m repro_torch.launch.dryrun`` prices every (arch × shape ×
# mesh) cell per chip on the meta device, and
# ``python -m repro_torch.launch.inspect_cell`` ranks one cell's
# operations (``--device cuda``: runs its per-chip slice on the card).
