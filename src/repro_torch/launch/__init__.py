# Entry points: ``python -m repro_torch.launch.serve`` serves an LM and
# retains its most interesting requests top-K across tiers;
# ``python -m repro_torch.launch.train`` trains one with top-K curation.
