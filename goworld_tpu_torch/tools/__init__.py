"""The ops CLI's cluster tools: the ``/metrics`` scraper
(:mod:`.scrape_metrics`), the deployment observability aggregator
(:mod:`.obs_aggregate`) and the trace merger (:mod:`.merge_traces`).

They are the port's own copies of the JAX package's repo tools, on the
port's ``config`` and ``utils``; ``python -m goworld_tpu_torch
status|watch|trace|incidents`` calls them, and each also runs alone
(``python -m goworld_tpu_torch.tools.scrape_metrics <server_dir>``).
"""
