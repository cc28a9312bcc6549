"""Device probes of the port (python -m adhoc_queries_pointclouds_torch.tools.<name>)."""
