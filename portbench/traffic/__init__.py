"""Traffic: the frozen column generator, the wire protocol, the load
generator process and the traffic mixes (``mixes/<traffic>.json``)."""
