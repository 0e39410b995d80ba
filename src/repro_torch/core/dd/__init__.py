"""Decision-diagram branch-and-bound on the bulk queues (port of ``repro.core.dd``)."""
