"""Distribution and fault tolerance (the port of ``repro/distributed``).

Only ``fault_tolerance.py`` is ported so far: crash-consistent restart of
the training loop from the branch head. Sharding, pipeline parallelism,
gradient compression and elastic restore are ROADMAP Queue 1 item 6.
"""
