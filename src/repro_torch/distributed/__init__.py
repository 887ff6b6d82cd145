"""Distribution and fault tolerance (the port of ``repro/distributed``).

- ``sharding.py``: logical-axis rules, resolved onto a ``DeviceMesh``'s
  DTensor placements (``lshard``), the kernels entered on local shards;
- ``elastic.py``: a logical checkpoint placed onto any mesh (``reshard``);
- ``grad_compression.py``: int8 all-reduce with error feedback over
  ``pod``;
- ``pipeline_parallel.py``: GPipe stages over a ``pipe`` mesh dim;
- ``fault_tolerance.py``: crash-consistent restart from the branch head.
"""
